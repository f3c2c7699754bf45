// Decode attention over a paged KV cache, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (body `_paged_attn_kernel`): one
// query token per sequence attends over K/V pages reached through a block
// table, with an online softmax, an optional sliding window (valid key
// positions satisfy pos > ctx - 1 - window) and optional (m, l) partials for
// a DistAttention merge. Rows with ctx_len == 0 return zeros, m = -1e30 and
// l = 0, as the Pallas kernel does. The math is float32 on bf16 or float32
// pools.
//
// What bounds it on this card: bytes. Each query token's G = H / Hkv heads
// share one KV head, so the kernel does about 4 * G flops per K/V element it
// reads: far below the ~295 flops/byte an H100 needs before its compute is
// the limit. The least time is the K/V bytes of the valid positions (plus q
// and the output) over the 3.35 TB/s of device memory. At a serve batch's
// size the time goes to latency: a few dependent trips to memory per block
// and the chains of dependent instructions in each warp.
//
// What the design does about it (split-context decode, "flash-decoding"):
//  * Grid (B, Hkv, splits). A block takes one run of `split` tokens (whole
//    pages) of one sequence's context, from the window's first page to ctx,
//    for the G query heads of one KV head, so each K/V byte is read once
//    for all G heads. A short serve batch of 8 sequences then fills the
//    card's 132 SMs with a few hundred blocks instead of B * Hkv.
//  * The block reads its run's page ids into shared memory once, beside q.
//    Each warp owns 32-token tiles of the run (one token per lane), double-
//    buffered in its own shared memory: once a tile is in, the warp asks for
//    its next tile before it scores this one. A tile arrives as one TMA box
//    per page (16 token rows of one head, rows padded to an odd count of 16
//    bytes so that lanes reading their own rows hit distinct banks), K and V
//    counted on the buffer's mbarrier: 4 copies per 32-token tile where
//    16-byte copies took 640. Layouts TMA does not take (heads not
//    contiguous, unaligned, pages not a multiple of 8 tokens, rows wider
//    than a box) are staged element by element.
//  * A lane scores its token against all G heads; the warp takes the heads'
//    tile max and sum by shuffles, all heads in each round. The
//    probabilities go to shared memory, and p v reads them back as one
//    broadcast vector per token (a lane owns four head dims), so no
//    shuffle sits in the inner loop. G is a template constant (1, 2, 4 or
//    8; other group sizes take 8 heads at a time with guards), so the head
//    loops unroll without branches. No step waits on a few threads, and the
//    tile loop has no block barrier.
//  * The warps of a block merge their (m, l, o) through shared memory. A
//    sequence whose context fits in one split writes its result directly;
//    otherwise each split writes float32 partials (unnormalised o, m, l)
//    and a second small kernel merges them by the log-sum-exp rule of
//    `merge_partials_tree` (src/repro/core/distkv/dist_attention.py). It is
//    a programmatic dependent launch: it starts while the split kernel
//    drains and waits for its writes.
//  * The host's part is small, since a decode step makes one call per
//    layer: the pools' tensor maps and the shared-memory attribute are
//    cached (tma.cuh), so a call with a known pool encodes nothing and
//    makes two launches.
// Pools are read through their page / token / head strides, so a per-layer
// slice of a (L, P+1, ps, Hkv, Dh) pool is read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kMaxWarps = 4;
constexpr int kTile = 32;    // tokens per warp tile: one per lane
constexpr int kDQuads = 2;   // head-dim quads per lane: Dh <= 4 * 32 * 2
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr size_t kSmemBudget = 227 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// one 16-byte piece of a staged row as floats
__device__ __forceinline__ void piece(const unsigned char* p, float (&x)[4],
                                      float) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void piece(const unsigned char* p, float (&x)[8],
                                      __nv_bfloat16) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
// head dims d..d+3 of a staged row (d a multiple of 4)
__device__ __forceinline__ float4 quad(const unsigned char* row, int d,
                                       float) {
  return *reinterpret_cast<const float4*>(row + 4 * d);
}
__device__ __forceinline__ float4 quad(const unsigned char* row, int d,
                                       __nv_bfloat16) {
  const uint2 v = *reinterpret_cast<const uint2*>(row + 2 * d);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
// kG consecutive floats of shared memory, 16-byte aligned when kG >= 4
template <int kG>
__device__ __forceinline__ void load_heads(const float* p, float (&x)[kG]) {
  if constexpr (kG % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kG / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z;
      x[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kG; ++i) x[i] = p[i];
  }
}

struct Args {
  CUtensorMap kmap, vmap;      // with `tma`: the pools' tensor maps
  const void* q;               // (B, H, Dh), contiguous
  const void* k;               // page p, token t, head h, dim d at
  const void* v;               //   p*sp + t*st + h*sh + d
  const int32_t* block_tables; // (B, n) with row stride bt_sb
  const int32_t* context_lens; // (B,)
  void* out;                   // (B, H, Dh), contiguous
  float* m_out;                // (B, H) or null
  float* l_out;                // (B, H) or null
  float* o_part;               // (B, H, splits, Dh) or null (one split)
  float* m_part;               // (B, H, splits)
  float* l_part;               // (B, H, splits)
  int H, Hkv, Dh, page_size, num_pages, window, split, splits;
  int pieces;     // 16-byte pieces of one token's head slice
  int row_bytes;  // bytes of a staged row: pieces (+ 1 to stay odd) * 16
  bool tma;       // stage tiles by TMA boxes of box_t tokens
  int box_t;
  int64_t k_sp, k_st, k_sh, v_sp, v_st, v_sh, bt_sb;
  float scale;
};

// the first page-aligned position a row reads, and its number of splits
// (at most `splits`: the partials hold no more, and a context longer than
// its block table is outside the kernel's contract)
__device__ __forceinline__ int first_pos(const Args& a, int ctx) {
  const int lo = a.window > 0 ? max(0, ctx - a.window) : 0;
  return (lo / a.page_size) * a.page_size;
}
__device__ __forceinline__ int num_splits(const Args& a, int ctx) {
  return ctx > 0 ? min(a.splits,
                       (ctx - first_pos(a, ctx) + a.split - 1) / a.split)
                 : 0;
}

// shared memory of split_kernel: 2 mbarriers per warp, the warps'
// probabilities (kTile x kG floats each), q (G x QLD floats), the run's page
// ids, then (128-byte aligned, as TMA boxes need) the warps' K/V buffers
__host__ __device__ inline size_t kv_offset(const Args& a, int G, int QLD,
                                            int kG) {
  return (2 * kMaxWarps * 8 + (size_t)kMaxWarps * kTile * kG * 4 +
          (size_t)G * QLD * 4 + (size_t)a.split / a.page_size * 4 + 127) &
         ~(size_t)127;
}

// kG: query heads held in registers at a time; kExact: G == kG
template <typename T, int kG, bool kExact>
__global__ void __launch_bounds__(kMaxWarps * 32)
split_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int EPP = 16 / sizeof(T);  // elements per 16-byte piece
  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = blockDim.x >> 5, nthreads = blockDim.x;
  const int G = a.H / a.Hkv, Dh = a.Dh, ps = a.page_size;
  const int64_t row0 = (int64_t)b * a.H + (int64_t)kvh * G;
  const int ctx = a.context_lens[b];
  const int nsplit = num_splits(a, ctx);
  // the merge kernel may start now: it waits for this grid's writes
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (nsplit == 0) {  // ctx == 0: zeros, m = -1e30, l = 0
    if (split == 0) {
      T* out = static_cast<T*>(a.out) + row0 * Dh;
      for (int i = threadIdx.x; i < G * Dh; i += nthreads)
        store_f32(out + i, 0.f);
      if (a.m_out != nullptr)
        for (int g = threadIdx.x; g < G; g += nthreads) {
          a.m_out[row0 + g] = kNegInf;
          a.l_out[row0 + g] = 0.f;
        }
    }
    return;
  }
  if (split >= nsplit) return;

  const int lo = a.window > 0 ? max(0, ctx - a.window) : 0;
  const int s0 = first_pos(a, ctx) + split * a.split;
  const int s1 = min(s0 + a.split, ctx);
  const int QLD = a.pieces * EPP;  // floats per staged q row
  const int nq = (Dh + 127) / 128;  // head-dim quads a lane owns
  uint64_t* bar_s = reinterpret_cast<uint64_t*>(smem);  // 2 per warp
  float* p_s = reinterpret_cast<float*>(bar_s + 2 * kMaxWarps);
  float* q_s = p_s + kMaxWarps * kTile * kG;          // G x QLD
  int* pg_s = reinterpret_cast<int*>(q_s + G * QLD);  // the run's page ids
  unsigned char* kv_s = smem + kv_offset(a, G, QLD, kG);
  // each warp: [2 buffers][K, V][kTile tokens][row_bytes]
  const size_t tile_bytes = (size_t)kTile * a.row_bytes;
  unsigned char* mine = kv_s + (size_t)warp * 4 * tile_bytes;
  float* pw = p_s + warp * kTile * kG;  // this warp's p, [token][head]

  const T* kb = static_cast<const T*>(a.k) + (int64_t)kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)kvh * a.v_sh;

  // Stage the tile at `base` into buffer `buf`. TMA: lane 0 announces the
  // bytes on the buffer's mbarrier and lane j asks for box j, one per page
  // that holds positions below s1 (rows outside [lo, s1) are masked in the
  // scores and skipped by p v). Otherwise element by element, zeros outside
  // [lo, s1).
  const int pg0 = s0 / ps;
  const bool ps_pow2 = (ps & (ps - 1)) == 0;
  const int ps_log = __ffs(ps) - 1;
  auto stage = [&](int base, int buf) {
    unsigned char* kd = mine + (size_t)buf * 2 * tile_bytes;
    unsigned char* vd = kd + tile_bytes;
    if (a.tma) {  // (the warp is done reading the buffer: __syncwarp)
      const int bt = a.box_t;
      const int n_box = min(kTile / bt, (s1 - base + bt - 1) / bt);
      if (lane == 0)
        tma::mbar_arrive_expect(&bar_s[2 * warp + buf],
                           2 * n_box * bt * a.row_bytes);
      if (lane < n_box) {  // lane j asks for box j
        const int j = lane;
        const int pos = base + j * bt;
        const int pi = ps_pow2 ? pos >> ps_log : pos / ps;
        const int page = pg_s[pi - pg0], tok = pos - pi * ps;
        const size_t o = (size_t)j * bt * a.row_bytes;
        tma::load_3d(kd + o, &a.kmap, kvh * Dh, tok, page,
                 &bar_s[2 * warp + buf]);
        tma::load_3d(vd + o, &a.vmap, kvh * Dh, tok, page,
                 &bar_s[2 * warp + buf]);
      }
    } else {
      for (int e = lane; e < kTile * QLD; e += 32) {
        const int t = e / QLD, d = e - t * QLD, pos = base + t;
        T kx = T(0.f), vx = T(0.f);
        if (pos >= lo && pos < s1 && d < Dh) {
          const int64_t page = pg_s[pos / ps - pg0], off = pos % ps;
          kx = kb[page * a.k_sp + off * a.k_st + d];
          vx = vb[page * a.v_sp + off * a.v_st + d];
        }
        const size_t o = (size_t)t * a.row_bytes + d * sizeof(T);
        *reinterpret_cast<T*>(kd + o) = kx;
        *reinterpret_cast<T*>(vd + o) = vx;
      }
    }
  };

  // q and the run's page ids, read once
  const T* qg = static_cast<const T*>(a.q) + row0 * Dh;
  for (int i = threadIdx.x; i < G * QLD; i += nthreads) {
    const int g = i / QLD, d = i - g * QLD;
    q_s[i] = d < Dh ? to_f32(qg[(int64_t)g * Dh + d]) : 0.f;
  }
  const int32_t* bt = a.block_tables + (int64_t)b * a.bt_sb;
  for (int i = threadIdx.x; i <= (s1 - 1) / ps - pg0; i += nthreads)
    pg_s[i] = bt[pg0 + i];
  if (threadIdx.x < 2 * W) tma::mbar_init(&bar_s[threadIdx.x], 1);
  tma::mbar_init_fence();
  __syncthreads();

  int fills = 0;  // this warp's tiles so far: buffer fills & 1, phase >> 1
  for (int g0 = 0; g0 < G; g0 += kG) {
    auto live = [&](int g) { return kExact || g0 + g < G; };
    float m[kG], l[kG];
    float4 acc[kG][kDQuads];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < kDQuads; ++j) acc[g][j] = make_float4(0, 0, 0, 0);
    }

    int base = s0 + warp * kTile;
    if (base < s1) stage(base, fills & 1);
    for (; base < s1; base += W * kTile, ++fills) {
      // this tile is in, and the warp is done reading the other buffer,
      // which the next tile refills
      const int buf = fills & 1;
      if (a.tma) tma::mbar_wait(&bar_s[2 * warp + buf], (fills >> 1) & 1);
      __syncwarp();
      if (base + W * kTile < s1) stage(base + W * kTile, buf ^ 1);
      const unsigned char* kd = mine + (size_t)buf * 2 * tile_bytes;
      const unsigned char* vd = kd + tile_bytes;

      // scores: lane t against the group's heads
      const int pos = base + lane;
      const bool ok = pos >= lo && pos < s1;
      float s[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) s[g] = 0.f;
      const unsigned char* krow = kd + (size_t)lane * a.row_bytes;
#pragma unroll 2
      for (int c = 0; c < a.pieces; ++c) {
        float kx[EPP];
        piece(krow + c * 16, kx, T(0.f));
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          if (live(g)) {  // a 16-byte aligned run of q: float4 reads
            const float4* qr =
                reinterpret_cast<const float4*>(q_s + (g0 + g) * QLD) +
                c * (EPP / 4);
#pragma unroll
            for (int e = 0; e < EPP / 4; ++e) {
              const float4 qv = qr[e];
              s[g] = fmaf(qv.x, kx[4 * e], s[g]);
              s[g] = fmaf(qv.y, kx[4 * e + 1], s[g]);
              s[g] = fmaf(qv.z, kx[4 * e + 2], s[g]);
              s[g] = fmaf(qv.w, kx[4 * e + 3], s[g]);
            }
          }
        }
      }
      // online softmax over the tile: the heads' max and sum by shuffles,
      // all heads in each round
      float red[kG], alpha[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        s[g] = ok ? s[g] * a.scale : kNegInf;
        red[g] = s[g];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < kG; ++g)
          red[g] = fmaxf(red[g], __shfl_xor_sync(kFull, red[g], off));
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float m_new = fmaxf(m[g], red[g]);
        alpha[g] = expf(m[g] - m_new);
        red[g] = ok && live(g) ? expf(s[g] - m_new) : 0.f;
        pw[lane * kG + g] = red[g];
        m[g] = m_new;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < kG; ++g)
          red[g] += __shfl_xor_sync(kFull, red[g], off);
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        l[g] = l[g] * alpha[g] + red[g];
#pragma unroll
        for (int j = 0; j < kDQuads; ++j) {
          acc[g][j].x *= alpha[g];
          acc[g][j].y *= alpha[g];
          acc[g][j].z *= alpha[g];
          acc[g][j].w *= alpha[g];
        }
      }
      __syncwarp();  // p is in shared memory
      // p v over the tile's valid tokens; lane owns dims 4 lane + 128 j
      const int t_lo = max(0, lo - base), t_hi = min(kTile, s1 - base);
#pragma unroll 4
      for (int t = t_lo; t < t_hi; ++t) {
        const unsigned char* vrow = vd + (size_t)t * a.row_bytes;
        float pv[kG];
        load_heads<kG>(pw + t * kG, pv);
        float4 vx[kDQuads];
#pragma unroll
        for (int j = 0; j < kDQuads; ++j) {
          const int d = 4 * lane + 128 * j;
          vx[j] = j < nq && d < Dh ? quad(vrow, d, T(0.f))
                                   : make_float4(0, 0, 0, 0);
        }
#pragma unroll
        for (int g = 0; g < kG; ++g) {
#pragma unroll
          for (int j = 0; j < kDQuads; ++j) {
            acc[g][j].x = fmaf(pv[g], vx[j].x, acc[g][j].x);
            acc[g][j].y = fmaf(pv[g], vx[j].y, acc[g][j].y);
            acc[g][j].z = fmaf(pv[g], vx[j].z, acc[g][j].z);
            acc[g][j].w = fmaf(pv[g], vx[j].w, acc[g][j].w);
          }
        }
      }
    }

    // merge the block's warps: [W][kG][Dh] o, then [W][kG] m and l
    __syncthreads();  // every warp is done with its buffers
    float* red_o = reinterpret_cast<float*>(kv_s);
    float* red_m = red_o + (size_t)W * kG * Dh;
    float* red_l = red_m + W * kG;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (live(g)) {
        if (lane == 0) {
          red_m[warp * kG + g] = m[g];
          red_l[warp * kG + g] = l[g];
        }
#pragma unroll
        for (int j = 0; j < kDQuads; ++j) {
          const int d = 4 * lane + 128 * j;
          float* o = red_o + ((size_t)warp * kG + g) * Dh;
          const float x[4] = {acc[g][j].x, acc[g][j].y, acc[g][j].z,
                              acc[g][j].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (d + e < Dh) o[d + e] = x[e];
        }
      }
    }
    __syncthreads();
    const int ng = min(kG, G - g0);
    for (int i = threadIdx.x; i < ng * Dh; i += nthreads) {
      const int g = i / Dh, d = i - g * Dh;
      float mm = kNegInf;
      for (int w = 0; w < W; ++w) mm = fmaxf(mm, red_m[w * kG + g]);
      float ll = 0.f, oo = 0.f;
      for (int w = 0; w < W; ++w) {
        const float c = expf(red_m[w * kG + g] - mm);
        ll += red_l[w * kG + g] * c;
        oo += red_o[((size_t)w * kG + g) * Dh + d] * c;
      }
      const int64_t row = row0 + g0 + g;
      if (nsplit == 1) {
        store_f32(static_cast<T*>(a.out) + row * Dh + d,
                  oo / fmaxf(ll, 1e-9f));
        if (d == 0 && a.m_out != nullptr) {
          a.m_out[row] = mm;
          a.l_out[row] = ll;
        }
      } else {
        const int64_t part = row * a.splits + split;
        a.o_part[part * Dh + d] = oo;
        if (d == 0) {
          a.m_part[part] = mm;
          a.l_part[part] = ll;
        }
      }
    }
    if (g0 + kG < G) {  // the next head group stages where this reduced
      tma::fence_proxy_async();
      __syncthreads();
    }
  }
}

// Merge the splits of each (sequence, head) with more than one:
// m = max_s m_s, l = sum_s l_s exp(m_s - m), o = sum_s o_s exp(m_s - m) / l
// (merge_partials_tree's rule, with its 1e-9 floor on l).
template <typename T>
__global__ void merge_kernel(const __grid_constant__ Args a) {
  // launched as a programmatic dependent of split_kernel: wait for its
  // partials to be written and visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int G = a.H / a.Hkv, Dh = a.Dh;
  const int nsplit = num_splits(a, a.context_lens[b]);
  if (nsplit < 2) return;
  const int64_t row0 = (int64_t)b * a.H + (int64_t)kvh * G;
  for (int i = threadIdx.x; i < G * Dh; i += blockDim.x) {
    const int g = i / Dh, d = i - g * Dh;
    const int64_t part = (row0 + g) * a.splits;
    float mm = kNegInf;
    for (int s = 0; s < nsplit; ++s) mm = fmaxf(mm, a.m_part[part + s]);
    float ll = 0.f, oo = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float c = expf(a.m_part[part + s] - mm);
      ll += a.l_part[part + s] * c;
      oo += a.o_part[(part + s) * Dh + d] * c;
    }
    store_f32(static_cast<T*>(a.out) + (row0 + g) * Dh + d,
              oo / fmaxf(ll, 1e-9f));
    if (d == 0 && a.m_out != nullptr) {
      a.m_out[row0 + g] = mm;
      a.l_out[row0 + g] = ll;
    }
  }
}

template <typename T, int kG, bool kExact>
int launch_g(const Args& a, int B, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  const size_t q_bytes = kv_offset(a, G, a.pieces * (16 / sizeof(T)), kG);
  const size_t per_warp = (size_t)4 * kTile * a.row_bytes;
  int W = kMaxWarps;
  while (W > 1 && q_bytes + W * per_warp > kSmemBudget) --W;
  const size_t red = (size_t)W * kG * (a.Dh + 2) * 4;
  const size_t smem = q_bytes + (W * per_warp > red ? W * per_warp : red);
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;
  const int e0 = tma::allow_smem((const void*)split_kernel<T, kG, kExact>,
                                 smem);
  if (e0) return e0;
  split_kernel<T, kG, kExact>
      <<<dim3(B, a.Hkv, a.splits), W * 32, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits < 2) return (int)e;
  // the merge starts while the split kernel drains, not after it
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, a.Hkv);
  cfg.blockDim = dim3(128);
  cfg.stream = stream;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, merge_kernel<T>, a);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
int launch(Args a, int B, cudaStream_t stream) {
  const int esz = (int)sizeof(T), epp = 16 / esz;
  a.pieces = (a.Dh + epp - 1) / epp;
  a.row_bytes = (a.pieces | 1) * 16;  // an odd count of 16-byte units
  // TMA for pools whose heads are contiguous (a token's row is one run of
  // Hkv * Dh), 16-byte aligned, whose pages split into boxes of a multiple
  // of 8 tokens that tile the 32-token tiles, with rows no wider than a
  // box takes. Other layouts are staged element by element; a layout that
  // qualifies but does not encode is an error, not a slower path.
  const int bt = a.page_size < kTile ? a.page_size : kTile;
  const int box_w = a.row_bytes / esz;
  a.tma = aligned16(a.k) && aligned16(a.v) && (a.Dh * esz) % 16 == 0 &&
          a.k_sh == a.Dh && a.v_sh == a.Dh && (a.k_sp * esz) % 16 == 0 &&
          (a.k_st * esz) % 16 == 0 && (a.v_sp * esz) % 16 == 0 &&
          (a.v_st * esz) % 16 == 0 && a.page_size % bt == 0 &&
          kTile % bt == 0 && bt % 8 == 0 && box_w <= tma::kMaxBox;
  a.box_t = bt;
  if (a.tma) {
    const CUtensorMapDataType type = sizeof(T) == 2
                                         ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    int e = tma::encode_pool(&a.kmap, a.k, type, esz, a.Hkv * a.Dh,
                             a.page_size, a.num_pages, a.k_st, a.k_sp, box_w,
                             bt);
    if (e == 0)
      e = tma::encode_pool(&a.vmap, a.v, type, esz, a.Hkv * a.Dh,
                           a.page_size, a.num_pages, a.v_st, a.v_sp, box_w,
                           bt);
    if (e) return e;
  }
  switch (a.H / a.Hkv) {
    case 1: return launch_g<T, 1, true>(a, B, stream);
    case 2: return launch_g<T, 2, true>(a, B, stream);
    case 4: return launch_g<T, 4, true>(a, B, stream);
    case 8: return launch_g<T, 8, true>(a, B, stream);
    default: return launch_g<T, 8, false>(a, B, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and the output share it).
// The pools hold num_pages pages. window <= 0 means no window. m_out /
// l_out may both be null. `split` is the tokens of one split (a multiple
// of page_size); `splits` the most any row needs, ceil(n * page_size /
// split) for n block-table columns. With splits > 1, `partials` holds
// B * H * splits * (Dh + 2) floats of scratch. Returns 0 once launched,
// else a cudaError_t or tma::kEncodeError + a CUresult.
int paged_attention_fwd(const void* q, const void* k, const void* v,
                        const int32_t* block_tables,
                        const int32_t* context_lens, void* out, float* m_out,
                        float* l_out, float* partials, int B, int H, int Hkv,
                        int Dh, int page_size, int num_pages, int64_t k_sp,
                        int64_t k_st, int64_t k_sh, int64_t v_sp,
                        int64_t v_st, int64_t v_sh, int64_t bt_sb,
                        int window, int split, int splits, float scale,
                        int dtype, void* stream) {
  if (Hkv < 1 || H % Hkv || Dh < 1 || Dh > 4 * 32 * kDQuads ||
      split < page_size || split % page_size || splits < 1 ||
      (splits > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.q = q; a.k = k; a.v = v;
  a.block_tables = block_tables; a.context_lens = context_lens;
  a.out = out; a.m_out = m_out; a.l_out = l_out;
  const int64_t rows = (int64_t)B * H * splits;
  a.o_part = partials;
  a.m_part = partials != nullptr ? partials + rows * Dh : nullptr;
  a.l_part = partials != nullptr ? a.m_part + rows : nullptr;
  a.H = H; a.Hkv = Hkv; a.Dh = Dh; a.page_size = page_size;
  a.num_pages = num_pages;
  a.window = window; a.split = split; a.splits = splits;
  a.k_sp = k_sp; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sp = v_sp; a.v_st = v_st; a.v_sh = v_sh;
  a.bt_sb = bt_sb;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int err) {
  return tma::error_string(err);
}

}  // extern "C"
