// Prefill attention (flash-attention forward), hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_prefill` in
// src/repro/kernels/flash_prefill.py (body `_flash_kernel`): causal or
// non-causal attention of (B, S, H, Dh) queries over (B, Skv, Hkv, Dh)
// keys and values, GQA (G = H / Hkv query heads share one KV head), with
// an optional sliding window (key k is valid for a query at position q iff
// k <= q when causal, and k > q - window). Two entry points, three bodies:
//  * flash_prefill_contiguous: the TPU kernel's own function on K/V views
//    with a unit head_dim stride (float32 softmax, *unrounded*
//    probabilities, acc / max(l, 1e-9), zeros for a row with no valid
//    key). bf16 inputs run `flash_prefill_wgmma_kernel` (below); float32
//    inputs (the tests' oracle type, held to 2e-5, which neither TF32 nor
//    one bf16 rounding meets) keep a float32 CUDA-core body: 64-row x
//    64-key tiles in shared memory, two passes over the keys, each of 256
//    threads a 4 x 4 tile of scores and a 4 x (Dh / 16) tile of the
//    output. The type selects the body; nothing falls back from one to the
//    other.
//  * flash_prefill_paged (the serving engine's prefill chunk and
//    Model.prefill's attention, on the main path): S queries at absolute
//    positions q_offset..q_offset+S-1 attend over the first kv_len
//    positions of K/V read in place from a strided per-layer pool slice
//    through int32 page ids (position k is token k % ps of page
//    ids[k / ps]), causally (kv_len = q_offset + S) or not (an encoder's
//    self-attention, kv_len = S, and a decoder's cross-attention over the
//    encoder's kv_len positions, any number). Its numerics are those of the
//    port's `blockwise_attention`: q, k, v and the *normalised*
//    probabilities are rounded to bfloat16, products accumulate in float32,
//    the softmax is float32. Both products are therefore exactly what the
//    tensor cores' bf16 -> f32 `mma` computes, under a float32 config too.
//    Rounding normalised probabilities rules out a one-pass online
//    softmax, so it makes two passes over the keys: pass 1 takes each
//    row's max m and sum l = sum exp(s - m) over the valid keys, pass 2
//    forms p = exp(s - m) / max(l, 1e-9), rounds it and accumulates p v.
//
// -- The contiguous entry's bf16 body (flash_prefill_wgmma_kernel) ------
//
// What bounds it on this card: operations. At hymba-1.5b's prefill (4 x
// 2048 tokens, H 25, Hkv 5, Dh 64, causal) Q K^T and P V over the valid
// (query, key) pairs are 53.7 GFLOP, 0.054 ms at the bf16 tensor cores'
// 989 TFLOP/s, against 36.7 MB to read and write (0.011 ms at 3.35 TB/s).
// At Dh 64 every score also costs an exponential, and the SFU's 16 a cycle
// an SM need as long for them as the tensor cores for the products: the
// two have to overlap for the kernel to come near its bound.
//
// What the design does about it:
//  * One pass with the online softmax, the TPU kernel's m / l / acc
//    recurrence (the engine form's second pass exists only because it
//    rounds normalised probabilities).
//  * S = Q K^T on wgmma m64n128k16 with Q and K from shared memory; P V on
//    wgmma m64n(64 NR)k16 with P from registers (the score accumulators
//    are already P's A-operand layout) and V from shared memory,
//    transposed. Dh is padded with zeros to 64 NR, NR = 1 or 2.
//  * P is rounded to bf16 once for P V, not split into parts as
//    ssd_scan's float32 operands are: the bf16 products are exact in the
//    float32 accumulator, so P's rounding (2^-9 of each probability, of
//    either sign, averaging over the keys) is the only one besides the
//    output's own bf16 rounding (2^-8); l sums the unrounded p. Against
//    the plain version the kernel phase measures at most one bf16 ulp of
//    the output (1.56e-2 at |o| near 2-4), under bf16's 3e-2; a second
//    part would double the P V products for an error the output's
//    rounding hides.
//  * Rows: an item is BQ = rows / G query positions x the G heads of one
//    KV head (R = BQ G rows, as the reference's BlockSpec((1, 1, g,
//    q_block, dh)) packs them), so that one staged K/V tile serves all G
//    heads. At Dh <= 64 a block has three consumer warpgroups (192 rows:
//    G 5 uses 190, G 6 all, G 48 four positions, all); at Dh <= 128 two
//    (128 rows; G 48 uses 96). The consumers' registers (scores 64, P 32,
//    O 32 NR a thread) come from the producer warpgroup, which gives its
//    own back (setmaxnreg): 160 / 240 a consumer thread.
//  * Loads: one warp of the producer warpgroup drives TMA. K/V tiles of
//    128 keys come through a 4-D tensor map (Dh, Hkv, Skv, B), 128-byte
//    swizzled, into a ring of three stages with full / empty mbarriers
//    (one full barrier for a stage's K and V); Q through a map
//    (Dh, H, S, B), one box of (64, G, BQ) an item, into two
//    buffers at Dh <= 64 (one at Dh 128, where two do not fit), so the next
//    item's Q loads while this one computes. Keys past Skv, positions past
//    S and columns past Dh land as zeros. Strides TMA cannot take (not
//    16-byte multiples, or pointers not 16-byte aligned) are staged
//    through the producer's registers; a layout that qualifies but does
//    not encode is an error.
//  * Overlap: within a warpgroup, tile t's S = Q K^T issues with tile t -
//    1's P V, and tile t's softmax runs while that P V does; across
//    warpgroups, named barriers make them take turns to issue, so that
//    one's softmax runs while another's products do.
//  * Tile skipping: an item walks only the keys its rows can see, from its
//    first position's window start to its last position's causal end (or
//    Skv), and masks only the tiles that cross a row's range. A masked
//    score is -inf, so its p is exactly 0 whatever the running max (which
//    starts at the Pallas kernel's -1e30): a fully masked tile adds
//    nothing, and a row with no valid key keeps l = 0 and writes zeros.
//  * Grid: persistent, one block an SM. Items go longest first (the last
//    positions see the most keys when causal), dealt in rounds of one an
//    SM, every other round in reverse. A grid of one block per (query
//    tile, Hkv, B) paid each block's start, first loads and drain: 0.03-
//    0.06 ms of the first version's 0.21 at hymba's shape.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py's
// contiguous_row; PERF.md), at hymba's shape: ~0.138 ms causal against
// SDPA's ~0.145, and ~0.120 ms with the 1024-token window against SDPA's
// 0.440 with its mask: 39% and 34% of the bound. What holds it back
// (benchmarks/torch_flash_prefill_breakdown.py, copies of this file with
// one part cut out): not the exponentials (cutting them saves 2%) nor the
// loads (2%), but the loop's fixed cost. With no products, no softmax and
// no loads a call still takes ~0.055 ms, the items' Q loads and output
// stores alone ~0.038; the products add ~0.029 and the softmax ~0.033.
//
// -- The engine form's body (flash_prefill_mma_kernel) --------------------
//
// What bounds it on this card: operations. A 512-query chunk
// of h2o-danube (H 32, Hkv 8, Dh 80) over ~770 valid keys per query is ~4
// GFLOP against ~8 MB of q, K/V and output: ~500 operations per byte, above
// the ~295 at which an H100's bf16 tensor cores become the limit.
//
// What its design does about it: a block is a 64-row tile of (64 / G query
// positions x the G heads of one KV head), so one staged K/V tile serves
// all G heads; four compute warps own 16 rows each, and a fifth warp only
// stages K/V (warp specialisation). K and V are staged as bf16 in shared
// memory, 128 keys a tile, rows padded to Dh + 8 so that `ldmatrix` is
// conflict-free, in two buffers per operand: the producer warp fills a
// buffer once the compute warps have released it (an "empty" mbarrier) and
// they wait for it to land (a "full" one), so loads overlap the math and no
// block barrier is left in the loop. bf16 pools whose heads are contiguous
// arrive by TMA, one box per page (16 token rows of the head's slice plus 8
// pad elements) through a tensor map of the pool, so a tile costs 8 copies
// where 16-byte copies took 1,280; float32 pools (rounded to bf16 as they
// are stored), head-strided pools and pages that are not a multiple of 8
// tokens go through the producer's registers. A layout that qualifies for
// TMA but does not encode is an error, not a slower path. The block reads
// its page ids into shared memory once. Both passes compute S = Q K^T with
// `mma.sync.m16n8k16` bf16 -> f32 (fragments by `ldmatrix`); each thread
// keeps the running max and sum of its two rows in base 2 (the scale
// folded into one multiply-add before `ex2.approx`), merged over the row's
// four lanes by shuffles. Pass 2 rounds p = 2^(s c - m) * (1 / l) into
// bf16 pairs straight from the score accumulators, which is the
// A-operand layout of the P V `mma`, so p never goes through shared memory;
// O accumulates in float32 registers. Each block walks only the key tiles
// its rows can see (from the window's start to the causal end, or to
// kv_len) and masks only the tiles that cross a row's range or kv_len.
// Blocks are ordered so that the two that share an SM pair a late (long)
// query tile with an early (short) one. Dh is padded with zeros to 32, 64, 80 or 128, one instantiation each.
// On the host, the pools' tensor maps, the shared-memory attribute and the
// SM count are cached (tma.cuh): the engine calls once per layer and chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr float kMinusInf = -__builtin_huge_valf();  // a masked score
constexpr int kMaxDh = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  CUtensorMap kmap, vmap;  // the K / V tensor maps where `tma`
  CUtensorMap qmap;        // contiguous bf16 entry with `tma_q`: q's map
  const void* q;         // (B, S, H, Dh), contiguous
  const void* k;         // contiguous entry: (b, pos, h, d) at
  const void* v;         //   b*sb + pos*st + h*sh + d; paged entry:
  const int32_t* pages;  //   pages[pos / ps]*sp + (pos % ps)*st + h*sh + d
  void* out;             // (B, S, H, Dh), contiguous
  int S, H, Hkv, Dh, page_size, num_pages, q_offset, kv_len, window;
  int batch;  // contiguous bf16 entry: B
  bool causal;
  bool vec;  // paged entry: pools 16-byte aligned in pointer and strides
  bool tma;  // K/V tiles staged by TMA (paged entry: boxes of box_t tokens)
  bool tma_q;  // contiguous bf16 entry: Q tiles by TMA
  int box_t;
  int pg_cap;  // paged entry: most page ids one block's key range spans
  int nsm;     // paged entry: the card's SMs
  int64_t k_sb, k_sp, k_st, k_sh, v_sb, v_sp, v_st, v_sh;
  float scale;
};

// -- contiguous form: float32 CUDA cores -------------------------------------

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kRows = 64;      // query rows (position x head) per block
constexpr int kKeys = 64;      // keys per tile
constexpr int kDC = kMaxDh / 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_prefill_f32_kernel(const Args a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv, Dh = a.Dh, DhP = Dh + 1;
  const int BQ = kRows / G, R = BQ * G;  // positions and rows of the tile
  const int q0 = blockIdx.x * BQ;
  float* q_s = smem;                // kRows x DhP
  float* k_s = q_s + kRows * DhP;   // kKeys x DhP
  float* v_s = k_s + kKeys * DhP;   // kKeys x Dh
  float* p_s = v_s + kKeys * Dh;    // kRows x (kKeys + 1)

  // row r = i * G + g is query position q0 + i, head kvh * G + g
  const T* qg = static_cast<const T*>(a.q);
  for (int e = tid; e < kRows * Dh; e += kThreads) {
    const int r = e / Dh, d = e - r * Dh, i = r / G, g = r - i * G;
    float val = 0.f;
    if (r < R && q0 + i < a.S)
      val = to_f32(qg[(((int64_t)b * a.S + q0 + i) * a.H + kvh * G + g) *
                          Dh + d]);
    q_s[r * DhP + d] = val;
  }

  int qpos[4];
  bool row_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = ty + 16 * j, i = r / G;
    row_ok[j] = r < R && q0 + i < a.S;
    qpos[j] = q0 + i;
  }
  const int qmin = q0;
  const int qmax = min(q0 + BQ, a.S) - 1;
  const int k_hi = a.causal ? min(qmax + 1, a.kv_len) : a.kv_len;
  const int k_lo = a.window > 0 ? max(0, qmin - a.window + 1) : 0;

  const T* kg = static_cast<const T*>(a.k) + (int64_t)kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + (int64_t)kvh * a.v_sh;

  auto valid = [&](int j, int pos) {
    return row_ok[j] && pos < k_hi && (!a.causal || pos <= qpos[j]) &&
           (a.window <= 0 || pos > qpos[j] - a.window);
  };
  auto scores = [&](float (&s)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) qv[j] = q_s[(ty + 16 * j) * DhP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = k_s[(tx + 16 * c) * DhP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = fmaf(qv[j], kv[c], s[j][c]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] *= a.scale;
  };
  auto stage = [&](const T* src, float* dst, int stride, int kb, int64_t sb,
                   int64_t st) {
    for (int e = tid; e < kKeys * Dh; e += kThreads) {
      const int t = e / Dh, d = e - t * Dh, pos = kb + t;
      dst[t * stride + d] =
          pos < k_hi ? to_f32(src[(int64_t)b * sb + (int64_t)pos * st + d])
                     : 0.f;
    }
  };

  // pass 1: each row's max and sum of exponentials over its valid keys
  float m[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
  }
  for (int kb = k_lo; kb < k_hi; kb += kKeys) {
    __syncthreads();  // the previous tile is no longer read
    stage(kg, k_s, DhP, kb, a.k_sb, a.k_st);
    __syncthreads();
    float s[4][4];
    scores(s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (valid(j, kb + tx + 16 * c)) mt = fmaxf(mt, s[j][c]);
      const float m_new = fmaxf(m[j], mt);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (valid(j, kb + tx + 16 * c)) sum += expf(s[j][c] - m_new);
      l[j] = l[j] * expf(m[j] - m_new) + sum;
      m[j] = m_new;
    }
  }
  // merge the 16 lanes that share each row (lanes of one half-warp)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float mm = m[j];
    for (int off = 8; off > 0; off >>= 1)
      mm = fmaxf(mm, __shfl_xor_sync(0xffffffffu, mm, off));
    float ll = l[j] * expf(m[j] - mm);
    for (int off = 8; off > 0; off >>= 1)
      ll += __shfl_xor_sync(0xffffffffu, ll, off);
    m[j] = mm;
    l[j] = fmaxf(ll, 1e-9f);
  }

  // pass 2: normalised probabilities, then p v
  float acc[4][kDC];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[j][c] = 0.f;
  for (int kb = k_lo; kb < k_hi; kb += kKeys) {
    __syncthreads();
    stage(kg, k_s, DhP, kb, a.k_sb, a.k_st);
    stage(vg, v_s, Dh, kb, a.v_sb, a.v_st);
    __syncthreads();
    float s[4][4];
    scores(s);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p_s[(ty + 16 * j) * (kKeys + 1) + tx + 16 * c] =
            valid(j, kb + tx + 16 * c) ? expf(s[j][c] - m[j]) / l[j] : 0.f;
    __syncthreads();
    for (int t = 0; t < kKeys; ++t) {
      float pv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) pv[j] = p_s[(ty + 16 * j) * (kKeys + 1) + t];
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int d = tx + 16 * c;
        if (d < Dh) {
          const float vv = v_s[t * Dh + d];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j][c] = fmaf(pv[j], vv, acc[j][c]);
        }
      }
    }
  }

  T* og = static_cast<T*>(a.out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (!row_ok[j]) continue;
    const int r = ty + 16 * j, i = r / G, g = r - i * G;
    T* orow = og + (((int64_t)b * a.S + q0 + i) * a.H + kvh * G + g) * Dh;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int d = tx + 16 * c;
      if (d < Dh) store(orow + d, acc[j][c]);
    }
  }
}

// -- engine form: bf16 tensor cores -----------------------------------------

constexpr int kMmaWarps = 4;  // each owns 16 of the tile's 64 rows
constexpr int kMmaRows = 16 * kMmaWarps;
constexpr int kMmaKeys = 128;  // keys per staged tile: 16 n-tiles of 8
constexpr int kStages = 2;    // K/V buffers: tiles staged kStages - 1 ahead
constexpr int kNT = kMmaKeys / 8;  // 8-key n-tiles of a key tile

using tma::smem_u32;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a b: m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// 2^x by the SFU alone (relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// up to 8 consecutive elements of a row as floats (zeros past n)
__device__ __forceinline__ void load8(const float* p, int n, bool vec,
                                      float (&x)[8]) {
  if (vec) {  // n is a multiple of 4
    const float4 lo = n >= 4 ? *reinterpret_cast<const float4*>(p)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 hi = n >= 8 ? *reinterpret_cast<const float4*>(p + 4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = e < n ? p[e] : 0.f;
  }
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, int n, bool,
                                      float (&x)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = e < n ? __bfloat162float(p[e]) : 0.f;
}
__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]),
                    pack_bf16(x[4], x[5]), pack_bf16(x[6], x[7]));
}

// DP: Dh padded to a multiple of 16 (the mma depth)
template <typename T, int DP>
__global__ void __launch_bounds__((kMmaWarps + 1) * 32)
flash_prefill_mma_kernel(const __grid_constant__ Args a) {
  constexpr int LD = DP + 8;   // bf16 per staged row: ldmatrix without
  constexpr int KD = DP / 16;  //   bank conflicts; k-steps of Q K^T
  constexpr int ND = DP / 8;   // n-tiles of P V
  constexpr int kTileElems = kMmaKeys * LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kMmaRows * LD;           // kStages buffers
  __nv_bfloat16* v_s = k_s + kStages * kTileElems;    // kStages buffers
  // full[b]: buffer b's tile has landed; empty[b]: every compute warp is
  // done reading it
  uint64_t* full_s = reinterpret_cast<uint64_t*>(v_s + kStages * kTileElems);
  uint64_t* empty_s = full_s + kStages;
  int* pg_s = reinterpret_cast<int*>(empty_s + kStages);  // the page ids

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // Blocks start in launch order, one on each SM and then a second: the
  // first nsm take the heaviest tiles (the latest positions see the most
  // keys) and the next ones the lightest, so that the two tiles sharing an
  // SM add up to about the same work.
  const int nqt = gridDim.x, n_items = nqt * gridDim.y;
  const int item = blockIdx.y * nqt + blockIdx.x;
  const int top = min(n_items, 2 * a.nsm);
  const int rank = item < a.nsm || item >= top ? item
                                               : top - 1 - (item - a.nsm);
  const int kvh = rank % a.Hkv;
  const int G = a.H / a.Hkv, Dh = a.Dh;
  const int BQ = kMmaRows / G, R = BQ * G;  // positions and rows of the tile
  const int q0 = (nqt - 1 - rank / a.Hkv) * BQ;
  const int nch = (Dh + 7) / 8;  // 8-element pieces of a head slice

  // this thread's two rows: warp * 16 + gid and + 8. qpos is the last key
  // a row may see: its position when causal, else past every key (no
  // window then), so that one compare masks either form
  constexpr int kNoLimit = 0x3fffffff;
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + gid + 8 * h, i = r / G;
    row_ok[h] = r < R && q0 + i < a.S;
    qpos[h] = a.causal ? a.q_offset + q0 + i : kNoLimit;
  }
  const int qmin = a.q_offset + q0;
  const int qmax = a.q_offset + min(q0 + BQ, a.S) - 1;
  const int k_hi = a.causal ? min(qmax + 1, a.kv_len) : a.kv_len;
  const int k_lo = a.window > 0 ? max(0, qmin - a.window + 1) : 0;
  // key tiles start at multiples of kMmaKeys, so that they are whole pages
  const int tile_lo = k_lo / kMmaKeys * kMmaKeys;
  const int nt = (k_hi - tile_lo + kMmaKeys - 1) / kMmaKeys;
  const int ps = a.page_size, pg0 = tile_lo / ps;

  constexpr int kThreads = (kMmaWarps + 1) * 32;
  // q rounded to bf16, pad columns and rows past the tile zero (they add
  // nothing to Q K^T); row r = i * G + g is position q0 + i, head kvh*G + g.
  // Without TMA the K/V buffers are zeroed too, so that their pad columns
  // stay zero. And the block's page ids, read once.
  {
    const T* qg = static_cast<const T*>(a.q);
    for (int e = tid; e < kMmaRows * (LD / 8); e += kThreads) {
      const int r = e / (LD / 8), c = e - r * (LD / 8), i = r / G,
                g = r - i * G;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (c < nch && r < R && q0 + i < a.S)
        load8(qg + ((int64_t)(q0 + i) * a.H + kvh * G + g) * Dh + 8 * c,
              min(8, Dh - 8 * c), false, x);
      *reinterpret_cast<uint4*>(q_s + r * LD + 8 * c) = pack8(x);
    }
    if (!a.tma) {
      uint4* z = reinterpret_cast<uint4*>(k_s);
      for (int e = tid; e < 2 * kStages * kTileElems / 8; e += kThreads)
        z[e] = make_uint4(0, 0, 0, 0);
    }
    const int npg = (k_hi - 1) / ps - pg0 + 1;
    for (int e = tid; e < npg; e += kThreads) pg_s[e] = a.pages[pg0 + e];
    if (tid < kStages) {
      tma::mbar_init(&full_s[tid], a.tma ? 1 : 32);
      tma::mbar_init(&empty_s[tid], kMmaWarps);
    }
    tma::mbar_init_fence();
  }
  __syncthreads();

  const T* kg = static_cast<const T*>(a.k) + (int64_t)kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + (int64_t)kvh * a.v_sh;
  const bool ps_pow2 = (ps & (ps - 1)) == 0;
  const int ps_log = __ffs(ps) - 1;

  // The producer warp stages tile after tile: step < nt is pass 1 (K),
  // else pass 2 (K and V) of tile step % nt, into buffer step % kStages
  // once the compute warps have released that buffer's previous tile.
  if (warp == kMmaWarps) {
    // through registers (float32 pools, or layouts TMA does not take):
    // lane converts piece lane % nch of every tpp-th token from lane / nch,
    // zeros at positions >= k_hi
    const int tpp = 32 / nch, my_c = lane % nch, my_t = lane / nch;
    auto copy_tile = [&](const T* src, __nv_bfloat16* dst, int kb,
                         int64_t sp, int64_t st) {
      if (my_t >= tpp) return;
      for (int t = my_t; t < kMmaKeys; t += tpp) {
        const int pos = kb + t;
        float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (pos < k_hi) {
          const int pi = ps_pow2 ? pos >> ps_log : pos / ps;
          load8(src + (int64_t)pg_s[pi - pg0] * sp +
                    (int64_t)(pos - pi * ps) * st + 8 * my_c,
                min(8, Dh - 8 * my_c), a.vec, x);
        }
        *reinterpret_cast<uint4*>(dst + t * LD + 8 * my_c) = pack8(x);
      }
    };
    for (int step = 0; step < 2 * nt; ++step) {
      const int buf = step % kStages, kb = tile_lo + (step % nt) * kMmaKeys;
      const bool with_v = step >= nt;
      if (step >= kStages)
        tma::mbar_wait(&empty_s[buf], (step / kStages - 1) & 1);
      if (a.tma) {  // one box per page that holds keys below k_hi
        if (lane != 0) continue;
        const int bt = a.box_t;
        const int n_box = min(kMmaKeys / bt, (k_hi - kb + bt - 1) / bt);
        tma::mbar_arrive_expect(&full_s[buf],
                           n_box * bt * LD * 2 * (with_v ? 2 : 1));
        for (int j = 0; j < n_box; ++j) {
          const int pos = kb + j * bt;
          const int pi = ps_pow2 ? pos >> ps_log : pos / ps;
          const int page = pg_s[pi - pg0], tok = pos - pi * ps;
          tma::load_3d(k_s + buf * kTileElems + j * bt * LD, &a.kmap, kvh * Dh,
                   tok, page, &full_s[buf]);
          if (with_v)
            tma::load_3d(v_s + buf * kTileElems + j * bt * LD, &a.vmap,
                     kvh * Dh, tok, page, &full_s[buf]);
        }
      } else {  // every lane arrives after its own stores
        copy_tile(kg, k_s + buf * kTileElems, kb, a.k_sp, a.k_st);
        if (with_v)
          copy_tile(vg, v_s + buf * kTileElems, kb, a.v_sp, a.v_st);
        tma::mbar_arrive(&full_s[buf]);
      }
    }
    return;
  }

  // softmax in base 2: p = 2^(s c - m) with c = scale * log2(e), m the
  // running max of s c; pass 2 multiplies by 1 / l. (blockwise_attention
  // takes exp(s * scale - m) / l: this differs in float32 rounding only,
  // ~1e-6 of p, far below p's rounding to bf16; an expf and a true
  // division cost twice the kernel's time.)
  const float c2 = a.scale * 1.4426950408889634f;
  // the positions of the warp's rows, to find the tiles that need no mask
  const int r_last = warp * 16 + 15;
  const bool warp_ok = r_last < R && q0 + r_last / G < a.S;
  const int p_lo = a.q_offset + q0 + (warp * 16) / G;
  const int p_hi = a.q_offset + q0 + r_last / G;
  // a tile ending below full_hi is inside every row's range (k_hi bounds
  // the causal end too)
  const int full_hi = a.causal ? p_lo + 1 : k_hi;
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)  // q fragments, held for the whole kernel
    ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * LD + 16 * kk +
                            (lane >> 4) * 8);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int step = 0; step < 2 * nt; ++step) {
    // this step's tile is in: its buffer's k-th fill completes phase k
    const int buf = step % kStages, kb = tile_lo + (step % nt) * kMmaKeys;
    tma::mbar_wait(&full_s[buf], (step / kStages) & 1);
    if (a.tma && step == 2 * nt - 1 && kb + kMmaKeys > k_hi) {
      // the last tile's page holds rows past the context that p v would
      // multiply by 0: make them zeros, not whatever the pool holds
      uint4* vz = reinterpret_cast<uint4*>(v_s + buf * kTileElems);
      for (int i = (k_hi - kb) * LD / 8 + tid; i < kTileElems / 8;
           i += kMmaWarps * 32)
        vz[i] = make_uint4(0, 0, 0, 0);
      asm volatile("bar.sync 1, %0;\n" ::"n"(kMmaWarps * 32) : "memory");
    }
    if (step == nt) {  // merge the four lanes of each row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float mo = __shfl_xor_sync(0xffffffffu, m[h], off);
          const float lo = __shfl_xor_sync(0xffffffffu, l[h], off);
          const float mm = fmaxf(m[h], mo);
          l[h] = l[h] * exp2f(m[h] - mm) + lo * exp2f(mo - mm);
          m[h] = mm;
        }
        l[h] = 1.f / fmaxf(l[h], 1e-9f);  // from here on, 1 / l
      }
    }
    const __nv_bfloat16* kt = k_s + buf * kTileElems;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * LD +
                           16 * kk + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }
    // mask: s[j][2h + e] is row h's key kb + 8j + 2 tig + e (a masked
    // score becomes -inf); a tile wholly inside every row's range of the
    // warp, and below kv_len, needs none
    const bool full = warp_ok && kb + kMmaKeys <= full_hi &&
                      (a.window <= 0 || kb > p_hi - a.window);
    if (!full) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int pos = kb + 8 * j + 2 * tig + e;
            const bool ok = row_ok[h] && pos < k_hi && pos <= qpos[h] &&
                            (a.window <= 0 || pos > qpos[h] - a.window);
            if (!ok) s[j][2 * h + e] = kMinusInf;
          }
    }

    if (step < nt) {  // pass 1: running max and sum of this thread's keys
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mt = kMinusInf;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          mt = fmaxf(mt, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        const float m_new = fmaxf(m[h], mt * c2);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
          sum += ex2(fmaf(s[j][2 * h], c2, -m_new)) +
                 ex2(fmaf(s[j][2 * h + 1], c2, -m_new));
        l[h] = l[h] * exp2f(m[h] - m_new) + sum;
        m[h] = m_new;
      }
    } else {  // pass 2: p rounded to bf16 in the A layout, then O += P V
      const __nv_bfloat16* vt = v_s + buf * kTileElems;
#pragma unroll
      for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
        uint32_t pa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float* c = s[2 * kk + half];
          pa[2 * half] = pack_bf16(ex2(fmaf(c[0], c2, -m[0])) * l[0],
                                   ex2(fmaf(c[1], c2, -m[0])) * l[0]);
          pa[2 * half + 1] = pack_bf16(ex2(fmaf(c[2], c2, -m[1])) * l[1],
                                       ex2(fmaf(c[3], c2, -m[1])) * l[1]);
        }
#pragma unroll
        for (int jd = 0; jd < ND / 2; ++jd) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, vt + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     16 * jd + (lane >> 4) * 8);
          mma_bf16(o[2 * jd], pa, b[0], b[1]);
          mma_bf16(o[2 * jd + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncwarp();  // the warp is done reading this buffer
    if (lane == 0) tma::mbar_arrive(&empty_s[buf]);
  }

  T* og = static_cast<T*>(a.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const int r = warp * 16 + gid + 8 * h, i = r / G, g = r - i * G;
    T* orow = og + ((int64_t)(q0 + i) * a.H + kvh * G + g) * Dh;
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * tig + e;
        if (d < Dh) store(orow + d, o[j][2 * h + e]);
      }
  }
}

// -- contiguous form in bf16: one pass on wgmma ------------------------------

// NR: 64-column regions of a head (Dh <= 64 NR). A block is one producer
// warpgroup (one warp of it drives the loads) and NWG consumer
// warpgroups of 64 rows each: three at NR 1, two at NR 2, the most whose
// registers fit once the producer gives its own back (setmaxnreg): the
// scores (64), P (32) and O (32 NR) of a thread, and their addresses
__host__ __device__ constexpr int wg_consumers(int NR) {
  return NR == 1 ? 3 : 2;
}
__host__ __device__ constexpr int wg_rows(int NR) {
  return 64 * wg_consumers(NR);
}
__host__ __device__ constexpr int wg_threads(int NR) {
  return 128 * (wg_consumers(NR) + 1);
}
__host__ __device__ constexpr int wg_regs(int NR) {  // a consumer thread's
  return NR == 1 ? 160 : 240;
}
// a producer thread's. The launch gives every thread the same count
// (65536 / threads, down to a multiple of 8); setmaxnreg.inc waits until
// the registers it asks for are free, so what the producer warpgroup gives
// back must cover what the consumers take, or they wait forever
__host__ __device__ constexpr int wg_producer_regs(int NR) {
  return NR == 1 ? 32 : 24;
}
__host__ __device__ constexpr bool wg_regs_balance(int NR) {
  return (wg_regs(NR) - 65536 / wg_threads(NR) / 8 * 8) * wg_consumers(NR) <=
         65536 / wg_threads(NR) / 8 * 8 - wg_producer_regs(NR);
}
static_assert(wg_regs_balance(1) && wg_regs_balance(2),
              "the producer frees the registers the consumers take");
constexpr int kWgKeys = 128;  // keys of a K / V tile
// bytes of one 64-column region (128-byte rows, swizzled) of a K / V tile;
// a Q buffer's region is wg_rows(NR) rows
constexpr int kKvRegion = kWgKeys * 128;
constexpr int kWgStages = 3;  // K / V stages: tiles t + 1, t + 2 load
                              // while tile t computes
// Q buffers: with two, the next item's Q loads while this one computes
// (one at NR 2, where two do not fit)
__host__ __device__ constexpr int wg_qbufs(int NR) { return NR == 1 ? 2 : 1; }
// the dynamic shared memory: the Q buffers, the stages' K and V tiles, and
// 1024 bytes of alignment slack
__host__ __device__ constexpr size_t wg_smem(int NR) {
  return 1024 + (size_t)NR * (wg_qbufs(NR) * wg_rows(NR) * 128 +
                              2 * kWgStages * kKvRegion);
}

// up to 8 consecutive bf16 of a row (zeros past n), as one 16-byte piece
__device__ __forceinline__ uint4 load8_bf16(const __nv_bfloat16* p, int n) {
  __align__(16) __nv_bfloat16 x[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = e < n ? p[e] : __float2bfloat16(0.f);
  return *reinterpret_cast<const uint4*>(x);
}

template <int NR>
__global__ void __launch_bounds__(wg_threads(NR), 1)
flash_prefill_wgmma_kernel(const __grid_constant__ Args a) {
  constexpr int NS = kWgStages, QB = wg_qbufs(NR), NWG = wg_consumers(NR);
  constexpr int ROWS = wg_rows(NR), QREG = ROWS * 128;  // a Q region's bytes
  constexpr int KS = 4 * NR;   // k-steps of Q K^T (16 columns of the head)
  constexpr int NO = 32 * NR;  // output accumulators a thread
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  // full[s]: stage s's K and V tiles have landed; empty[s]: every consumer
  // warp is done with stage s; q_full / q_empty: the same for the Q buffers
  __shared__ __align__(8) uint64_t bar_s[2 * NS + 2 * QB];
  uint64_t* full = bar_s;
  uint64_t* empty = bar_s + NS;
  uint64_t* q_full = bar_s + 2 * NS;
  uint64_t* q_empty = q_full + QB;
  // the swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* q_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* k_s = q_s + QB * NR * QREG;       // NS stages of NR regions
  unsigned char* v_s = k_s + NS * NR * kKvRegion;  // NS stages of NR regions

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.Hkv, S = a.S, Skv = a.kv_len, Dh = a.Dh;
  // an item is BQ positions x the G heads of one KV head of one sequence:
  // R = BQ G rows, row r at position pos0 + r / G, head kvh G + r % G
  const int BQ = ROWS / G, R = BQ * G;
  const int ntile = (S + BQ - 1) / BQ, nbh = a.Hkv * a.batch;
  const int n_items = ntile * nbh;
  // Items in order of decreasing length (the last positions see the most
  // keys when causal), dealt to the blocks in rounds of gridDim.x, every
  // other round in reverse, so that the blocks' totals stay level: round i
  // gives block k item i gridDim.x + (k, or gridDim.x - 1 - k when i is
  // odd)
  auto item_index = [&](int i) {
    const int k = (i & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
    return i * (int)gridDim.x + k;
  };
  struct Item {
    int pos0, kvh, b, k_lo, nt;
  };
  auto item_of = [&](int j) {
    Item it;
    const int bh = j % nbh;
    it.pos0 = (ntile - 1 - j / nbh) * BQ;
    it.kvh = bh % a.Hkv;
    it.b = bh / a.Hkv;
    // the item's keys: from its first position's window start to its last
    // position's causal end, in tiles of kWgKeys from k_lo
    const int p_last = min(it.pos0 + BQ, S) - 1;
    it.k_lo = a.window > 0 ? max(0, it.pos0 - a.window + 1) : 0;
    const int k_hi = a.causal ? min(p_last + 1, Skv) : Skv;
    it.nt = k_hi > it.k_lo ? (k_hi - it.k_lo + kWgKeys - 1) / kWgKeys : 0;
    return it;
  };

  if (tid == 0) {
    for (int i = 0; i < NS; ++i) {
      tma::mbar_init(&full[i], a.tma ? 1 : 32);
      tma::mbar_init(&empty[i], 4 * NWG);
    }
    for (int i = 0; i < QB; ++i) {
      tma::mbar_init(&q_full[i], a.tma_q ? 1 : 32);
      tma::mbar_init(&q_empty[i], 4 * NWG);
    }
    tma::mbar_init_fence();
  }
  // rows R.. of the Q buffers stay zero (TMA writes rows < R only)
  for (int e = tid; e < QB * NR * QREG / 16; e += wg_threads(NR)) {
    const int row = (e >> 3) % ROWS;
    if (row >= R)
      reinterpret_cast<uint4*>(q_s)[e] = make_uint4(0, 0, 0, 0);
  }
  tma::fence_proxy_async();  // read by wgmma (the async proxy)
  __syncthreads();

  if (warp >= 4 * NWG) {  // the producer warpgroup: one warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        wg_producer_regs(NR)));
    if (warp != 4 * NWG) return;
    // through registers: the tile's `total` rows of `region` bytes a 64
    // columns, lane converts 16-byte pieces, zeros past `rows` and the
    // columns; then fenced for wgmma
    auto stage_rows = [&](unsigned char* dst, int region, int total,
                          int rows, auto row_ptr) {
      for (int e = lane; e < total * NR * 8; e += 32) {
        const int r = e / (NR * 8), c = e - r * (NR * 8);
        uint4 x = make_uint4(0, 0, 0, 0);
        const __nv_bfloat16* p = r < rows ? row_ptr(r) : nullptr;
        if (p != nullptr && 8 * c < Dh) x = load8_bf16(p + 8 * c, Dh - 8 * c);
        *reinterpret_cast<uint4*>(dst + (c >> 3) * region +
                                  wg::sw128(r, (c & 7) * 8)) = x;
      }
      tma::fence_proxy_async();
    };
    const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q);
    int gt = 0;  // the block's K / V tiles so far
    for (int i = 0, n = 0; i * (int)gridDim.x < n_items; ++i) {
      if (item_index(i) >= n_items) continue;
      const Item it = item_of(item_index(i));
      const int qb = n % QB;
      unsigned char* qt = q_s + qb * NR * QREG;
      if (n >= QB) tma::mbar_wait_or_trap(&q_empty[qb], (n / QB - 1) & 1);
      ++n;  // items so far
      if (a.tma_q) {  // positions past S land as zeros
        if (lane == 0) {
          tma::mbar_arrive_expect(&q_full[qb], NR * R * 128);
          for (int r = 0; r < NR; ++r)
            tma::load_4d(qt + r * QREG, &a.qmap, 64 * r, it.kvh * G,
                         it.pos0, it.b, &q_full[qb]);
        }
      } else {
        stage_rows(qt, QREG, ROWS, R, [&](int r) -> const __nv_bfloat16* {
          const int pos = it.pos0 + r / G;
          return pos < S ? qg + (((int64_t)it.b * S + pos) * a.H +
                                 it.kvh * G + r % G) * Dh
                         : nullptr;
        });
        tma::mbar_arrive(&q_full[qb]);
      }
      const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) +
                                (int64_t)it.b * a.k_sb +
                                (int64_t)it.kvh * a.k_sh;
      const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) +
                                (int64_t)it.b * a.v_sb +
                                (int64_t)it.kvh * a.v_sh;
      for (int t = 0; t < it.nt; ++t, ++gt) {
        const int st = gt % NS, kb = it.k_lo + t * kWgKeys;
        unsigned char* kt = k_s + st * NR * kKvRegion;
        unsigned char* vt = v_s + st * NR * kKvRegion;
        if (gt >= NS) tma::mbar_wait_or_trap(&empty[st], (gt / NS - 1) & 1);
        if (a.tma) {  // keys past Skv and columns past Dh land as zeros
          if (lane == 0) {
            tma::mbar_arrive_expect(&full[st], 2 * NR * kKvRegion);
            for (int r = 0; r < NR; ++r) {
              tma::load_4d(kt + r * kKvRegion, &a.kmap, 64 * r, it.kvh, kb,
                           it.b, &full[st]);
              tma::load_4d(vt + r * kKvRegion, &a.vmap, 64 * r, it.kvh, kb,
                           it.b, &full[st]);
            }
          }
        } else {
          const int n = min(kWgKeys, Skv - kb);
          stage_rows(kt, kKvRegion, kWgKeys, n, [&](int r) {
            return kg + (int64_t)(kb + r) * a.k_st;
          });
          stage_rows(vt, kKvRegion, kWgKeys, n, [&](int r) {
            return vg + (int64_t)(kb + r) * a.v_st;
          });
          tma::mbar_arrive(&full[st]);
        }
      }
    }
    return;
  }

  // -- consumers: warpgroup wgi owns rows 64 wgi .. 64 wgi + 63 -------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(wg_regs(NR)));
  const int wgi = warp >> 2, gid = lane >> 2, tig = lane & 3;
  const int row0 = 64 * wgi + 16 * (warp & 3) + gid;  // this thread's rows:
                                                      // row0 and row0 + 8
  // softmax in base 2: p = 2^(s c - m), c = scale * log2(e), m the running
  // max of s c, floored at the Pallas kernel's -1e30 so that it stays
  // finite; a masked score is -inf, so its p is exactly 0 whatever m is
  const float c2 = a.scale * 1.4426950408889634f;
  float s[64];  // scores: key 8 j + 2 tig + e of row h at s[4 j + 2 h + e]
  float o[NO];  // output: column 8 j + 2 tig + e of row h at o[4 j + 2 h + e]
  uint32_t pa[8][4];  // P in bf16, the A operand of P V (16 keys a step)
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out);
  // The warpgroups take turns, in a ring, to issue their products (named
  // barrier 1 + w is warpgroup w's turn: it waits on its own and, once it
  // has issued, lets the next through), so that one's softmax runs while
  // another's products do; warpgroup 0 goes first
  auto turn_wait = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wgi),
                 "n"(2 * 128) : "memory");
  };
  auto turn_pass = [&]() {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + (wgi + 1) % NWG),
                 "n"(2 * 128) : "memory");
  };
  if (wgi == NWG - 1) turn_pass();
  int gt = 0;  // the block's K / V tiles so far
  for (int i = 0, n = 0; i * (int)gridDim.x < n_items; ++i) {
    if (item_index(i) >= n_items) continue;
    const Item it = item_of(item_index(i));
    const int qb = n % QB, q_phase = (n / QB) & 1;
    ++n;  // items so far
    const unsigned char* q_wg = q_s + qb * NR * QREG + wgi * 64 * 128;
    // this thread's two rows (h = 0, 1) see keys lo[h] <= k < hi[h]; a row
    // past the item computes on zero queries and is not written
    int lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h, pos = r < R ? it.pos0 + r / G : S;
      lo[h] = pos < S && a.window > 0 ? pos - a.window + 1 : 0;
      hi[h] = pos < S && a.causal ? min(pos + 1, Skv) : Skv;
    }
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < NO; ++e) o[e] = 0.f;

    auto issue_scores = [&](int t) {  // S = Q K_t^T (m64 n128, k = Dh)
      const int st = (gt + t) % NS;
      tma::mbar_wait_or_trap(&full[st], ((gt + t) / NS) & 1);  // K and V
      const unsigned char* kt = k_s + st * NR * kKvRegion;
      wg::pin(s);
      wg::wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wg::wg_ss_n128(
            s,
            wg::gdesc(q_wg + (ks >> 2) * QREG + (ks & 3) * 32, 16, 1024),
            wg::gdesc(kt + (ks >> 2) * kKvRegion + (ks & 3) * 32, 16, 1024),
            ks > 0);
      wg::wg_commit();
    };
    auto issue_pv = [&](int t) {  // O += P V_t (m64 n(64 NR), k = keys)
      const int st = (gt + t) % NS;
      const unsigned char* vt = v_s + st * NR * kKvRegion;
      wg::pin(o);
      wg::pin_a(pa);
      wg::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgKeys / 16; ++kk) {
        const uint64_t dv = wg::gdesc(vt + kk * 2048, kKvRegion, 1024);
        if constexpr (NR == 1)
          wg::wg_n64_t(*reinterpret_cast<float(*)[32]>(o), pa[kk], dv, 1);
        else
          wg::wg_n128_t(*reinterpret_cast<float(*)[64]>(o), pa[kk], dv, 1);
      }
      wg::wg_commit();
    };
    auto release = [&](uint64_t* bar) {  // the warp is done with a buffer
      __syncwarp();
      if (lane == 0) tma::mbar_arrive(bar);
    };
    // mask tile t where it crosses a row's range, then the online softmax:
    // s becomes p (unrounded), m and l move on, alpha rescales O
    auto softmax = [&](int t, float (&alpha)[2]) {
      const int kb = it.k_lo + t * kWgKeys;
      const bool full = lo[0] <= kb && kb + kWgKeys <= hi[0] &&
                        lo[1] <= kb && kb + kWgKeys <= hi[1];
      if (!full) {
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = kb + 8 * jj + 2 * tig + e;
              if (key < lo[h] || key >= hi[h])
                s[4 * jj + 2 * h + e] = kMinusInf;
            }
      }
      // the row max and sum in two chains each (the additions' order
      // differs from a serial sum in float32 rounding only)
      float mt[2][2], sum[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          mt[h][c] = fmaxf(s[4 * c + 2 * h], s[4 * c + 2 * h + 1]);
#pragma unroll
      for (int jj = 2; jj < 16; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mt[h][jj & 1] = fmaxf(mt[h][jj & 1], fmaxf(s[4 * jj + 2 * h],
                                                     s[4 * jj + 2 * h + 1]));
      float m_new[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x = fmaxf(mt[h][0], mt[h][1]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        m_new[h] = fmaxf(m[h], x * c2);
        alpha[h] = ex2(m[h] - m_new[h]);
        m[h] = m_new[h];
        sum[h][0] = sum[h][1] = 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(s[4 * jj + 2 * h + e], c2, -m_new[h]));
            s[4 * jj + 2 * h + e] = p;
            sum[h][jj & 1] += p;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        l[h] = l[h] * alpha[h] + (sum[h][0] + sum[h][1]);
    };
    auto pack_p = [&]() {  // the score accumulators are P's A layout
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    };

    tma::mbar_wait_or_trap(&q_full[qb], q_phase);
    if (it.nt > 0) {
      float alpha[2];
      turn_wait();
      issue_scores(0);
      turn_pass();
      wg::wg_wait();
      wg::pin(s);
      softmax(0, alpha);
      pack_p();
      // tile t's scores run while tile t - 1's P V does, and tile t's
      // softmax while P V still runs
      for (int t = 1; t < it.nt; ++t) {
        turn_wait();
        issue_scores(t);
        issue_pv(t - 1);
        turn_pass();
        wg::wg_wait_1();  // the scores
        wg::pin(s);
        softmax(t, alpha);
        wg::wg_wait();  // P V
        wg::pin(o);
        wg::pin_a(pa);
        release(&empty[(gt + t - 1) % NS]);
#pragma unroll
        for (int e = 0; e < NO; e += 4) {
          o[e] *= alpha[0];
          o[e + 1] *= alpha[0];
          o[e + 2] *= alpha[1];
          o[e + 3] *= alpha[1];
        }
        pack_p();
      }
      release(&q_empty[qb]);  // every Q K^T of the item is complete
      turn_wait();
      issue_pv(it.nt - 1);
      turn_pass();
      wg::wg_wait();
      wg::pin(o);
      wg::pin_a(pa);
      release(&empty[(gt + it.nt - 1) % NS]);
    } else {
      release(&q_empty[qb]);
    }
    gt += it.nt;

    // acc / max(l, 1e-9): a row with no valid key has l = 0 and o = 0
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float inv = 1.f / fmaxf(lt, 1e-9f);
      const int r = row0 + 8 * h, pos = it.pos0 + r / G;
      if (r >= R || pos >= S) continue;
      __nv_bfloat16* orow =
          og + (((int64_t)it.b * S + pos) * a.H + it.kvh * G + r % G) * Dh;
#pragma unroll
      for (int jj = 0; jj < NO / 4; ++jj) {
        const int d = 8 * jj + 2 * tig;
        const float x0 = o[4 * jj + 2 * h] * inv;
        const float x1 = o[4 * jj + 2 * h + 1] * inv;
        if ((Dh & 1) == 0) {
          if (d < Dh)
            *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                __floats2bfloat162_rn(x0, x1);
        } else {
          if (d < Dh) orow[d] = __float2bfloat16(x0);
          if (d + 1 < Dh) orow[d + 1] = __float2bfloat16(x1);
        }
      }
    }
  }
}

template <int NR>
int launch_wgmma(Args a, int B, cudaStream_t stream) {
  // K / V by TMA through a 4-D map (Dh, Hkv, Skv, B) (innermost first)
  // where the pointers are 16-byte aligned and every stride a nonzero
  // multiple of 16 bytes, else through the producer's registers; Q by TMA
  // through a map (Dh, H, S, B) where q is aligned and Dh a multiple of 8.
  // A layout that qualifies but does not encode is an error.
  const auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const auto ok = [](int64_t st) { return st > 0 && (st * 2) % 16 == 0; };
  a.tma = al(a.k) && al(a.v) && ok(a.k_sb) && ok(a.k_st) && ok(a.k_sh) &&
          ok(a.v_sb) && ok(a.v_st) && ok(a.v_sh);
  a.tma_q = al(a.q) && a.Dh % 8 == 0;
  const int G = a.H / a.Hkv;
  int e = 0;
  if (a.tma) {
    const int64_t dims[4] = {a.Dh, a.Hkv, a.kv_len, B};
    const int box[4] = {64, 1, kWgKeys, 1};
    const int64_t ks[3] = {a.k_sh, a.k_st, a.k_sb},
                  vs[3] = {a.v_sh, a.v_st, a.v_sb};
    e = tma::encode_tiled(&a.kmap, a.k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                          4, dims, ks, box, CU_TENSOR_MAP_SWIZZLE_128B);
    if (e == 0)
      e = tma::encode_tiled(&a.vmap, a.v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, 4, dims, vs, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (e == 0 && a.tma_q) {
    const int64_t dims[4] = {a.Dh, a.H, a.S, B};
    const int box[4] = {64, G, wg_rows(NR) / G, 1};
    const int64_t qs[3] = {a.Dh, (int64_t)a.H * a.Dh,
                           (int64_t)a.S * a.H * a.Dh};
    e = tma::encode_tiled(&a.qmap, a.q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                          4, dims, qs, box, CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (e == 0) e = tma::sm_count(&a.nsm);
  if (e) return e;
  const size_t smem = wg_smem(NR);
  e = tma::allow_smem((const void*)flash_prefill_wgmma_kernel<NR>, smem);
  if (e) return e;
  // one block an SM, each walking its items
  const int bq = wg_rows(NR) / G;
  const int64_t items = (int64_t)(a.S + bq - 1) / bq * a.Hkv * B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.batch = B;
  dim3 grid((unsigned)(items < a.nsm ? items : a.nsm));
  flash_prefill_wgmma_kernel<NR><<<grid, wg_threads(NR), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)(kRows + kKeys) * (a.Dh + 1) + (size_t)kKeys * a.Dh +
       (size_t)kRows * (kKeys + 1));
  int e = tma::allow_smem((const void*)flash_prefill_f32_kernel<T>, smem);
  if (e) return e;
  const int bq = kRows / (a.H / a.Hkv);
  dim3 grid((a.S + bq - 1) / bq, a.Hkv, B);
  flash_prefill_f32_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_mma(Args a, cudaStream_t stream) {
  // TMA for bf16 pools whose heads are contiguous (a token's K row is one
  // run of Hkv * Dh), 16-byte aligned, whose pages split into boxes of a
  // multiple of 8 tokens that tile the key tiles; a layout that qualifies
  // but does not encode is an error
  const int bt = a.page_size < kMmaKeys ? a.page_size : kMmaKeys;
  a.tma = sizeof(T) == 2 && a.vec && a.k_sh == a.Dh && a.v_sh == a.Dh &&
          a.page_size % bt == 0 && kMmaKeys % bt == 0 && bt % 8 == 0;
  a.box_t = bt;
  if (a.tma) {
    int e = tma::encode_pool(&a.kmap, a.k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             2, a.Hkv * a.Dh, a.page_size, a.num_pages,
                             a.k_st, a.k_sp, DP + 8, bt);
    if (e == 0)
      e = tma::encode_pool(&a.vmap, a.v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                           a.Hkv * a.Dh, a.page_size, a.num_pages, a.v_st,
                           a.v_sp, DP + 8, bt);
    if (e) return e;
  }
  const size_t smem =
      sizeof(__nv_bfloat16) * (size_t)(kMmaRows + 2 * kStages * kMmaKeys) *
          (DP + 8) +
      sizeof(uint64_t) * 2 * kStages + sizeof(int) * (size_t)a.pg_cap;
  int e = tma::allow_smem((const void*)flash_prefill_mma_kernel<T, DP>,
                          smem);
  if (e) return e;
  const int bq = kMmaRows / (a.H / a.Hkv);
  dim3 grid((a.S + bq - 1) / bq, a.Hkv, 1);
  flash_prefill_mma_kernel<T, DP>
      <<<grid, (kMmaWarps + 1) * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_paged(Args a, cudaStream_t stream) {
  const int e = tma::sm_count(&a.nsm);
  if (e) return e;
  const int64_t esz = sizeof(T);
  const auto al = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  a.vec = al(a.k) && al(a.v) && (a.Dh * esz) % 16 == 0 &&
          (a.k_sp * esz) % 16 == 0 && (a.k_st * esz) % 16 == 0 &&
          (a.k_sh * esz) % 16 == 0 && (a.v_sp * esz) % 16 == 0 &&
          (a.v_st * esz) % 16 == 0 && (a.v_sh * esz) % 16 == 0;
  // a block's keys span at most kMmaRows - 1 + window positions, from a
  // tile start up to kMmaKeys - 1 before them
  const int wspan = a.window + kMmaRows - 1 + kMmaKeys - 1;
  const int span = a.window > 0 && wspan < a.kv_len ? wspan : a.kv_len;
  a.pg_cap = span / a.page_size + 2;
  if (a.Dh <= 32) return launch_mma<T, 32>(a, stream);
  if (a.Dh <= 64) return launch_mma<T, 64>(a, stream);
  if (a.Dh <= 80) return launch_mma<T, 80>(a, stream);
  return launch_mma<T, 128>(a, stream);
}

bool bad_shape(const Args& a) {
  const int G = a.Hkv > 0 ? a.H / a.Hkv : 0;
  return G < 1 || G > kRows || a.H % a.Hkv || a.Dh < 1 || a.Dh > kMaxDh;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output share it).
// window <= 0 means no window. Each returns 0 once launched, else a
// cudaError_t or tma::kEncodeError + a CUresult.

// The TPU kernel's function: q (B, S, H, Dh) contiguous; k, v
// (B, Skv, Hkv, Dh) with strides (sb, st, sh, 1).
int flash_prefill_contiguous(const void* q, const void* k, const void* v,
                             void* out, int B, int S, int H, int Hkv, int Dh,
                             int Skv, int causal, int window, int64_t k_sb,
                             int64_t k_st, int64_t k_sh, int64_t v_sb,
                             int64_t v_st, int64_t v_sh, float scale,
                             int dtype, void* stream) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.pages = nullptr; a.out = out;
  a.S = S; a.H = H; a.Hkv = Hkv; a.Dh = Dh; a.page_size = 1;
  a.q_offset = 0; a.kv_len = Skv; a.window = window; a.causal = causal != 0;
  a.k_sb = k_sb; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_st = v_st; a.v_sh = v_sh;
  a.scale = scale;
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32<float>(a, B, s);
  if (dtype == 1)
    return a.Dh <= 64 ? launch_wgmma<1>(a, B, s) : launch_wgmma<2>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

// One engine prefill chunk: q (1, S, H, Dh) contiguous at positions
// q_offset..q_offset+S-1; K/V of context position k at
// pages[k / ps]*sp + (k % ps)*st + h*sh + d, for pages < num_pages; over
// the first kv_len keys, causally (then kv_len >= q_offset + S) or all of
// them (kv_len >= 1, no window).
int flash_prefill_paged(const void* q, const void* k_pool,
                        const void* v_pool, const int32_t* pages, void* out,
                        int S, int H, int Hkv, int Dh, int page_size,
                        int num_pages, int q_offset, int kv_len, int causal,
                        int window, int64_t k_sp, int64_t k_st,
                        int64_t k_sh, int64_t v_sp, int64_t v_st,
                        int64_t v_sh, float scale, int dtype, void* stream) {
  Args a = {};
  a.q = q; a.k = k_pool; a.v = v_pool; a.pages = pages; a.out = out;
  a.S = S; a.H = H; a.Hkv = Hkv; a.Dh = Dh; a.page_size = page_size;
  a.num_pages = num_pages;
  a.q_offset = q_offset; a.kv_len = kv_len; a.window = window;
  a.causal = causal != 0;
  a.k_sp = k_sp; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sp = v_sp; a.v_st = v_st; a.v_sh = v_sh;
  a.scale = scale;
  if (bad_shape(a) || kv_len < (a.causal ? q_offset + S : 1) ||
      (!a.causal && window > 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_paged<float>(a, s);
  if (dtype == 1) return launch_paged<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_prefill_error_string(int err) {
  return tma::error_string(err);
}

}  // extern "C"
