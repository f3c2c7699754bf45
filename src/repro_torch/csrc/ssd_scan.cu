// Mamba2 SSD chunked scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` in src/repro/kernels/ssd_scan.py
// (body `_ssd_kernel`). For each (sequence b, head h) and each chunk of L
// tokens, with cum = the in-chunk inclusive cumulative sum of dt * A_h:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//        + exp(cum_i) C_i S^T                       (the incoming state)
//   S'   = S exp(cum_L) + sum_j exp(cum_L - cum_j) dt_j x_j^T B_j
// where S is the (P, N) state carried from chunk to chunk. y and the final
// state are float32. Head h reads B/C group h / (H / G).
//
// What bounds it on this card, at mamba2-1.3b's prefill (b 4, l 1024, H 64,
// P 64, G 1, N 128, L 256, bf16 x / B / C): bytes. x, dt, A, B and C read
// once and y and the state written once are 112,197,888 B, 33.5 us at
// 3.35 TB/s; y in float32 is 60% of them. The useful products (the masked
// C B^T and its product with x over the j <= i pairs, C S^T and the state
// update) are 21.5 GFLOP, 21.8 us at the bf16 tensor cores' 989 TFLOP/s.
//
// The first version (one block of 256 threads per (b, h) walking its chunks
// in order, float32 FMAs on CUDA cores from shared memory) took 2.4 ms,
// 72x the bound: ~24.6 GFLOP of scalar FMAs with 8 shared-memory reads per
// 16 FMAs, ~134 KB of shared memory so one block per SM, 256 blocks in two
// waves, and the B and x tiles staged again for every (row tile, column
// tile) pair.
//
// The design now, for bf16 x / B / C (the main path):
//  * Chunk-parallel work. A block of one warpgroup (4 warps) takes one
//    (chunk, b, h) item: 1024 items at the prefill shape, and also 1024 for
//    one 4096-token prompt. It first computes its chunk's local state
//    S_loc = sum_j exp(cum_L - cum_j) dt_j x_j^T B_j, which needs no
//    earlier chunk.
//  * A chained scan carries the state inside the one kernel. The output
//    `state` is the chain's buffer: the block of chunk c waits until the
//    (b, h) flag reads c (an acquire load by one thread), reads S_in there,
//    writes S_out = S_in exp(cum_L) + S_loc in place and releases the flag
//    to c + 1; chunk 0 writes S_loc. The last chunk's S_out is the final
//    state. Blocks take their item from an atomic ticket in the order they
//    start, chunk-major, so a block only waits on a block that has started
//    and waits on nothing later: the chain cannot deadlock, whatever order
//    the hardware starts blocks in. The flags and the ticket are one int32
//    array that the wrapper zeroes; the kernel allocates nothing.
//  * Then, 64-row tile by tile, y = exp(cum_i) C_i S_in^T plus the masked,
//    decay-weighted C_i B_j^T times x over the 32-row j tiles up to the
//    diagonal, accumulated in registers and written once.
//  * Every product runs on `wgmma.mma_async` (m64nNk16, bf16 -> f32). C B^T
//    is exact (bf16 inputs), with A the row tile's C fragments in
//    registers. The products with a float32 operand (the weighted scores
//    times x, the weighted x^T times B for S_loc, C times S_in) split that
//    operand into kSplit = 3 bf16 parts and issue one wgmma per part
//    against the exact bf16 operand: the sum carries ~24 of float32's 24
//    mantissa bits, where one bf16 rounding is hundreds of times over the
//    tests' elementwise 2e-4 and two parts reach 0.85 of it at a 1024-token
//    shape (benchmarks/torch_ssd_split_error.py). dt_j is folded into the weights, so x stays exact. The
//    scores never leave registers: their accumulators are weighted, split
//    and fed back as the register A operand of the product with x. Below
//    the diagonal no weight is masked and row b's weights are row a's
//    times exp(cum_b - cum_a), half the exponentials.
//  * Each wgmma group is waited for before its registers are touched
//    again, the product with x of job q excepted, which runs on while job
//    q + 1's tiles are checked and its scores issued: the compiler then
//    keeps every group asynchronous (software pipelining across jobs made
//    it serialise them all). Two blocks per SM overlap each other's waits.
//  * B, x and C tiles come by TMA boxes of 64 columns in the 128-byte-
//    swizzled layout wgmma reads, B / x in a ring of three buffers loaded
//    two jobs ahead, the C tile a row tile ahead (its fragments go to
//    registers at the row tile's start); S_in's parts are written in the
//    same layout by the threads. A layout TMA cannot take (hymba's P 50:
//    head slices not 16-byte aligned; strides not a multiple of 16 bytes;
//    several groups with N not a multiple of 16) is staged through
//    registers instead; one that qualifies but does not encode raises.
//    Shared memory is ~104 KB at L 256: two blocks per SM.
//  * The cumulative sum is a block scan (the first warp: serial segments,
//    then a warp scan of the segment totals).
//
// Measured on an H100 (chip_smoke.py, PERF.md): ~0.21 ms at the prefill
// shape, against 2.4 ms for the first version; the bound is 0.034 ms. What
// still holds it back is latency: each job (one 32-row j tile) waits for
// its scores, and the per-chunk set-up, the chain and the row-tile starts
// add their own waits; two blocks per SM hide only part of them.
//
// The float32 form (x, B, C float32: the model's float32 oracle and the
// tests) keeps the first version's float32 CUDA-core body, selected by
// dtype; nothing falls back from one form to the other.
//
// Every loop over P and N is bounded by the runtime sizes (P <= 64,
// N <= 128), so mamba2's P 64 / N 128 and hymba's P 50 / N 16 both work,
// and any chunk that divides l (a partial last row tile is zero-filled).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"  // allow_smem, smem_u32

namespace {

using bf16 = __nv_bfloat16;
using tma::smem_u32;

constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

// Inclusive scan of a[0..n) in place, by the block's first warp.
__device__ void block_cumsum(float* a, int n) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  const int seg = (n + 31) / 32;
  const int lo = min(n, lane * seg), hi = min(n, lo + seg);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += a[i];
    a[i] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  const float before = incl - run;
  for (int i = lo; i < hi; ++i) a[i] += before;
}

// -- the float32 form: CUDA cores -------------------------------------------

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kT = 64;         // rows of an i tile and of a j tile
constexpr int kPC = kMaxP / 16;  // y tile: rows ty + 16a, cols tx + 16b
constexpr int kNC = kMaxN / 16;  // state update: p = ty + 16a, n = tx + 16b

struct Args {
  const void* x;    // element (b, t, h, p) at b*x_sb + t*x_sl + h*P + p
  const float* dt;  // (b, l, h), contiguous
  const float* A;   // (h,)
  const void* B;    // element (b, t, g, n) at b*bc_sb + t*bc_sl + g*N + n
  const void* C;    //   (the same strides for B and C)
  float* y;         // (b, l, h, p), contiguous
  float* state;     // (b, h, p, n), contiguous
  int* sync;        // bf16 form: b*h chain flags, then the ticket (zeroed)
  int batch, l, H, P, G, N, chunk;
  int64_t x_sb, x_sl, bc_sb, bc_sl;
  // bf16 form: tensor maps of x (H*P, l, b) and of B, C (G*N, l, b), used
  // where tma_x / tma_bc say the layout takes them
  CUtensorMap xmap, bmap, cmap;
  int tma_x, tma_bc;
};

// One block per (b, h) walks its chunks in order with the state in shared
// memory; 64 x 64 tiles of the chunk's score matrix, j <= i only. Each
// thread keeps a 4 x 4 tile of y, a 4 x 4 tile of scores and a 4 x 8 tile
// of the state update in registers.
__global__ void __launch_bounds__(kThreads)
ssd_scan_f32_kernel(const Args a) {
  extern __shared__ float smem[];
  const int bb = blockIdx.y, hh = blockIdx.x, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int P = a.P, N = a.N, NP = N + 1, L = a.chunk;
  const int gg = hh / (a.H / a.G);
  float* s_s = smem;             // P x NP   the carried state
  float* c_s = s_s + P * NP;     // kT x NP  C rows of the i tile
  float* b_s = c_s + kT * NP;    // kT x NP  B rows of the j tile
  float* x_s = b_s + kT * NP;    // kT x P   xdt rows of the j tile
  float* sc_s = x_s + kT * P;    // kT x (kT + 1) masked scores
  float* cum_s = sc_s + kT * (kT + 1);  // L
  float* dt_s = cum_s + L;              // L

  const float* xg = static_cast<const float*>(a.x) + bb * a.x_sb +
                    (int64_t)hh * P;
  const float* bg = static_cast<const float*>(a.B) + bb * a.bc_sb +
                    (int64_t)gg * N;
  const float* cg = static_cast<const float*>(a.C) + bb * a.bc_sb +
                    (int64_t)gg * N;
  const float A = a.A[hh];

  for (int i = tid; i < P * NP; i += kThreads) s_s[i] = 0.f;

  const int ntiles = (L + kT - 1) / kT;
  for (int base = 0; base < a.l; base += L) {
    for (int t = tid; t < L; t += kThreads) {
      const float d = a.dt[((int64_t)bb * a.l + base + t) * a.H + hh];
      dt_s[t] = d;
      cum_s[t] = d * A;
    }
    __syncthreads();
    block_cumsum(cum_s, L);
    __syncthreads();
    const float cum_last = cum_s[L - 1];

    float ds[kPC][kNC];  // this chunk's state update (last row tile)
#pragma unroll
    for (int i = 0; i < kPC; ++i)
#pragma unroll
      for (int j = 0; j < kNC; ++j) ds[i][j] = 0.f;

    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * kT;
      __syncthreads();  // c_s of the previous row tile is no longer read
      for (int e = tid; e < kT * N; e += kThreads) {
        const int i = e / N, n = e - i * N;
        c_s[i * NP + n] = (i0 + i < L)
            ? cg[(int64_t)(base + i0 + i) * a.bc_sl + n] : 0.f;
      }
      __syncthreads();

      // the incoming state: exp(cum_i) C_i S^T
      float acc[4][kPC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kPC; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[kPC];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = c_s[(ty + 16 * r) * NP + n];
#pragma unroll
        for (int c = 0; c < kPC; ++c) {
          const int p = tx + 16 * c;
          sv[c] = p < P ? s_s[p * NP + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < kPC; ++c) acc[r][c] = fmaf(cv[r], sv[c],
                                                         acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float dec = i < L ? expf(cum_s[i]) : 0.f;
#pragma unroll
        for (int c = 0; c < kPC; ++c) acc[r][c] *= dec;
      }

      const bool last = it == ntiles - 1;
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kT;
        __syncthreads();  // b_s, x_s, sc_s of the previous j tile are free
        for (int e = tid; e < kT * N; e += kThreads) {
          const int j = e / N, n = e - j * N;
          b_s[j * NP + n] = (j0 + j < L)
              ? bg[(int64_t)(base + j0 + j) * a.bc_sl + n] : 0.f;
        }
        for (int e = tid; e < kT * P; e += kThreads) {
          const int j = e / P, p = e - j * P;
          x_s[e] = (j0 + j < L)
              ? xg[(int64_t)(base + j0 + j) * a.x_sl + p] * dt_s[j0 + j]
              : 0.f;
        }
        __syncthreads();
        // scores of rows ty + 16r against columns tx + 16c, masked j <= i
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = c_s[(ty + 16 * r) * NP + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = b_s[(tx + 16 * c) * NP + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(cv[r], bv[c],
                                                        sc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx + 16 * c;
            const float w = (j <= i && i < L) ? expf(cum_s[i] - cum_s[j])
                                              : 0.f;
            sc_s[(ty + 16 * r) * (kT + 1) + tx + 16 * c] = sc[r][c] * w;
          }
        }
        __syncthreads();
        // y_i += sum_j scores_ij xdt_j
        for (int j = 0; j < kT; ++j) {
          float sv[4], xv[kPC];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            sv[r] = sc_s[(ty + 16 * r) * (kT + 1) + j];
#pragma unroll
          for (int c = 0; c < kPC; ++c) {
            const int p = tx + 16 * c;
            xv[c] = p < P ? x_s[j * P + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < kPC; ++c) acc[r][c] = fmaf(sv[r], xv[c],
                                                           acc[r][c]);
        }
        if (last) {
          // S update: sum_j exp(cum_L - cum_j) xdt_j[p] B_j[n]
          for (int j = 0; j < kT && j0 + j < L; ++j) {
            const float w = expf(cum_last - cum_s[j0 + j]);
            float xv[kPC], bv[kNC];
#pragma unroll
            for (int r = 0; r < kPC; ++r) {
              const int p = ty + 16 * r;
              xv[r] = p < P ? x_s[j * P + p] * w : 0.f;
            }
#pragma unroll
            for (int c = 0; c < kNC; ++c) {
              const int n = tx + 16 * c;
              bv[c] = n < N ? b_s[j * NP + n] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < kPC; ++r)
#pragma unroll
              for (int c = 0; c < kNC; ++c) ds[r][c] = fmaf(xv[r], bv[c],
                                                            ds[r][c]);
          }
        }
      }
      // write the row tile's y
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i >= L) continue;
        float* yr = a.y + (((int64_t)bb * a.l + base + i) * a.H + hh) * P;
#pragma unroll
        for (int c = 0; c < kPC; ++c) {
          const int p = tx + 16 * c;
          if (p < P) yr[p] = acc[r][c];
        }
      }
    }
    __syncthreads();  // every read of the old state is done
    const float dec = expf(cum_last);
#pragma unroll
    for (int r = 0; r < kPC; ++r) {
      const int p = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        const int n = tx + 16 * c;
        if (p < P && n < N) s_s[p * NP + n] = s_s[p * NP + n] * dec +
                                              ds[r][c];
      }
    }
    __syncthreads();  // the state is complete before the next chunk
  }

  float* st = a.state + ((int64_t)bb * a.H + hh) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    st[e] = s_s[p * NP + n];
  }
}

int launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)a.P * (a.N + 1) + 2 * (size_t)kT * (a.N + 1) +
       (size_t)kT * a.P + (size_t)kT * (kT + 1) + 2 * (size_t)a.chunk);
  const int e = tma::allow_smem((const void*)ssd_scan_f32_kernel, smem);
  if (e != 0) return e;
  dim3 grid(a.H, a.batch);
  ssd_scan_f32_kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// -- the bf16 form: wgmma, chunk-parallel with a chained state --------------

constexpr int kTc = 128;   // one warpgroup; warp w owns rows 16 w + 0..15 of
                           // every 64-row product (wgmma's m64 layout)
constexpr int kRows = 64;  // rows of a row tile (i) and of the C tile
constexpr int kJ = 32;     // rows of a staged B / x tile (j)
constexpr int kStages = 3;  // B / x tile buffers: jobs q + 1 and q + 2 load
                            // while job q computes
constexpr int kSplit = 3;  // bf16 parts of a float32 operand
// Staged tiles live in shared memory in wgmma's 128-byte-swizzled layout,
// as TMA's SWIZZLE_128B writes it: rows of 64 bf16 (128 B), the 16-byte
// pieces of row r permuted by r % 8; a 128-column operand is two regions.
constexpr int kRegionC = kRows * 128;  // bytes of one 64-column region
constexpr int kRegionJ = kJ * 128;
constexpr int kBytesC = 2 * kRegionC;  // C tile (64 x 128)
constexpr int kBytesB = 2 * kRegionJ;  // B tile (32 x 128)
constexpr int kBytesX = kRegionJ;      // x tile (32 x 64)
constexpr int kBytesS = 2 * kRegionC;  // one part of the state (64 x 128)

// the byte offset of element (row, col) in a region, col < 64
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) << 1));
}
// a wgmma shared-memory matrix descriptor, 128-byte swizzle: lbo = bytes
// between 64-element atoms along a row-contiguous (MN-major) operand's N,
// sbo = bytes between 8-row groups
__device__ __forceinline__ uint64_t gdesc(const void* p, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until every committed group is complete
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across a wait
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keep a register A operand in its registers until its products are waited
// for (wgmma reads them after the issuing instruction)
template <int K>
__device__ __forceinline__ void pin_a(uint32_t (&a)[K][kSplit][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int s = 0; s < kSplit; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][s][e])::"memory");
}

// wgmma.m64nNk16, bf16 -> f32: d += a b (d = a b when scale_d is 0), A
// from registers (each warp's 16 rows in the mma.m16n8k16 A layout), B
// from shared memory, K-major (row n of the tile holds the operand's
// column n), or transposed (_t: row k of the tile is the operand's row k).
__device__ __forceinline__ void wg_n32(float (&d)[16],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wg_n64(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wg_n64_t(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "{%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wg_n128_t(float (&d)[64],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// (v0, v1) as kSplit bf16 pairs whose sum is (v0, v1) to ~2^-24: each part
// is the bf16 rounding of what the earlier parts left
__device__ __forceinline__ void split_pack(float v0, float v1, int k,
                                           uint32_t (&out)[kSplit][4]) {
#pragma unroll
  for (int s = 0; s < kSplit; ++s) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    out[s][k] = *reinterpret_cast<const uint32_t*>(&h);
    v0 -= __low2float(h);
    v1 -= __high2float(h);
  }
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
// Wait for phase `parity` of an mbarrier that TMA completes; a copy still
// outstanding after seconds is a fault: trap rather than hang the card.
__device__ __forceinline__ void wait_tiles(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (int64_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (spins > (1ll << 24)) __trap();
  }
}

// A tile of `rows` rows through registers, for layouts TMA cannot take: row
// r from src + r * stride, `cols` valid columns (zeros past them and from
// row `valid` on), `width` columns (a multiple of 8) written into 64-column
// swizzled regions `region` bytes apart.
__device__ __forceinline__ void stage(unsigned char* dst, int region,
                                      int rows, const bf16* src,
                                      int64_t stride, int valid, int cols,
                                      int width) {
  const int per_row = width >> 3;
  for (int e = threadIdx.x; e < rows * per_row; e += kTc) {
    const int r = e / per_row, c = (e - r * per_row) << 3;
    const bf16* s = src + r * stride + c;
    __align__(16) bf16 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = (r < valid && c + k < cols) ? s[k] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst + (c >> 6) * region + sw128(r, c & 63)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// The chunk's jobs in order: j tiles 0..TJ-1 of S_loc, then for each row
// tile it its j tiles 0..min(2 it + 2, TJ) - 1 of y.
struct Job {
  int it, jt;  // the row tile (y jobs) and the 32-row j tile
  bool row_start, row_end;
};
__device__ __forceinline__ Job job_of(int q, int TJ) {
  Job j{0, q, false, false};
  if (q >= TJ) {
    int k = q - TJ;
    while (k >= min(2 * j.it + 2, TJ)) {
      k -= min(2 * j.it + 2, TJ);
      ++j.it;
    }
    j.jt = k;
    j.row_start = k == 0;
    j.row_end = k == min(2 * j.it + 2, TJ) - 1;
  }
  return j;
}

// kFull: N 128 (8 k steps) and chunks of whole 32-row j tiles, so that
// every wgmma sequence has a fixed length: a sequence cut short by a
// runtime bound keeps its accumulators in flux between the wgmmas, and the
// compiler then orders each one after the previous (mamba2 takes kFull).
template <bool kFull>
__global__ void __launch_bounds__(kTc, 2)
ssd_scan_bf16_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_s[kStages + 1];  // tile buffers; C
  __shared__ int item_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int P = a.P, N = a.N, L = a.chunk, H = a.H;
  const int T = (L + kRows - 1) / kRows;  // row tiles of a chunk
  const int TJ = (L + kJ - 1) / kJ;       // j tiles of a chunk
  const int LP = T * kRows;
  const int nnk = kFull ? kMaxN / 16 : (N + 15) / 16;  // k steps over N
  const bool tx = a.tma_x, tbc = a.tma_bc;
  const uint32_t job_bytes = (tbc ? kBytesB : 0) + (tx ? kBytesX : 0);

  // the swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* c_s = base;                       // the C tile
  unsigned char* b_s = c_s + kBytesC;              // kStages B tiles
  unsigned char* x_s = b_s + kStages * kBytesB;    // kStages x tiles
  unsigned char* s_s = x_s + kStages * kBytesX;    // kSplit parts of S_in
  float* cum_s = reinterpret_cast<float*>(s_s + kSplit * kBytesS);
  float* dt_s = cum_s + LP;  // dt_j
  float* w_s = dt_s + LP;    // exp(cum_L - cum_j) dt_j, the S_loc weights

  // the item, from the ticket: chunk-major, so every predecessor started.
  // A buffer's mbarrier completes when its TMA bytes land (one arrival),
  // or, where tiles are staged through registers, when every thread has
  // stored and fenced its part (kTc arrivals).
  const int bh_count = a.batch * H;
  if (tid == 0) {
    item_s = atomicAdd(a.sync + bh_count, 1);
    const int jobs_arrive = tx && tbc ? 1 : kTc;
    for (int i = 0; i < kStages; ++i) tma::mbar_init(&bar_s[i], jobs_arrive);
    tma::mbar_init(&bar_s[kStages], tbc ? 1 : kTc);
    tma::mbar_init_fence();
  }
  __syncthreads();
  const int item = item_s;
  const int c = item / bh_count, bh = item - c * bh_count;
  const int bb = bh / H, hh = bh - bb * H;
  const int gg = hh / (H / a.G);
  const int64_t t0 = (int64_t)c * L;  // the chunk's first token

  const bf16* xg = static_cast<const bf16*>(a.x) + bb * a.x_sb +
                   t0 * a.x_sl + (int64_t)hh * P;
  const int64_t bc_off = bb * a.bc_sb + t0 * a.bc_sl + (int64_t)gg * N;
  const bf16* bg = static_cast<const bf16*>(a.B) + bc_off;
  const bf16* cg = static_cast<const bf16*>(a.C) + bc_off;

  int total = TJ;  // jobs of the chunk
  for (int it = 0; it < T; ++it) total += min(2 * it + 2, TJ);

  // Stage job q's B and x tiles into buffer q % kStages (called by every
  // thread, two jobs ahead: the buffer's last readers, job q - kStages's
  // products, are complete). Tiles TMA can take go as 64-column boxes; rows
  // past the chunk are the next chunk's (or zeros past l), finite and
  // weighted by 0. Tiles staged through registers are fenced for wgmma,
  // which reads shared memory as the async proxy.
  auto issue = [&](int q) {
    if (q >= total) return;
    const int j0 = job_of(q, TJ).jt * kJ, buf = q % kStages;
    unsigned char* bt = b_s + buf * kBytesB;
    unsigned char* xt = x_s + buf * kBytesX;
    if (!tbc)
      stage(bt, kRegionJ, kJ, bg + j0 * a.bc_sl, a.bc_sl, L - j0, N,
            nnk * 16);
    if (!tx)
      stage(xt, kRegionJ, kJ, xg + j0 * a.x_sl, a.x_sl, L - j0, P, kMaxP);
    if (!tbc || !tx) tma::fence_proxy_async();
    if (tid == 0) {
      const int row = (int)t0 + j0;
      tma::mbar_arrive_expect(&bar_s[buf], job_bytes);
      if (tbc) {
        tma::load_3d(bt, &a.bmap, gg * N, row, bb, &bar_s[buf]);
        tma::load_3d(bt + kRegionJ, &a.bmap, gg * N + 64, row, bb,
                     &bar_s[buf]);
      }
      if (tx) tma::load_3d(xt, &a.xmap, hh * P, row, bb, &bar_s[buf]);
    } else if (!tbc || !tx) {
      tma::mbar_arrive(&bar_s[buf]);
    }
  };
  auto tiles = [&](int q) {
    wait_tiles(&bar_s[q % kStages], (q / kStages) & 1);
  };
  // The C tile of row tile it (called by every thread once no warp reads
  // the previous one).
  auto load_c = [&](int it) {
    if (it >= T) return;
    if (tbc) {
      if (tid == 0) {
        const int row = (int)t0 + it * kRows;
        tma::mbar_arrive_expect(&bar_s[kStages], kBytesC);
        tma::load_3d(c_s, &a.cmap, gg * N, row, bb, &bar_s[kStages]);
        tma::load_3d(c_s + kRegionC, &a.cmap, gg * N + 64, row, bb,
                     &bar_s[kStages]);
      }
    } else {
      stage(c_s, kRegionC, kRows, cg + (int64_t)it * kRows * a.bc_sl,
            a.bc_sl, L - it * kRows, N, nnk * 16);
      tma::fence_proxy_async();
      tma::mbar_arrive(&bar_s[kStages]);
    }
  };
  issue(0);
  issue(1);
  load_c(0);

  const float A = a.A[hh];
  for (int i = tid; i < LP; i += kTc) {
    const float d =
        i < L ? a.dt[((int64_t)bb * a.l + t0 + i) * H + hh] : 0.f;
    dt_s[i] = d;
    cum_s[i] = d * A;
  }
  __syncthreads();
  block_cumsum(cum_s, L);
  __syncthreads();
  const float cum_last = cum_s[L - 1];
  for (int i = tid; i < LP; i += kTc)
    w_s[i] = i < L ? __expf(cum_last - cum_s[i]) * dt_s[i] : 0.f;
  __syncthreads();

  // -- S_loc = sum_j (x_j w_j)^T B_j: m64 (p) n128 (n), k = j ---------------
  // A: x^T by `ldmatrix.trans`, weighted, split; B: the B tile, transposed.
  float sacc[kMaxN / 2];  // rows 16w + g (+8), cols 8nt + 2t (+1)
#pragma unroll
  for (int i = 0; i < kMaxN / 2; ++i) sacc[i] = 0.f;
  uint32_t pa[kJ / 16][kSplit][4];  // A operands: weighted, split
  for (int q = 0; q < TJ; ++q) {
    tiles(q);
    const unsigned char* bt = b_s + (q % kStages) * kBytesB;
    const unsigned char* xt = x_s + (q % kStages) * kBytesX;
    const int j0 = q * kJ;
    const int ksteps = kFull ? kJ / 16 : min(kJ / 16, (L - j0 + 15) / 16);
#pragma unroll
    for (int kk = 0; kk < kJ / 16; ++kk) {
      uint32_t xr[4];
      ldmatrix_x4_trans(
          xr, smem_u32(xt) +
                  sw128(kk * 16 + (lane & 7) + ((lane >> 4) << 3),
                        16 * warp + ((lane >> 3) & 1) * 8));
      const float2 w0 =
          *reinterpret_cast<const float2*>(w_s + j0 + kk * 16 + 2 * t);
      const float2 w8 =
          *reinterpret_cast<const float2*>(w_s + j0 + kk * 16 + 2 * t + 8);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 xv = unpack_bf16(xr[r]);
        const float2 w = r < 2 ? w0 : w8;
        split_pack(xv.x * w.x, xv.y * w.y, r, pa[kk]);
      }
    }
    tma::fence_proxy_async();  // the x tile's reads before later TMA writes
    pin(sacc);  // every write of the operands before the fence
    pin_a(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kJ / 16; ++kk) {
      if (kk >= ksteps) break;
#pragma unroll
      for (int s = 0; s < kSplit; ++s)
        wg_n128_t(sacc, pa[kk][s], gdesc(bt + kk * 2048, kRegionJ, 1024), 1);
    }
    wg_commit();
    wg_wait();
    pin(sacc);
    pin_a(pa);
    issue(q + 2);  // job q's buffer is free
  }

  // -- the chain: wait for chunk c - 1, S_out = S_in exp(cum_L) + S_loc -----
  {
    float* st = a.state + (int64_t)bh * P * N;
    int* flag = a.sync + bh;
    float s_in[kMaxN / 2];  // S_in at the thread's S_loc positions
#pragma unroll
    for (int i = 0; i < kMaxN / 2; ++i) s_in[i] = 0.f;
    if (c > 0) {
      if (tid == 0) {
        // the predecessor has started, so it publishes within
        // microseconds; a chain still waiting after ~10 s is a fault:
        // trap (the launch's error) rather than hang the card
        for (int64_t spins = 0; ld_acquire(flag) < c; ++spins) {
          if (spins > (1ll << 27)) __trap();
          __nanosleep(64);
        }
      }
      __syncthreads();
      // every load first, so that their latencies overlap
#pragma unroll
      for (int i = 0; i < kMaxN / 2; i += 2) {
        const int p = 16 * warp + g + 8 * ((i >> 1) & 1);
        const int n = 8 * (i >> 2) + 2 * t;
        const float* sp = st + (int64_t)p * N + n;
        if (p < P && n + 1 < N && (N & 1) == 0) {
          const float2 v = __ldcg(reinterpret_cast<const float2*>(sp));
          s_in[i] = v.x;
          s_in[i + 1] = v.y;
        } else {
          if (p < P && n < N) s_in[i] = __ldcg(sp);
          if (p < P && n + 1 < N) s_in[i + 1] = __ldcg(sp + 1);
        }
      }
    }
    const float dec = __expf(cum_last);
    const bool pairs = (N & 1) == 0;  // float2 stores
#pragma unroll
    for (int i = 0; i < kMaxN / 2; i += 2) {
      const int p = 16 * warp + g + 8 * ((i >> 1) & 1);
      const int n = 8 * (i >> 2) + 2 * t;
      float* sp = st + (int64_t)p * N + n;
      const float o0 = s_in[i] * dec + sacc[i];
      const float o1 = s_in[i + 1] * dec + sacc[i + 1];
      if (pairs) {
        if (p < P && n < N)
          __stcg(reinterpret_cast<float2*>(sp), make_float2(o0, o1));
      } else {
        if (p < P && n < N) __stcg(sp, o0);
        if (p < P && n + 1 < N) __stcg(sp + 1, o1);
      }
      if (c > 0) {
        uint32_t parts[kSplit][4];
        split_pack(s_in[i], s_in[i + 1], 0, parts);
#pragma unroll
        for (int s = 0; s < kSplit; ++s)
          *reinterpret_cast<uint32_t*>(s_s + s * kBytesS +
                                       (n >> 6) * kRegionC +
                                       sw128(p, n & 63)) = parts[s][0];
      }
    }
    tma::fence_proxy_async();  // the parts are read by wgmma (async proxy)
    __syncthreads();  // every S_out write is ordered before the release:
    if (tid == 0) {   // the barrier, then a gpu-scope fence and the flag
      __threadfence();
      st_release(flag, c + 1);
    }
  }

  // -- y, row tile by row tile: exp(cum_i) C_i S_in^T + the masked scores
  //    times x over the j tiles up to the diagonal; written once -----------
  float yacc[kMaxP / 2];  // rows i0 + 16w + g (+8), cols 8nt + 2t (+1)
#pragma unroll
  for (int i = 0; i < kMaxP / 2; ++i) yacc[i] = 0.f;
  float sc[kJ / 2];  // the scores of a job
  uint32_t cf[kMaxN / 16][4];  // the row tile's C fragments (A operand)
  float cum_a = 0.f, cum_b = 0.f;
  for (int q = TJ; q < total; ++q) {
    const Job jb = job_of(q, TJ);
    const int it = jb.it, i0 = it * kRows, j0 = jb.jt * kJ;
    const int ia = i0 + 16 * warp + g, ib = ia + 8;  // rows in the chunk
    if (jb.row_start) {
      // the row tile's C fragments, then the next row tile's C tile
      wait_tiles(&bar_s[kStages], it & 1);
#pragma unroll
      for (int ks = 0; ks < kMaxN / 16; ++ks)
        ldmatrix_x4(cf[ks], smem_u32(c_s) + (ks >> 2) * kRegionC +
                                sw128(16 * warp + (lane & 15),
                                      (ks & 3) * 16 + (lane >> 4) * 8));
      tma::fence_proxy_async();  // the reads before the next TMA writes
      __syncthreads();
      load_c(it + 1);
      cum_a = cum_s[ia];
      cum_b = cum_s[ib];
      if (c > 0) {
        // exp(cum_i) C_i S_in^T (m64 n64, k = n; B: the parts of S_in)
        pin(yacc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < kMaxN / 16; ++ks) {
          if (ks >= nnk) break;
#pragma unroll
          for (int s = 0; s < kSplit; ++s)
            wg_n64(yacc, cf[ks],
                   gdesc(s_s + s * kBytesS + (ks >> 2) * kRegionC +
                             (ks & 3) * 32, 16, 1024),
                   ks + s > 0);
        }
        wg_commit();
        wg_wait();
        pin(yacc);
        const float ea = __expf(cum_a), eb = __expf(cum_b);
#pragma unroll
        for (int i = 0; i < kMaxP / 2; i += 4) {
          yacc[i] *= ea;
          yacc[i + 1] *= ea;
          yacc[i + 2] *= eb;
          yacc[i + 3] *= eb;
        }
      }
    }

    // scores C_i B_j^T (m64 n32, k = n; A: the row tile's C fragments):
    // exact bf16 products
    tiles(q);
    const unsigned char* bt = b_s + (q % kStages) * kBytesB;
    pin(sc);
    pin(yacc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      if (ks >= nnk) break;
      wg_n32(sc, cf[ks],
             gdesc(bt + (ks >> 2) * kRegionJ + (ks & 3) * 32, 16, 1024),
             ks > 0);
    }
    wg_commit();
    wg_wait();  // also job q - 1's product with x: yacc is settled
    pin(sc);
    pin(yacc);
    pin_a(pa);
    issue(q + 2);  // job q - 1's tiles are free

    // y += (scores o exp(cum_i - cum_j) dt_j) x_j: the weighted scores,
    // split, are the A operand (m64 n64, k = j); B: the x tile, transposed
    const unsigned char* xt = x_s + (q % kStages) * kBytesX;
    const int ksteps = kFull ? kJ / 16 : min(kJ / 16, (L - j0 + 15) / 16);
    // below the diagonal (every j before every row of the tile, in a full
    // tile) no weight is masked, and row b's weights are row a's times
    // exp(cum_b - cum_a) <= 1 (j <= a: no factor can overflow)
    const bool below = j0 + kJ <= i0 && i0 + kRows <= L;
    const float eba = __expf(cum_b - cum_a);
#pragma unroll
    for (int kk = 0; kk < kJ / 16; ++kk) {
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int i = 8 * kk + 4 * hlf;  // sc index of n-tile 2 kk + hlf
        const int j = j0 + 16 * kk + 8 * hlf + 2 * t;
        const float2 cj = *reinterpret_cast<const float2*>(cum_s + j);
        const float2 dj = *reinterpret_cast<const float2*>(dt_s + j);
        float wa0, wa1, wb0, wb1;
        if (below) {
          wa0 = __expf(cum_a - cj.x) * dj.x;
          wa1 = __expf(cum_a - cj.y) * dj.y;
          wb0 = wa0 * eba;
          wb1 = wa1 * eba;
        } else {
          wa0 = (j <= ia && ia < L) ? __expf(cum_a - cj.x) * dj.x : 0.f;
          wa1 = (j + 1 <= ia && ia < L) ? __expf(cum_a - cj.y) * dj.y : 0.f;
          wb0 = (j <= ib && ib < L) ? __expf(cum_b - cj.x) * dj.x : 0.f;
          wb1 = (j + 1 <= ib && ib < L) ? __expf(cum_b - cj.y) * dj.y : 0.f;
        }
        split_pack(sc[i] * wa0, sc[i + 1] * wa1, 2 * hlf, pa[kk]);
        split_pack(sc[i + 2] * wb0, sc[i + 3] * wb1, 2 * hlf + 1, pa[kk]);
      }
    }
    pin(yacc);
    pin_a(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kJ / 16; ++kk) {
      if (kk >= ksteps) break;
#pragma unroll
      for (int s = 0; s < kSplit; ++s)
        wg_n64_t(yacc, pa[kk][s], gdesc(xt + kk * 2048, kRegionJ, 1024), 1);
    }
    wg_commit();

    if (jb.row_end) {
      // the row tile is complete: write y once
      wg_wait();
      pin(yacc);
      pin_a(pa);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? ib : ia;
        if (i >= L) continue;
        float* yr = a.y + ((((int64_t)bb * a.l + t0 + i) * H + hh) * P);
#pragma unroll
        for (int nt = 0; nt < kMaxP / 8; ++nt) {
          const int p = 8 * nt + 2 * t;
          const float v0 = yacc[4 * nt + 2 * half];
          const float v1 = yacc[4 * nt + 2 * half + 1];
          if ((P & 1) == 0) {
            if (p < P) __stcs(reinterpret_cast<float2*>(yr + p),
                              make_float2(v0, v1));
          } else {
            if (p < P) __stcs(yr + p, v0);
            if (p + 1 < P) __stcs(yr + p + 1, v1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxP / 2; ++i) yacc[i] = 0.f;
    }
  }
  wg_wait();
  pin_a(pa);
}

int launch_bf16(Args a, cudaStream_t stream) {
  // TMA boxes where the layout takes them: base, row strides and each
  // box's start 16-byte aligned (a head's x at h * P: P a multiple of 8);
  // B / C also need every column a k step reads past N to be zero (one
  // group: past the map's edge) or in range (N a multiple of 16). A layout
  // that qualifies but does not encode is an error, not a slower path.
  const auto al16 = [](const void* p, int64_t s_b, int64_t s_l, int batch) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s_l * 2) % 16 == 0 &&
           (batch == 1 || (s_b * 2) % 16 == 0);
  };
  a.tma_x = al16(a.x, a.x_sb, a.x_sl, a.batch) && a.P % 8 == 0;
  a.tma_bc = al16(a.B, a.bc_sb, a.bc_sl, a.batch) &&
             al16(a.C, a.bc_sb, a.bc_sl, a.batch) &&
             (a.G == 1 || a.N % 16 == 0);
  const int64_t x_sb = a.batch == 1 ? (int64_t)a.l * a.x_sl : a.x_sb;
  const int64_t bc_sb = a.batch == 1 ? (int64_t)a.l * a.bc_sl : a.bc_sb;
  // tensor maps of x (H*P, l, b) and B, C (G*N, l, b): 64-column boxes
  // that land 128-byte swizzled; columns and rows past the edges read as 0
  const auto encode = [&](CUtensorMap* map, const void* base, int dim0,
                          int64_t s_l, int64_t s_b, int rows) {
    return tma::encode_pool(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            dim0, a.l, a.batch, s_l, s_b, 64, rows,
                            CU_TENSOR_MAP_SWIZZLE_128B);
  };
  int e = 0;
  if (a.tma_x) e = encode(&a.xmap, a.x, a.H * a.P, a.x_sl, x_sb, kJ);
  if (e == 0 && a.tma_bc)
    e = encode(&a.bmap, a.B, a.G * a.N, a.bc_sl, bc_sb, kJ);
  if (e == 0 && a.tma_bc)
    e = encode(&a.cmap, a.C, a.G * a.N, a.bc_sl, bc_sb, kRows);
  if (e) return e;
  const int T = (a.chunk + kRows - 1) / kRows;
  const size_t smem = 1024 + kBytesC + kStages * (kBytesB + kBytesX) +
                      kSplit * kBytesS + sizeof(float) * 3 * (size_t)T * kRows;
  const bool full = a.N == kMaxN && a.chunk % kJ == 0;
  const void* kernel = full ? (const void*)ssd_scan_bf16_kernel<true>
                            : (const void*)ssd_scan_bf16_kernel<false>;
  e = tma::allow_smem(kernel, smem);
  if (e != 0) return e;
  const int64_t items = (int64_t)a.batch * (a.l / a.chunk) * a.H;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (full)
    ssd_scan_bf16_kernel<true><<<(unsigned)items, kTc, smem, stream>>>(a);
  else
    ssd_scan_bf16_kernel<false><<<(unsigned)items, kTc, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of x, B and C: 0 = float32, 1 = bfloat16. Requires P <= 64,
// N <= 128, H % G == 0 and l % chunk == 0 (the wrapper checks). `sync`:
// for bfloat16, batch * H + 1 int32 zeros (chain flags and the ticket);
// unused for float32. Returns a cudaError_t (0 = launched).
int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                 const void* B, const void* C, float* y, float* state,
                 int* sync, int batch, int l, int H, int P, int G, int N,
                 int chunk, int64_t x_sb, int64_t x_sl, int64_t bc_sb,
                 int64_t bc_sl, int dtype, void* stream) {
  if (P > kMaxP || N > kMaxN || G < 1 || H % G || chunk < 1 || l % chunk)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.dt = dt; a.A = A; a.B = B; a.C = C; a.y = y; a.state = state;
  a.sync = sync;
  a.batch = batch; a.l = l; a.H = H; a.P = P; a.G = G; a.N = N;
  a.chunk = chunk;
  a.x_sb = x_sb; a.x_sl = x_sl; a.bc_sb = bc_sb; a.bc_sl = bc_sl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(a, s);
  if (dtype == 1) {
    if (sync == nullptr) return (int)cudaErrorInvalidValue;
    return launch_bf16(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return tma::error_string(err);
}

}  // extern "C"
