// Mamba2 SSD chunked scan, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` in src/repro/kernels/ssd_scan.py
// (body `_ssd_kernel`). For each (sequence b, head h) and each chunk of L
// tokens, with cum = the in-chunk inclusive cumulative sum of dt * A_h:
//   y_i  = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
//        + exp(cum_i) C_i S^T                       (the incoming state)
//   S'   = S exp(cum_L) + sum_j exp(cum_L - cum_j) xdt_j^T B_j
// where xdt_j = x_j * dt_j and S is the (P, N) state carried from chunk to
// chunk. y and the final state are float32. Head h reads B/C group
// h / (H / G).
//
// What bounds it on this card: at mamba2-1.3b's widths (P 64, N 128, L 256)
// the kernel moves ~112 MB for b 4, l 1024, h 64 (x and B/C read once, y
// and the state written once: ~33 us at 3.35 TB/s) and does ~21 GFLOP of
// useful products (~22 us on bf16 tensor cores; ~0.3 ms on float32 CUDA
// cores, which this first version uses). So the design target is bytes;
// what limits this simple version is not measured, and its float32 FMAs
// from shared memory are the likely limit.
//
// What the design does: the TPU grid walks chunks as a sequential
// ("arbitrary") axis with the state in VMEM. Here one block per (b, h)
// walks its chunks in order and keeps the state in shared memory. The
// chunk's L x L score matrix (256 KB in float32 at L 256) does not fit in
// shared memory, so it is tiled by 64-row tiles of i and 64-column tiles
// of j, and only the tiles with j <= i are computed. exp(cum_i - cum_j) is
// a difference of cumulative sums, as the TPU kernel computes it; the
// cumulative sum is a block scan (32 lanes, each a serial segment, then a
// warp scan of the segment totals). The state update runs inside the last
// row tile, whose j loop visits every column tile. Each thread keeps a 4 x
// 4 tile of y, a 4 x 4 tile of scores and a 4 x 8 tile of the state update
// in registers. Every loop over P and N is bounded by the runtime sizes, so
// mamba2's P 64 / N 128 and hymba's P 50 / N 16 both work (P <= 64,
// N <= 128). Simple first: no tensor cores, no TMA, float32 tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kT = 64;         // rows of an i tile and of a j tile
constexpr int kMaxP = 64;      // y tile: rows ty + 16a, cols tx + 16b
constexpr int kMaxN = 128;     // state update: p = ty + 16a, n = tx + 16b
constexpr int kPC = kMaxP / 16;
constexpr int kNC = kMaxN / 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Args {
  const void* x;    // element (b, t, h, p) at b*x_sb + t*x_sl + h*P + p
  const float* dt;  // (b, l, h), contiguous
  const float* A;   // (h,)
  const void* B;    // element (b, t, g, n) at b*bc_sb + t*bc_sl + g*N + n
  const void* C;    //   (the same strides for B and C)
  float* y;         // (b, l, h, p), contiguous
  float* state;     // (b, h, p, n), contiguous
  int l, H, P, G, N, chunk;
  int64_t x_sb, x_sl, bc_sb, bc_sl;
};

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Args a) {
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

  const T* xg = static_cast<const T*>(a.x) + bb * a.x_sb + (int64_t)hh * P;
  const T* bg = static_cast<const T*>(a.B) + bb * a.bc_sb + (int64_t)gg * N;
  const T* cg = static_cast<const T*>(a.C) + bb * a.bc_sb + (int64_t)gg * N;
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
            ? to_f32(cg[(int64_t)(base + i0 + i) * a.bc_sl + n]) : 0.f;
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
              ? to_f32(bg[(int64_t)(base + j0 + j) * a.bc_sl + n]) : 0.f;
        }
        for (int e = tid; e < kT * P; e += kThreads) {
          const int j = e / P, p = e - j * P;
          x_s[e] = (j0 + j < L)
              ? to_f32(xg[(int64_t)(base + j0 + j) * a.x_sl + p]) *
                    dt_s[j0 + j]
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

template <typename T>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)a.P * (a.N + 1) + 2 * (size_t)kT * (a.N + 1) +
       (size_t)kT * a.P + (size_t)kT * (kT + 1) + 2 * (size_t)a.chunk);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(a.H, batch);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of x, B and C: 0 = float32, 1 = bfloat16. Requires P <= 64,
// N <= 128, H % G == 0 and l % chunk == 0 (the wrapper checks). Returns a
// cudaError_t (0 = launched).
int ssd_scan_fwd(const void* x, const float* dt, const float* A,
                 const void* B, const void* C, float* y, float* state,
                 int batch, int l, int H, int P, int G, int N, int chunk,
                 int64_t x_sb, int64_t x_sl, int64_t bc_sb, int64_t bc_sl,
                 int dtype, void* stream) {
  if (P > kMaxP || N > kMaxN || G < 1 || H % G || chunk < 1 || l % chunk)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.dt = dt; a.A = A; a.B = B; a.C = C; a.y = y; a.state = state;
  a.l = l; a.H = H; a.P = P; a.G = G; a.N = N; a.chunk = chunk;
  a.x_sb = x_sb; a.x_sl = x_sl; a.bc_sb = bc_sb; a.bc_sl = bc_sl;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, batch, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
