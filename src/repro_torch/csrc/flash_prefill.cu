// Prefill attention (flash-attention forward), hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_prefill` in
// src/repro/kernels/flash_prefill.py (body `_flash_kernel`): causal or
// non-causal attention of (B, S, H, Dh) queries over (B, Skv, Hkv, Dh)
// keys and values, GQA (G = H / Hkv query heads share one KV head), with
// an optional sliding window (key k is valid for a query at position q iff
// k <= q when causal, and k > q - window). One kernel body, two entry
// points, and the numerics are a template parameter chosen by the entry
// point:
//  * flash_prefill_contiguous: the TPU kernel's function on contiguous
//    K/V, queries at positions 0..S-1, float32 math on the inputs as they
//    are, unrounded probabilities.
//  * flash_prefill_paged: one prefill chunk of the serving engine. Its S
//    queries sit at absolute positions q_offset..q_offset+S-1 and attend
//    causally over K/V read in place from a strided per-layer pool slice
//    through the chunk's int32 page ids (position k is token k % ps of
//    page ids[k / ps]). Its numerics are those of the port's
//    `blockwise_attention` (the XLA twin the engine ran before): q, k, v
//    and the *normalised* probabilities are rounded to bfloat16,
//    accumulation is float32.
// Rounding normalised probabilities rules out a one-pass online softmax,
// so both entry points make two passes over the keys: pass 1 takes each
// row's max m and sum l = sum exp(s - m) over the valid keys (each thread
// keeps a running pair over the keys it scores, and the 16 lanes sharing a
// row merge theirs by shuffles); pass 2 forms p = exp(s - m) / max(l,
// 1e-9), rounds it under the engine's numerics, and accumulates p v. A row
// with no valid key returns zeros, as the TPU kernel does.
//
// What bounds it on this card: operations. A 512-query chunk of
// h2o-danube (H 32, Hkv 8, Dh 80) over ~770 valid keys per query is ~4
// GFLOP against ~8 MB of q, K/V and output: ~500 operations per byte, above
// the ~295 at which an H100's bf16 tensor cores become the limit.
//
// What the design does: one block per (64 / G query positions x the G
// heads of one KV head, a 64-row tile), so each K/V tile staged in shared
// memory serves all G heads. It walks only the key tiles the tile's rows
// can see (from the window's start to the causal end). Each of the 256
// threads computes a 4 x 4 tile of scores and a 4 x (Dh / 16) tile of the
// output in registers, from float32 tiles in shared memory padded to
// Dh + 1 so that lanes reading a column hit distinct banks. head_dim need
// not be a power of two (80 for danube): every loop over it is bounded by
// Dh <= 128. Simple first: float32 CUDA cores, no tensor cores, no TMA,
// scores computed twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kRows = 64;      // query rows (position x head) per block
constexpr int kKeys = 64;      // keys per tile
constexpr int kMaxDh = 128;
constexpr int kDC = kMaxDh / 16;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

struct Args {
  const void* q;         // (B, S, H, Dh), contiguous
  const void* k;         // contiguous entry: (b, pos, h, d) at
  const void* v;         //   b*sb + pos*st + h*sh + d; paged entry:
  const int32_t* pages;  //   pages[pos / ps]*sp + (pos % ps)*st + h*sh + d
  void* out;             // (B, S, H, Dh), contiguous
  int S, H, Hkv, Dh, page_size, q_offset, kv_len, window;
  bool causal;
  int64_t k_sb, k_sp, k_st, k_sh, v_sb, v_sp, v_st, v_sh;
  float scale;
};

template <bool kPaged>
__device__ __forceinline__ int64_t kv_offset(const Args& a, int b, int pos,
                                             int64_t sb, int64_t sp,
                                             int64_t st) {
  if (kPaged) {
    return (int64_t)a.pages[pos / a.page_size] * sp +
           (int64_t)(pos % a.page_size) * st;
  }
  return (int64_t)b * sb + (int64_t)pos * st;
}

// kPaged selects the engine entry point: paged K/V addressing and the
// bf16-rounded numerics of blockwise_attention.
template <typename T, bool kPaged>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const Args a) {
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
    if (r < R && q0 + i < a.S) {
      val = to_f32(qg[(((int64_t)b * a.S + q0 + i) * a.H + kvh * G + g) *
                          Dh + d]);
      if (kPaged) val = round_bf16(val);
    }
    q_s[r * DhP + d] = val;
  }

  int qpos[4];
  bool row_ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = ty + 16 * j, i = r / G;
    row_ok[j] = r < R && q0 + i < a.S;
    qpos[j] = a.q_offset + q0 + i;
  }
  const int qmin = a.q_offset + q0;
  const int qmax = a.q_offset + min(q0 + BQ, a.S) - 1;
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
  auto stage = [&](const T* src, float* dst, int stride, int kb,
                   int64_t sb, int64_t sp, int64_t st) {
    for (int e = tid; e < kKeys * Dh; e += kThreads) {
      const int t = e / Dh, d = e - t * Dh, pos = kb + t;
      float val = 0.f;
      if (pos < k_hi) {
        val = to_f32(src[kv_offset<kPaged>(a, b, pos, sb, sp, st) + d]);
        if (kPaged) val = round_bf16(val);
      }
      dst[t * stride + d] = val;
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
    stage(kg, k_s, DhP, kb, a.k_sb, a.k_sp, a.k_st);
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
    stage(kg, k_s, DhP, kb, a.k_sb, a.k_sp, a.k_st);
    stage(vg, v_s, Dh, kb, a.v_sb, a.v_sp, a.v_st);
    __syncthreads();
    float s[4][4];
    scores(s);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = 0.f;
        if (valid(j, kb + tx + 16 * c)) {
          p = expf(s[j][c] - m[j]) / l[j];
          if (kPaged) p = round_bf16(p);
        }
        p_s[(ty + 16 * j) * (kKeys + 1) + tx + 16 * c] = p;
      }
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

template <typename T, bool kPaged>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)(kRows + kKeys) * (a.Dh + 1) + (size_t)kKeys * a.Dh +
       (size_t)kRows * (kKeys + 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<T, kPaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int bq = kRows / (a.H / a.Hkv);
  dim3 grid((a.S + bq - 1) / bq, a.Hkv, B);
  flash_prefill_kernel<T, kPaged><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kPaged>
int dispatch(const Args& a, int B, int dtype, void* stream) {
  const int G = a.Hkv > 0 ? a.H / a.Hkv : 0;
  if (G < 1 || G > kRows || a.H % a.Hkv || a.Dh < 1 || a.Dh > kMaxDh)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, kPaged>(a, B, s);
  if (dtype == 1) return launch<__nv_bfloat16, kPaged>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output share it).
// window <= 0 means no window. Each returns a cudaError_t (0 = launched).

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
  return dispatch<false>(a, B, dtype, stream);
}

// One engine prefill chunk: q (1, S, H, Dh) contiguous at positions
// q_offset..q_offset+S-1; K/V of context position k at
// pages[k / ps]*sp + (k % ps)*st + h*sh + d; causal over kv_len =
// q_offset + S keys.
int flash_prefill_paged(const void* q, const void* k_pool,
                        const void* v_pool, const int32_t* pages, void* out,
                        int S, int H, int Hkv, int Dh, int page_size,
                        int q_offset, int window, int64_t k_sp, int64_t k_st,
                        int64_t k_sh, int64_t v_sp, int64_t v_st,
                        int64_t v_sh, float scale, int dtype, void* stream) {
  Args a = {};
  a.q = q; a.k = k_pool; a.v = v_pool; a.pages = pages; a.out = out;
  a.S = S; a.H = H; a.Hkv = Hkv; a.Dh = Dh; a.page_size = page_size;
  a.q_offset = q_offset; a.kv_len = q_offset + S; a.window = window;
  a.causal = true;
  a.k_sp = k_sp; a.k_st = k_st; a.k_sh = k_sh;
  a.v_sp = v_sp; a.v_st = v_st; a.v_sh = v_sh;
  a.scale = scale;
  return dispatch<true>(a, 1, dtype, stream);
}

const char* flash_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
