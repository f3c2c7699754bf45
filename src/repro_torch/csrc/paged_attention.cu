// Decode attention over a paged KV cache, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_attention` in
// src/repro/kernels/paged_attention.py (body `_paged_attn_kernel`): one
// query token per sequence attends over K/V pages reached through a block
// table, with an online softmax, an optional sliding window (valid key
// positions satisfy pos > ctx - 1 - window) and optional (m, l) partials for
// a DistAttention merge. Rows with ctx_len == 0 return zeros, m = -1e30 and
// l = 0, as the Pallas kernel does.
//
// What bounds it on this card: bytes. Each query token's G = H / Hkv heads
// share one KV head, so the kernel does about 4 * G flops per K/V element it
// reads: far below the ~295 flops/byte an H100 needs before its compute is
// the limit. The least time is the K/V bytes of the valid positions (plus q
// and the output) over the 3.35 TB/s of device memory.
//
// What the design does about it: one block per (sequence, KV head) loads
// that head's K/V exactly once, for all G query heads together, and keeps
// the G heads' running max, sum and accumulator in shared memory across the
// whole context (the TPU grid instead walks pages as a sequential grid axis
// that carries a VMEM accumulator). The block reads its own block-table
// entries, walks the context in tiles of whole pages, and skips the pages
// that lie entirely before the sliding window. Pools are read through their
// page / token / head strides, so a per-layer slice of a (L, P+1, ps, Hkv,
// Dh) pool, or any strided view with a unit head_dim stride, is read in
// place. head_dim need not be a power of two: every loop over it is bounded
// by Dh (80 for h2o-danube), and the K tile's rows are padded to Dh + 1
// floats so that lanes reading one column of it hit distinct banks.
// Simple first: no tensor cores, no TMA, no vector loads, no split of a long
// context over several blocks yet, and each tile's online-softmax update
// runs on G of the block's threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kTileTokens = 64;    // K/V tokens staged per step (whole pages)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* q;               // (B, H, Dh), contiguous
  const void* k;               // page p, token t, head h, dim d at
  const void* v;               //   p*sp + t*st + h*sh + d
  const int32_t* block_tables; // (B, n) with row stride bt_sb
  const int32_t* context_lens; // (B,)
  void* out;                   // (B, H, Dh), contiguous
  float* m_out;                // (B, H) or null
  float* l_out;                // (B, H) or null
  int H, Hkv, Dh, page_size, tile, window;
  int64_t k_sp, k_st, k_sh, v_sp, v_st, v_sh, bt_sb;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Args a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kvh = blockIdx.y, tid = threadIdx.x;
  const int G = a.H / a.Hkv, Dh = a.Dh, DhP = Dh + 1, TILE = a.tile;
  float* q_s = smem;              // G x Dh
  float* acc_s = q_s + G * Dh;    // G x Dh
  float* k_s = acc_s + G * Dh;    // TILE x DhP
  float* v_s = k_s + TILE * DhP;  // TILE x Dh
  float* p_s = v_s + TILE * Dh;   // G x TILE: scores, then probabilities
  float* m_s = p_s + G * TILE;    // G running max
  float* l_s = m_s + G;           // G running sum of exp
  float* alpha_s = l_s + G;       // G rescale factor of the current tile

  const int64_t row0 = (int64_t)b * a.H + (int64_t)kvh * G;
  const T* q = static_cast<const T*>(a.q) + row0 * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) {
    q_s[i] = to_f32(q[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int ctx = a.context_lens[b];
  const int lo = a.window > 0 ? max(0, ctx - a.window) : 0;  // first valid
  const int start = (lo / a.page_size) * a.page_size;
  const int32_t* bt = a.block_tables + (int64_t)b * a.bt_sb;
  const T* kb = static_cast<const T*>(a.k) + (int64_t)kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + (int64_t)kvh * a.v_sh;
  __syncthreads();

  for (int base = start; base < ctx; base += TILE) {
    // stage the tile's K/V for this head (zeros past the context)
    for (int i = tid; i < TILE * Dh; i += kThreads) {
      const int t = i / Dh, d = i - t * Dh, pos = base + t;
      float kv = 0.f, vv = 0.f;
      if (pos < ctx) {
        const int64_t page = bt[pos / a.page_size];
        const int64_t off = pos % a.page_size;
        kv = to_f32(kb[page * a.k_sp + off * a.k_st + d]);
        vv = to_f32(vb[page * a.v_sp + off * a.v_st + d]);
      }
      k_s[t * DhP + d] = kv;
      v_s[t * Dh + d] = vv;
    }
    __syncthreads();
    // scores of the G heads against the tile's tokens
    for (int i = tid; i < G * TILE; i += kThreads) {
      const int g = i / TILE, t = i - g * TILE, pos = base + t;
      float s = kNegInf;
      if (pos >= lo && pos < ctx) {
        const float* qr = q_s + g * Dh;
        const float* kr = k_s + t * DhP;
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * a.scale;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // online softmax: one thread per head
    for (int g = tid; g < G; g += kThreads) {
      float* pr = p_s + g * TILE;
      float mc = kNegInf;
      for (int t = 0; t < TILE; ++t) mc = fmaxf(mc, pr[t]);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mc);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < TILE; ++t) {
        const int pos = base + t;
        const float e = (pos >= lo && pos < ctx) ? expf(pr[t] - m_new) : 0.f;
        pr[t] = e;
        sum += e;
      }
      m_s[g] = m_new;
      l_s[g] = l_s[g] * alpha + sum;
      alpha_s[g] = alpha;
    }
    __syncthreads();
    // rescale the accumulator and add p @ v; each (g, d) has one owner
    for (int i = tid; i < G * Dh; i += kThreads) {
      const int g = i / Dh, d = i - g * Dh;
      const float* pr = p_s + g * TILE;
      float acc = acc_s[i] * alpha_s[g];
      for (int t = 0; t < TILE; ++t) acc = fmaf(pr[t], v_s[t * Dh + d], acc);
      acc_s[i] = acc;
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(a.out) + row0 * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) {
    store_f32(out + i, acc_s[i] / fmaxf(l_s[i / Dh], 1e-9f));
  }
  if (a.m_out != nullptr) {
    for (int g = tid; g < G; g += kThreads) {
      a.m_out[row0 + g] = m_s[g];
      a.l_out[row0 + g] = l_s[g];
    }
  }
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  const size_t smem = sizeof(float) *
      (2 * (size_t)G * a.Dh + (size_t)a.tile * (a.Dh + 1) +
       (size_t)a.tile * a.Dh + (size_t)G * a.tile + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, a.Hkv);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, the pools and the output share it).
// window <= 0 means no window. m_out / l_out may both be null. Returns a
// cudaError_t (0 = launched).
int paged_attention_fwd(const void* q, const void* k, const void* v,
                        const int32_t* block_tables,
                        const int32_t* context_lens, void* out, float* m_out,
                        float* l_out, int B, int H, int Hkv, int Dh,
                        int page_size, int64_t k_sp, int64_t k_st,
                        int64_t k_sh, int64_t v_sp, int64_t v_st,
                        int64_t v_sh, int64_t bt_sb, int window, float scale,
                        int dtype, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.block_tables = block_tables; a.context_lens = context_lens;
  a.out = out; a.m_out = m_out; a.l_out = l_out;
  a.H = H; a.Hkv = Hkv; a.Dh = Dh; a.page_size = page_size;
  a.tile = page_size >= kTileTokens
               ? page_size : (kTileTokens / page_size) * page_size;
  a.window = window;
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
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
