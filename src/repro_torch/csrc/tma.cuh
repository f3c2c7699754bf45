// Hopper asynchronous-copy plumbing shared by the kernels
// (paged_attention.cu, flash_prefill.cu, ssd_scan.cu): mbarriers, TMA
// tensor loads of a paged KV pool or any 3-D tensor, and the host side of
// both. The host helpers cache what does not change from call to call
// (tensor maps, the shared-memory attribute, the SM count), because a
// decode step calls a kernel once per layer and the host's cost per call
// sets the pace of an eager engine.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <mutex>

namespace tma {

// -- device side ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// an mbarrier in shared memory: a phase completes when `count` threads have
// arrived and the bytes announced with the arrivals have landed
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
// make the initialised mbarriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// the same, for waits that end within microseconds when the kernel is
// right: a phase still incomplete after ~16 M polls is a fault, and the
// thread traps (the launch's error) rather than hang the card
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  uint32_t parity) {
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
// order this thread's generic-proxy shared-memory accesses before later
// async-proxy (TMA) writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// one box of a 3-D tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void load_3d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// one box of a 4-D tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void load_4d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, int c3,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// -- host side --------------------------------------------------------------

// Errors of the host helpers that are not a cudaError_t: kEncodeError + the
// CUresult of cuTensorMapEncodeTiled (CUDA_ERROR_NOT_FOUND when libcuda
// has no such entry point).
constexpr int kEncodeError = 1 << 20;
inline const char* error_string(int err) {
  if (err >= kEncodeError)
    return "cuTensorMapEncodeTiled failed (the code less 1 << 20 is its "
           "CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The widest box a tensor map takes, in elements, in each dimension.
constexpr int kMaxBox = 256;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A tensor of `rank` (<= 5) dimensions, dims[0] innermost and contiguous,
// strides[i] the elements between neighbours along dims[i + 1]; one box is
// box[0] x ... elements, landing as rows of box[0] elements in the
// `swizzle` layout (zeros where it reaches past a dimension).
// Writes the map to *map and returns 0, or kEncodeError + the CUresult.
// The maps are cached, keyed on everything they encode: an engine's
// per-layer pools are the same few slices call after call.
inline int encode_tiled(CUtensorMap* map, const void* base,
                        CUtensorMapDataType type, int esz, int rank,
                        const int64_t* dims, const int64_t* strides,
                        const int* box,
                        CUtensorMapSwizzle swizzle =
                            CU_TENSOR_MAP_SWIZZLE_NONE) {
  static const EncodeTiled encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<EncodeTiled>(fn);
  }();
  if (encode == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  if (rank < 1 || rank > 5)
    return kEncodeError + (int)CUDA_ERROR_INVALID_VALUE;

  struct Key {
    const void* base;
    uint64_t dims[5], strides[4];
    uint32_t box[5];
    int rank, type, swizzle;
  };
  struct Slot {
    Key key;
    CUtensorMap map;
    bool used;
  };
  constexpr int kSlots = 256, kProbe = 4;
  static std::mutex mu;
  static Slot slots[kSlots];
  Key key;
  memset(&key, 0, sizeof key);  // the padding takes part in the compare
  key.base = base;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = (uint64_t)dims[i];
    key.box[i] = (uint32_t)box[i];
    if (i + 1 < rank) key.strides[i] = (uint64_t)(strides[i] * esz);
  }
  key.rank = rank;
  key.type = (int)type;
  key.swizzle = (int)swizzle;
  uint64_t h = 1469598103934665603ull;  // FNV-1a over the key's bytes
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(&key);
  for (size_t i = 0; i < sizeof key; ++i) h = (h ^ kb[i]) * 1099511628211ull;
  const int home = (int)(h % kSlots);

  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < kProbe; ++i) {
    Slot& s = slots[(home + i) % kSlots];
    if (s.used && memcmp(&s.key, &key, sizeof key) == 0) {
      *map = s.map;
      return 0;
    }
  }
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      encode(map, type, (cuuint32_t)rank, const_cast<void*>(base),
             key.dims, key.strides, key.box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  int dst = home;  // a free slot of the probe run, else the home slot
  for (int i = 0; i < kProbe; ++i)
    if (!slots[(home + i) % kSlots].used) {
      dst = (home + i) % kSlots;
      break;
    }
  memcpy(&slots[dst].key, &key, sizeof key);
  slots[dst].map = *map;
  slots[dst].used = true;
  return 0;
}

// The pool slice (P, ps, Hkv, Dh), heads contiguous, seen by TMA as a 3-D
// tensor (Hkv * Dh, ps, P); one box is box_w elements x box_t tokens of one
// page, landing as box_t rows of box_w elements. A box that starts at head h
// reads box_w - Dh elements of head h + 1 (zeros past the last head).
// Any (dim0, rows, count) tensor with row stride st and count stride sp
// (elements) takes the same map; `swizzle` sets the layout a box lands in
// (ssd_scan's tiles land 128-byte swizzled, for wgmma).
inline int encode_pool(
    CUtensorMap* map, const void* base, CUtensorMapDataType type, int esz,
    int hkv_dh, int ps, int pages, int64_t st, int64_t sp, int box_w,
    int box_t, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const int64_t dims[3] = {hkv_dh, ps, pages}, strides[2] = {st, sp};
  const int box[3] = {box_w, box_t, 1};
  return encode_tiled(map, base, type, esz, 3, dims, strides, box, swizzle);
}

constexpr int kMaxDevices = 64;

// Let `kernel` take `smem` bytes of dynamic shared memory on the current
// device. cudaFuncSetAttribute is called only when the kernel needs more
// than it was last given there.
inline int allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  struct Entry {
    const void* kernel;
    size_t smem[kMaxDevices];
  };
  constexpr int kEntries = 64;
  static std::mutex mu;
  static Entry table[kEntries];
  static int used = 0;
  std::lock_guard<std::mutex> lock(mu);
  Entry* hit = nullptr;
  for (int i = 0; i < used && hit == nullptr; ++i)
    if (table[i].kernel == kernel) hit = &table[i];
  if (hit != nullptr && hit->smem[dev] >= smem) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (hit == nullptr && used < kEntries) {
    hit = &table[used++];
    memset(hit, 0, sizeof *hit);
    hit->kernel = kernel;
  }
  if (hit != nullptr) hit->smem[dev] = smem;
  return 0;
}

// The current device's SM count, read once per device.
inline int sm_count(int* nsm) {
  static std::atomic<int> cache[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int n = cache[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    cache[dev].store(n, std::memory_order_relaxed);
  }
  *nsm = n;
  return 0;
}

}  // namespace tma
