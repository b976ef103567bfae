// Row RMSNorm for Hopper (sm_90a): one pass over x, 16-byte accesses.
//
// Replaces src/repro/kernels/rmsnorm.py:rmsnorm (Pallas TPU kernel, body
// _rmsnorm_kernel) and computes what it computes, for each row of x
// (N, D):
//     inv = 1 / sqrt(mean(x^2) + eps)       (fp32)
//     o   = cast(x * inv, x's type) * w     (rounded to x's type)
// with x, w and o all fp32 or all bf16.  inv is 1 / sqrtf(.), both
// correctly rounded, rather than the approximate rsqrtf.
//
// What bounds it: two operations per element for the square sum and two
// for the scale, against 2 (bf16) or 4 (fp32) bytes read and as many
// written: bytes.  So the design moves each byte of x and o once, and
// keeps as many rows in flight as the SM can hold:
//   * one warp owns one row.  Its lane 0 asks the TMA engine for the whole
//     row (one cp.async.bulk into the warp's slice of shared memory,
//     counted on the warp's own mbarrier), so x is read from device memory
//     once and no register holds it while it is in flight;
//   * the square sum is read back with 16-byte shared-memory loads and
//     reduced by shuffles within the warp alone: no __syncthreads, no warp
//     waits on another row;
//   * the output is computed from the staged row and w (16-byte loads, once
//     per warp) and written with 16-byte stores.
// A block stages about 32 KB of rows (6 bf16 or 3 fp32 rows of 2560), so
// 7 blocks (42 bf16 or 21 fp32 rows) share an SM's 227 KB.  An earlier
// design kept the row in registers instead (10 or 20 16-byte
// vectors a lane): at 104-114 registers a thread only 16 rows fitted an
// SM, and in bf16 it was slower than torch.nn.functional.rms_norm
// (PERF.md).
// A row whose D is not a multiple of 16 bytes, whose pointers are not
// 16-byte aligned, or which does not fit a block's shared memory takes the
// scalar path of the same kernel (kStaged = false): one warp per row, 2-
// or 4-byte accesses, x read twice (the second time from the cache).
//
// The kernel launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (the wrapper raises on non-zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kStageBytes = 32 * 1024;  // rows staged per block, in bytes
constexpr int kMaxWarps = 8;            // rows per block
constexpr int kMaxSmem = 232448;        // a block's shared memory (227 KB)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// one element: cast(x * inv, T) * w, rounded to T
template <typename T>
__device__ __forceinline__ T scale(T x, T w, float inv) {
  return from_f32<T>(to_f32(from_f32<T>(to_f32(x) * inv)) * to_f32(w));
}

template <typename T, bool kStaged>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ w, T* __restrict__ o,
                               int N, int D, float eps) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= N) return;
  const T* xr = x + (size_t)row * D;
  T* orow = o + (size_t)row * D;
  float ss = 0.f;
  if constexpr (kStaged) {
    constexpr int E = 16 / sizeof(T);  // elements per 16 bytes
    const int bytes = D * (int)sizeof(T), nvec = D / E;
    extern __shared__ __align__(16) uint8_t smem[];
    const uint4* xs = reinterpret_cast<const uint4*>(smem + warp * bytes);
    uint64_t* bar = reinterpret_cast<uint64_t*>(
                        smem + (blockDim.x / 32) * bytes) + warp;
    if (lane == 0) {
      hopper::mbar_init(bar, 1);
      hopper::mbar_fence_init();
      hopper::mbar_expect_tx(bar, bytes);
      hopper::bulk_load(smem + warp * bytes, xr, bytes, bar);
    }
    __syncwarp();
    hopper::mbar_wait(bar, 0);
    for (int i = lane; i < nvec; i += 32) {
      const uint4 v = xs[i];
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int j = 0; j < E; ++j) ss = fmaf(to_f32(e[j]), to_f32(e[j]), ss);
    }
    const float inv = 1.f / sqrtf(warp_sum(ss) / (float)D + eps);
    const uint4* wv = reinterpret_cast<const uint4*>(w);
    uint4* ov = reinterpret_cast<uint4*>(orow);
    for (int i = lane; i < nvec; i += 32) {
      uint4 v = xs[i];
      const uint4 wi = __ldg(wv + i);
      T* e = reinterpret_cast<T*>(&v);
      const T* we = reinterpret_cast<const T*>(&wi);
#pragma unroll
      for (int j = 0; j < E; ++j) e[j] = scale(e[j], we[j], inv);
      ov[i] = v;
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      const float xv = to_f32(xr[c]);
      ss = fmaf(xv, xv, ss);
    }
    const float inv = 1.f / sqrtf(warp_sum(ss) / (float)D + eps);
    for (int c = lane; c < D; c += 32) orow[c] = scale(xr[c], w[c], inv);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* o, int N, int D,
                   float eps, cudaStream_t st) {
  const size_t bytes = (size_t)D * sizeof(T);
  const bool aligned =
      bytes % 16 == 0 && ((uintptr_t)x | (uintptr_t)w | (uintptr_t)o) % 16 == 0;
  const int warps =
      (int)std::min<size_t>(kMaxWarps, std::max<size_t>(1, kStageBytes / bytes));
  const size_t smem = warps * (bytes + sizeof(uint64_t));
  if (!aligned || smem > kMaxSmem) {
    rmsnorm_kernel<T, false><<<(N + kMaxWarps - 1) / kMaxWarps,
                               kMaxWarps * 32, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(o), N, D, eps);
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      rmsnorm_kernel<T, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  rmsnorm_kernel<T, true><<<(N + warps - 1) / warps, warps * 32, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(o),
      N, D, eps);
  return cudaGetLastError();
}

}  // namespace

// x, o: (N, D); w: (D,); all fp32 (bf16 = 0) or all bf16 (bf16 = 1),
// contiguous.  Returns a cudaError_t.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* o, int N,
                           int D, float eps, int bf16, void* stream) {
  if (N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch<__nv_bfloat16>(x, w, o, N, D, eps, st)
           : launch<float>(x, w, o, N, D, eps, st));
}
