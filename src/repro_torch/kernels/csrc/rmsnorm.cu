// Row RMSNorm for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rmsnorm.py:rmsnorm (Pallas TPU kernel, body
// _rmsnorm_kernel) and computes what it computes, for each row of x
// (N, D):
//     inv = 1 / sqrt(mean(x^2) + eps)       (fp32)
//     o   = cast(x * inv, x's type) * w     (rounded to x's type)
// with x, w and o all fp32 or all bf16.
//
// The TPU kernel normalises (block_rows, D) tiles held in VMEM.  Here one
// block of 256 threads owns one row: each thread sums the squares of its
// strided elements in fp32, the block reduces them by warp shuffles and
// one shared-memory step, and the same threads then write the scaled row
// (their second read of x hits the cache).  Neighbouring threads touch
// neighbouring elements, so every access is coalesced.  block_rows sets no
// tile here (the wrapper validates it as the reference does and ignores
// it).  inv is 1 / sqrtf(.), both correctly rounded, rather than the
// approximate rsqrtf.
//
// What bounds it: two operations per element for the square sum and two
// for the scale, against 2 (bf16) or 4 (fp32) bytes read and written: the
// data sheet bounds it by bytes.  What this simple design leaves on the
// table: x is read twice (once from the cache), loads are 2 or 4 bytes a
// thread rather than 16, and each block waits on its own reduction before
// it writes.
//
// The kernel launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (the wrapper raises on non-zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ o, int D, float eps) {
  __shared__ float partial[kThreads / 32];
  __shared__ float inv_s;
  const size_t row = (size_t)blockIdx.x * D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float ss = 0.f;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    const float xv = to_f32(x[row + c]);
    ss = fmaf(xv, xv, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float tot = lane < kThreads / 32 ? partial[lane] : 0.f;
    tot = warp_sum(tot);
    if (lane == 0) inv_s = 1.f / sqrtf(tot / (float)D + eps);
  }
  __syncthreads();
  const float inv = inv_s;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    const T y = from_f32<T>(to_f32(x[row + c]) * inv);
    o[row + c] = from_f32<T>(to_f32(y) * to_f32(w[c]));
  }
}

}  // namespace

// x, o: (N, D); w: (D,); all fp32 (bf16 = 0) or all bf16 (bf16 = 1),
// contiguous.  Returns a cudaError_t.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* o, int N,
                           int D, float eps, int bf16, void* stream) {
  if (N <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    rmsnorm_kernel<__nv_bfloat16><<<N, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(o), D, eps);
  else
    rmsnorm_kernel<float><<<N, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(o), D, eps);
  return static_cast<int>(cudaGetLastError());
}
