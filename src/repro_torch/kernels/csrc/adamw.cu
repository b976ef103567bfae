// AdamW's update of one leaf, and the clip norm's square sum, for Hopper
// (sm_90a): each one pass over device memory.
//
// Replaces no TPU kernel: the reference's src/repro/optim/adamw.py is plain
// jnp that XLA fuses.  They replace the port's own chain of ~17 PyTorch
// elementwise kernels a 2^26-element slice (optim/adamw.py before this
// kernel; kernels/adamw.py:adamw_leaf_plain keeps it), which moved about
// 150 bytes a parameter through fp32 temporaries, and the clip norm's
// cast, square and sum a slice.
//
// adamw_leaf, for each element, in fp32 (g, p of type T; m, v fp32):
//     gs = g * scale
//     m  = m * b1 + gs * (1 - b1)
//     v  = v * b2 + (gs * gs) * (1 - b2)
//     u  = (m / bc1) / (sqrt(v / bc2) + eps)      [+ p * wd when wd != 0]
//     p  = cast(p - u * lr, T)
// term for term as the plain slice loop computes it, each operation
// rounded once as PyTorch's CUDA kernels round it (__fmul_rn and friends:
// no FMA contraction), with the constants the fp32 values PyTorch uses
// (the Python doubles rounded once, by the wrapper).  So m, v and p are
// bitwise the plain loop's.  scale, bc1 and bc2 are read from their 0-d
// device tensors: no host sync.
//
// square_sum: sum(g^2) over a whole leaf, fp32 out.  Each thread sums the
// squares of one 16-byte vector in fp32 (exact products for bf16/fp16) and
// accumulates the vectors in fp64; blocks reduce by shuffles in a fixed
// order, write one partial each, and one block folds the partials in a
// fixed order.  No atomics: the sum repeats bit for bit, and a grid that
// depends only on n, the type and the device fixes its order.
//
// What bounds them: bytes.  The update reads g, p (2 bytes each in bf16)
// and m, v (4 each) and writes m, v, p: 22 bytes a bf16 parameter for ~20
// operations; the square sum reads g once, 2 bytes.  So the design moves
// each byte once and keeps nothing in device memory between the terms:
// 16-byte loads and stores with streaming hints (nothing is read again),
// a grid-stride loop over one wave of resident blocks.  A pointer that is
// not 16-byte aligned (an offload piece starts anywhere in a leaf) gets a
// scalar head up to the first aligned element, when all four pointers
// share that alignment, else the whole range runs scalar; the ragged tail
// runs scalar.
//
// Each launches on the caller's stream, allocates nothing (square_sum's
// partials are the wrapper's: one a resident block, at most 8 an SM, 2048
// threads over kThreads) and returns cudaGetLastError() (the wrapper
// raises on non-zero).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Consts {
  float b1, c1, b2, c2, eps, lr, wd;  // c1 = 1 - b1, c2 = 1 - b2
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// one element of the update, in place
template <typename T>
__device__ __forceinline__ void step(T g, float& m, float& v, T& p,
                                     float scale, float bc1, float bc2,
                                     const Consts& c) {
  const float gs = __fmul_rn(to_f32(g), scale);
  m = __fadd_rn(__fmul_rn(m, c.b1), __fmul_rn(gs, c.c1));
  v = __fadd_rn(__fmul_rn(v, c.b2), __fmul_rn(__fmul_rn(gs, gs), c.c2));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), c.eps);
  float u = __fdiv_rn(__fdiv_rn(m, bc1), den);
  const float pf = to_f32(p);
  if (c.wd != 0.f) u = __fadd_rn(u, __fmul_rn(pf, c.wd));
  p = from_f32<T>(__fsub_rn(pf, __fmul_rn(u, c.lr)));
}

// The split of [0, n) every kernel here walks: `head` scalar elements up
// to the first 16-byte-aligned one, `nvec` vectors of 16 / sizeof(T), the
// scalar rest from `tail0`.  Pointers that do not share the head's
// alignment: all scalar (head = n).
struct Split {
  size_t head, nvec, tail0;
};

inline bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// elements of x before its first 16-byte-aligned one (at most n)
template <typename T>
size_t head_of(const T* x, size_t n) {
  return std::min(
      n, ((16 - reinterpret_cast<uintptr_t>(x) % 16) % 16) / sizeof(T));
}

template <typename T>
Split make_split(size_t n, size_t head, bool vec) {
  constexpr size_t E = 16 / sizeof(T);
  if (!vec) head = n;
  const size_t nvec = (n - head) / E;
  return {head, nvec, head + nvec * E};
}

// a thread's work items: vectors, or scalars where those outnumber them
size_t units(const Split& s, size_t n) {
  return std::max(s.nvec, s.head + (n - s.tail0));
}

// the scalar elements of a split: index i < head + n - tail0
__device__ __forceinline__ size_t scalar_at(const Split& s, size_t i) {
  return i < s.head ? i : s.tail0 + (i - s.head);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adamw_leaf_kernel(const T* __restrict__ g, float* __restrict__ m,
                  float* __restrict__ v, T* __restrict__ p, size_t n,
                  Split s, const float* __restrict__ scale_p,
                  const float* __restrict__ bc1_p,
                  const float* __restrict__ bc2_p, Consts c) {
  constexpr int E = 16 / sizeof(T), F = E / 4;  // elements, float4s a vector
  const float scale = __ldg(scale_p), bc1 = __ldg(bc1_p), bc2 = __ldg(bc2_p);
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kThreads;
  for (size_t i = tid; i < s.nvec; i += stride) {
    const size_t e = s.head + i * E;
    uint4 gv = __ldcs(reinterpret_cast<const uint4*>(g + e));
    uint4 pv = __ldcs(reinterpret_cast<const uint4*>(p + e));
    float4 mv[F], vv[F];
#pragma unroll
    for (int k = 0; k < F; ++k) {
      mv[k] = __ldcs(reinterpret_cast<const float4*>(m + e) + k);
      vv[k] = __ldcs(reinterpret_cast<const float4*>(v + e) + k);
    }
    const T* ge = reinterpret_cast<const T*>(&gv);
    T* pe = reinterpret_cast<T*>(&pv);
    float* me = reinterpret_cast<float*>(mv);
    float* ve = reinterpret_cast<float*>(vv);
#pragma unroll
    for (int j = 0; j < E; ++j)
      step(ge[j], me[j], ve[j], pe[j], scale, bc1, bc2, c);
#pragma unroll
    for (int k = 0; k < F; ++k) {
      __stcs(reinterpret_cast<float4*>(m + e) + k, mv[k]);
      __stcs(reinterpret_cast<float4*>(v + e) + k, vv[k]);
    }
    __stcs(reinterpret_cast<uint4*>(p + e), pv);
  }
  const size_t nscalar = s.head + (n - s.tail0);
  for (size_t i = tid; i < nscalar; i += stride) {
    const size_t e = scalar_at(s, i);
    step(g[e], m[e], v[e], p[e], scale, bc1, bc2, c);
  }
}

// thread 0 gets the block's sum, in a fixed order
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_sums[warp] = x;
  __syncthreads();
  x = threadIdx.x < kWarps ? warp_sums[threadIdx.x] : 0.0;
  if (warp == 0) {
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
square_sum_kernel(const T* __restrict__ g, size_t n, Split s,
                  double* __restrict__ partials) {
  constexpr int E = 16 / sizeof(T);
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * kThreads;
  double acc = 0.0;
  for (size_t i = tid; i < s.nvec; i += stride) {
    const uint4 gv = __ldcs(reinterpret_cast<const uint4*>(g + s.head + i * E));
    const T* ge = reinterpret_cast<const T*>(&gv);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) sq = fmaf(to_f32(ge[j]), to_f32(ge[j]), sq);
    acc += (double)sq;
  }
  const size_t nscalar = s.head + (n - s.tail0);
  for (size_t i = tid; i < nscalar; i += stride) {
    const float x = to_f32(g[scalar_at(s, i)]);
    acc += (double)(x * x);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
square_sum_fold(const double* __restrict__ partials, int count,
                float* __restrict__ out) {
  double x = 0.0;
  for (int i = threadIdx.x; i < count; i += kThreads) x += partials[i];
  x = block_sum(x);
  if (threadIdx.x == 0) *out = __double2float_rn(x);
}

// one wave of `kernel`'s resident blocks on the current device, or fewer
// where `items` (a thread's work items) need fewer
template <typename K>
cudaError_t wave(K kernel, size_t items, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const size_t need = std::max<size_t>(1, (items + kThreads - 1) / kThreads);
  *blocks = (int)std::min<size_t>(need, (size_t)sms * std::max(per_sm, 1));
  return cudaSuccess;
}

template <typename T>
cudaError_t leaf(const void* g, void* m, void* v, void* p, size_t n,
                 const float* scale, const float* bc1, const float* bc2,
                 const Consts& c, cudaStream_t st) {
  const T* gt = static_cast<const T*>(g);
  T* pt = static_cast<T*>(p);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const size_t h = head_of(pt, n);
  const Split s = make_split<T>(n, h, aligned16(pt + h) && aligned16(gt + h) &&
                                         aligned16(mf + h) && aligned16(vf + h));
  int blocks = 0;
  cudaError_t err = wave(adamw_leaf_kernel<T>, units(s, n), &blocks);
  if (err != cudaSuccess) return err;
  adamw_leaf_kernel<T><<<blocks, kThreads, 0, st>>>(gt, mf, vf, pt, n, s,
                                                    scale, bc1, bc2, c);
  return cudaGetLastError();
}

template <typename T>
Split square_split(const T* g, size_t n) {
  const size_t h = head_of(g, n);
  return make_split<T>(n, h, aligned16(g + h));
}

template <typename T>
cudaError_t sq(const void* g, size_t n, double* partials, int capacity,
               float* out, cudaStream_t st) {
  const T* gt = static_cast<const T*>(g);
  const Split s = square_split(gt, n);
  int blocks = 0;
  cudaError_t err = wave(square_sum_kernel<T>, units(s, n), &blocks);
  if (err != cudaSuccess) return err;
  blocks = std::min(blocks, capacity);
  square_sum_kernel<T><<<blocks, kThreads, 0, st>>>(gt, n, s, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  square_sum_fold<<<1, kThreads, 0, st>>>(partials, blocks, out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16, 2 fp16 (g and p); m, v fp32; n elements, all
// contiguous; scale, bc1, bc2: fp32 device scalars.  Returns a cudaError_t.
extern "C" int adamw_leaf(const void* g, void* m, void* v, void* p,
                          long long n, int dtype, const void* scale,
                          const void* bc1, const void* bc2, float b1,
                          float c1, float b2, float c2, float eps, float lr,
                          float wd, void* stream) {
  if (n <= 0 || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts c{b1, c1, b2, c2, eps, lr, wd};
  const float *sp = static_cast<const float*>(scale),
              *b1p = static_cast<const float*>(bc1),
              *b2p = static_cast<const float*>(bc2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return leaf<float>(g, m, v, p, (size_t)n, sp, b1p, b2p, c, st);
    case 1:
      return leaf<__nv_bfloat16>(g, m, v, p, (size_t)n, sp, b1p, b2p, c, st);
    default:
      return leaf<__half>(g, m, v, p, (size_t)n, sp, b1p, b2p, c, st);
  }
}

// out (fp32 device scalar) = sum of g^2 over n contiguous elements of
// `dtype`, through at most `capacity` fp64 partials (the grid: one wave
// of resident blocks, or fewer where `capacity` or n asks for fewer).
extern "C" int square_sum(const void* g, long long n, int dtype,
                          void* partials, int capacity, void* out,
                          void* stream) {
  if (n <= 0 || dtype < 0 || dtype > 2 || capacity <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  double* part = static_cast<double*>(partials);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return sq<float>(g, (size_t)n, part, capacity, o, st);
    case 1: return sq<__nv_bfloat16>(g, (size_t)n, part, capacity, o, st);
    default: return sq<__half>(g, (size_t)n, part, capacity, o, st);
  }
}
