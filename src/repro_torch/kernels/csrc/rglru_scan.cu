// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rglru_scan.py:rglru_scan (Pallas TPU kernel,
// bodies _rglru_kernel and _scan_block) and computes what it computes:
//     h_t = a_t * h_{t-1} + b_t,  h_0 = 0,
// over a, b (B, T, D) fp32 into h (B, T, D) fp32.
//
// The TPU kernel cuts T into chunks, scans each by Hillis-Steele doubling
// on (block_t, D) vector tiles and carries one (1, D) row across the
// sequential grid.  Here the channels are the parallel axis: one thread
// owns one (b, d) channel and walks T in order, so no carry crosses a
// block and block_t sets no tile (the wrapper validates it as the
// reference does and ignores it).  Neighbouring threads own neighbouring
// d, so every load and store of a warp is one coalesced 128-byte line.
// Each thread loads kUnroll steps of a and b into registers before it
// runs them, so kUnroll loads of each array are in flight at once.  The
// step is rounded as the plain version rounds it (a multiply, then an
// add, no fused multiply-add), so kernel and plain version agree bit for
// bit.
//
// What bounds it: it moves 12 bytes per element (a and b in, h out) for
// two operations, so the data sheet bounds it by bytes.  What this simple
// design leaves on the table: at recurrentgemma-2b width (B = 1,
// D = 2560) there are only 2560 channels, 80 warps on a card of 132 SMs,
// and each warp has at most 2 x kUnroll loads in flight: far fewer bytes
// in flight than the memory system needs to reach its rate.  A chunked
// two-pass form (per-chunk products and partial sums, then a fix-up) would
// put T in the parallel axis too.
//
// The kernel launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (the wrapper raises on non-zero).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 32;  // one warp per block: spread over the SMs
constexpr int kUnroll = 16;   // steps loaded ahead per thread

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int T_len, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  const size_t base = (size_t)blockIdx.y * T_len * D + d;
  float carry = 0.f;
  int t = 0;
  for (; t + kUnroll <= T_len; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      av[q] = a[base + (size_t)(t + q) * D];
      bv[q] = b[base + (size_t)(t + q) * D];
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      carry = __fadd_rn(__fmul_rn(av[q], carry), bv[q]);
      h[base + (size_t)(t + q) * D] = carry;
    }
  }
  for (; t < T_len; ++t) {
    const size_t off = base + (size_t)t * D;
    carry = __fadd_rn(__fmul_rn(a[off], carry), b[off]);
    h[off] = carry;
  }
}

}  // namespace

// a, b, h: (B, T, D) fp32, contiguous.  Returns a cudaError_t.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h, int B,
                              int T_len, int D, void* stream) {
  if (B <= 0 || T_len <= 0 || D <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), T_len, D);
  return static_cast<int>(cudaGetLastError());
}
