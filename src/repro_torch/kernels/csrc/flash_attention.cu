// Causal / sliding-window GQA flash attention forward for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_folded
// (Pallas TPU kernel, body _flash_kernel) and computes what it computes:
// online softmax over key chunks, masked scores set to -1e30, output
// divided by max(l, 1e-30), all math in fp32 whatever the input type.
//
// Layouts (folded by repro_torch/kernels/ops.py): q (BK, S, G, D), already
// scaled by 1/sqrt(D); k, v (BK, T, D); o (BK, S, G, D) in q's type.  For
// one bk the (S, G) rows of q are one (S*G, D) matrix whose row r sits at
// query position r / G, so the G group rides inside a row tile and every
// K/V chunk is staged once for all the group's heads, as on the TPU.
//
// What bounds it: at the attention width it serves (D = 128, S = T = 4096,
// fp32) it does ~860 FLOP per byte it must move, far above the H100's fp32
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B), so it is bound by
// operations: fp32 FMAs on the CUDA cores (fp32 in, fp32 accumulators, as
// the reference; no tensor cores).  The design keeps the FMA pipe fed:
//   * a block of 128 threads owns BR = 64 rows; each thread owns a 4x4
//     register tile of scores (4 rows x 4 keys) and 4 rows x D/8 columns
//     of the accumulator, so each float4 read of shared memory feeds
//     4 FMAs (scores) and each scalar read of V feeds 4 FMAs (output);
//   * q is staged once per block and K/V in chunks of BC = 32 keys, all
//     converted to fp32 in shared memory (73.7 KB at D = 128), so the
//     TPU's whole (block_q x G x D) VMEM accumulator (655 KB at qwen
//     width, block_q = 256) is never needed: the accumulator stays in
//     registers and the chunk size does not depend on block_k;
//   * key chunks that the mask hides for every row of the block are
//     skipped (about half the work under a causal mask).  This changes
//     the result only by rounding: the reference runs such tiles with
//     p = exp(-1e30 - (-1e30)) = 1, but a later valid tile's
//     corr = exp(-1e30 - m) = 0 wipes what they added, and every row
//     keeps a valid key when causal (its diagonal).  Rows with no valid
//     key at all (only possible when S > T + window) disable skipping;
//   * row tiles are scheduled latest first: under a causal mask they
//     sweep the most keys.
//
// The kernel launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (the wrapper raises on non-zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kRowGroups = 16;                     // threads along rows
constexpr int kColGroups = 8;                      // threads along keys / d
constexpr int kThreads = kRowGroups * kColGroups;  // 128
constexpr int TM = 4;                              // rows per thread
constexpr int TN = 4;                              // keys per thread
constexpr int BR = kRowGroups * TM;                // 64 rows per block
constexpr int BC = kColGroups * TN;                // 32 keys per chunk
constexpr float kNegInf = -1e30f;                  // the reference's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float group_max(float x) {
  // the 8 threads of a row group are adjacent lanes (tid = rg * 8 + cg)
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int T, int causal,
                                        int window) {
  return kpos < T && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

template <int D>
constexpr size_t smem_bytes() {
  // qT [D][BR], kT [D][BC], v [BC][D], pT [BC][BR], all fp32
  return sizeof(float) * (size_t)(D * BR + D * BC + BC * D + BC * BR);
}

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                 const Elem* __restrict__ v, Elem* __restrict__ o, int S,
                 int T, int G, int causal, int window) {
  static_assert(D % kColGroups == 0, "D must be a multiple of 8");
  constexpr int DC = D / kColGroups;  // accumulator columns per thread

  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* kT = qT + D * BR;
  float* vs = kT + D * BC;
  float* pT = vs + BC * D;

  const int tid = threadIdx.x;
  const int rg = tid / kColGroups;
  const int cg = tid % kColGroups;
  const int bk = blockIdx.y;
  const int n_rows = S * G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BR;

  const Elem* qb = q + (size_t)bk * n_rows * D;
  const Elem* kb = k + (size_t)bk * T * D;
  const Elem* vb = v + (size_t)bk * T * D;
  Elem* ob = o + (size_t)bk * n_rows * D;

  for (int idx = tid; idx < BR * D; idx += kThreads) {
    const int r = idx % BR, d = idx / BR;
    const int row = row0 + r;
    qT[d * BR + r] = row < n_rows ? to_f32(qb[(size_t)row * D + d]) : 0.f;
  }

  // key chunks to sweep: skip those the mask hides for every row
  const int last_row = min(row0 + BR, n_rows) - 1;
  const int qpos_lo = row0 / G, qpos_hi = last_row / G;
  int t_begin = 0, t_end = T;
  // validity of a row's best key falls as qpos grows: check the last row
  const int kbest = causal ? min(qpos_hi, T - 1) : T - 1;
  if (T > 0 && visible(qpos_hi, kbest, T, causal, window)) {
    if (causal) t_end = min(T, qpos_hi + 1);
    if (window > 0) t_begin = max(0, qpos_lo - window + 1) / BC * BC;
  }

  float m[TM], l[TM], acc[TM][DC];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += BC) {
    __syncthreads();  // the previous chunk's reads of kT / vs / pT are done
    for (int idx = tid; idx < BC * D; idx += kThreads) {
      const int j = idx % BC, d = idx / BC;
      const int t = t0 + j;
      kT[d * BC + j] = t < T ? to_f32(kb[(size_t)t * D + d]) : 0.f;
    }
    for (int idx = tid; idx < BC * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int t = t0 + j;
      vs[j * D + d] = t < T ? to_f32(vb[(size_t)t * D + d]) : 0.f;
    }
    __syncthreads();

    // scores: s = q . k for 4 rows x 4 keys
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qT[d * BR + rg * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&kT[d * BC + cg * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // mask + online softmax, row statistics shared by the row group
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = (row0 + rg * TM + i) / G;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (!visible(qpos, t0 + cg * TN + j, T, causal, window))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        // keys past T are padding, not masked keys: they weigh nothing
        s[i][j] = t0 + cg * TN + j < T ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group_sum(rs);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j)
      *reinterpret_cast<float4*>(&pT[(cg * TN + j) * BR + rg * TM]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += p . v over the chunk
#pragma unroll 4
    for (int j = 0; j < BC; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(&pT[j * BR + rg * TM]);
      const float pv[TM] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = vs[j * D + c * kColGroups + cg];
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + rg * TM + i;
    if (row >= n_rows) continue;
    const float lse = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store(&ob[(size_t)row * D + c * kColGroups + cg], acc[i][c] / lse);
  }
}

template <typename Elem, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BK, int S, int T, int G, int causal, int window,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<Elem, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S * G + BR - 1) / BR, BK);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<Elem*>(o), S, T, G, causal,
      window);
  return cudaGetLastError();
}

template <typename Elem>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int BK, int S, int T, int G, int D, int causal,
                     int window, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<Elem, 8>(q, k, v, o, BK, S, T, G, causal, window, stream);
    case 16: return launch<Elem, 16>(q, k, v, o, BK, S, T, G, causal, window, stream);
    case 32: return launch<Elem, 32>(q, k, v, o, BK, S, T, G, causal, window, stream);
    case 64: return launch<Elem, 64>(q, k, v, o, BK, S, T, G, causal, window, stream);
    case 128: return launch<Elem, 128>(q, k, v, o, BK, S, T, G, causal, window, stream);
    case 256: return launch<Elem, 256>(q, k, v, o, BK, S, T, G, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// is_bf16: 0 for float32 inputs and output, 1 for bfloat16.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int BK, int S,
                                   int T, int G, int D, int causal,
                                   int window, int is_bf16, void* stream) {
  if (BK == 0 || S == 0 || G == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16
                   ? launch_d<__nv_bfloat16>(q, k, v, o, BK, S, T, G, D,
                                             causal, window, s)
                   : launch_d<float>(q, k, v, o, BK, S, T, G, D, causal,
                                     window, s));
}
