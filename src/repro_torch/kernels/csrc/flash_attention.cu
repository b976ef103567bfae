// Causal / sliding-window GQA flash attention forward for Hopper (sm_90a),
// fp32 on the CUDA cores (route "simt").
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_folded
// (Pallas TPU kernel, body _flash_kernel) and computes what it computes:
// online softmax over key chunks, masked scores set to -1e30, output
// divided by max(l, 1e-30), all math in fp32 whatever the input type.
// The wrapper sends fp32 at every head dim and bf16 with D < 64 here
// (bf16 at D >= 64 takes the tensor-core kernel, flash_attention_sm90.cu);
// TF32 tensor cores would keep too few digits for the 2e-5 tolerance.
//
// Layouts (folded by repro_torch/kernels/ops.py): q (BK, S, G, D), already
// scaled by 1/sqrt(D); k, v (BK, T, D); o (BK, S, G, D) in q's type.  For
// one bk the (S, G) rows of q are one (S*G, D) matrix whose row r sits at
// query position r / G, so the G group rides inside a row tile and every
// K/V chunk is staged once for all the group's heads, as on the TPU.
//
// What bounds it: at the attention widths it serves (D = 128 or 256,
// S = T = 4096, fp32) it does hundreds of FLOPs per byte it must move,
// far above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B),
// so it is bound by fp32 FMAs.  The design keeps the FMA pipe fed:
//   * a block of 256 threads (8 warps) owns BR = 64 rows and sweeps the
//     keys in chunks of BC = 64.  S = Q.K^T gives each thread a 4 x 4
//     register tile (4 rows x 4 keys): per 4 steps of d it reads 4 float4
//     of Q and 4 of K for 64 FMAs.  O += P.V gives each thread 4 rows x
//     D/16 columns (D >= 64): per key one float4 of P and D/64 float4 of V
//     for 16 x D/64 FMAs.  Every shared-memory read feeds >= 8 FMAs;
//   * Q, K and V are staged in shared memory by 16-byte cp.async in their
//     row-major layout; K's float4 columns are XOR-swizzled by key % 8 (and
//     P's by key % 8) so the 4 x 4 tiles read and write without bank
//     conflicts.  K and V take turns in two slots: V_j loads while
//     S_j = Q.K_j^T runs, K_{j+1} loads while O += P_j.V_j runs, with two
//     barriers per 64-key chunk;
//   * Q, one K chunk, one V chunk and P fill 112.5 KB at D = 128 (two
//     blocks, 16 warps per SM) and 208.5 KB at D = 256 (one block, 8
//     warps per SM); the accumulator stays in registers, so the TPU's
//     (block_q x G x D) VMEM accumulator is never needed and no tile
//     depends on block_q / block_k;
//   * only chunks that straddle the causal diagonal, the window's edge or
//     the end of the keys run the mask, from query positions computed once
//     per thread; interior chunks take no per-score test;
//   * key chunks that the mask hides for every row of the block are
//     skipped (about half the work under a causal mask).  This changes the
//     result only by rounding: the reference runs such tiles with
//     p = exp(-1e30 - (-1e30)) = 1, but a later valid tile's
//     corr = exp(-1e30 - m) = 0 wipes what they added, and every row keeps
//     a valid key when causal (its diagonal).  Rows with no valid key at
//     all (only possible when S > T + window) disable skipping;
//   * row tiles are scheduled latest first: under a causal mask they sweep
//     the most keys.
// bf16 inputs (D < 64) are converted to fp32 as they are staged, by plain
// loads (cp.async cannot convert); the products are the same.
//
// The kernel launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (the wrapper raises on non-zero).  q, k, v
// and o are 16-byte aligned (the wrapper ensures it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;

constexpr int kThreads = 256;
constexpr int BR = 64;                   // rows per block
constexpr int BC = 64;                   // keys per chunk
constexpr int TM = 4;                    // score rows per thread
constexpr int TN = 4;                    // score keys per thread
constexpr int kKeyGroups = BC / TN;      // 16 adjacent lanes share a row
constexpr float kNegInf = -1e30f;        // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = 2^(x log2 e)
static_assert((BR / TM) * kKeyGroups == kThreads, "score tiling");

template <int D>
struct Tile {
  static constexpr int C4 = D / 4;                      // float4s a row
  static constexpr int SW = (C4 < 8 ? C4 : 8) - 1;      // K swizzle mask
  static constexpr int PCG = C4 < 16 ? C4 : 16;         // P.V column groups
  static constexpr int NB4 = C4 / PCG;                  // float4s a thread
  static constexpr int TMP =                            // P.V rows a thread
      BR * PCG / kThreads > 0 ? BR * PCG / kThreads : 1;
  static constexpr int PRG = BR / TMP;
  static constexpr int PUSED = PRG * PCG;
  // Q [BR][D], K [BC][D], V [BC][D], P [BC][BR], corr [BR], l [BR]
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BR * D + 2 * BC * D + BC * BR + 2 * BR);
  static constexpr int MIN_BLOCKS = D <= 128 ? 2 : 1;
  static_assert(PUSED <= kThreads && C4 % PCG == 0, "P.V tiling");
};

// four bf16 (8-byte aligned) as fp32
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// the 16 lanes of a row group are adjacent (tid = row group * 16 + key group)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int m = 1; m < kKeyGroups; m <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int m = 1; m < kKeyGroups; m <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int T, int causal,
                                        int window) {
  return kpos < T && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

// rows [r0, r0 + ROWS) of a (rows x D) matrix into shared memory as fp32,
// float4 column c of row r at c ^ (r & SWZ); rows at or past `limit` are
// zeros.  fp32 goes by cp.async (the caller commits and waits), bf16 by
// plain loads converted on the way.
template <typename Elem, int D, int ROWS, int SWZ>
__device__ __forceinline__ void stage(float* dst, const Elem* src, int r0,
                                      int limit, int tid) {
  constexpr int C4 = D / 4;
  for (int e = tid; e < ROWS * C4; e += kThreads) {
    const int r = e / C4, c = e % C4;
    float* d = dst + r * D + 4 * (c ^ (r & SWZ));
    const bool in = r0 + r < limit;
    const Elem* s = src + (size_t)(in ? r0 + r : 0) * D + 4 * c;
    if constexpr (std::is_same<Elem, float>::value) {
      cp_async16(d, s, in ? 16u : 0u);
    } else {
      *reinterpret_cast<float4*>(d) =
          in ? load4(s) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::MIN_BLOCKS)
flash_fwd_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
                 const Elem* __restrict__ v, Elem* __restrict__ o, int S,
                 int T, int G, int causal, int window) {
  using Tl = Tile<D>;
  constexpr int C4 = Tl::C4, SW = Tl::SW, PCG = Tl::PCG, NB4 = Tl::NB4,
                TMP = Tl::TMP;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BR][D]
  float* Ks = Qs + BR * D;                       // [BC][D], swizzled
  float* Vs = Ks + BC * D;                       // [BC][D]
  float* Ps = Vs + BC * D;                       // [BC][BR], swizzled
  float* corr_s = Ps + BC * BR;                  // [BR]
  float* l_s = corr_s + BR;                      // [BR]
  const float4* Qs4 = reinterpret_cast<const float4*>(Qs);
  const float4* Ks4 = reinterpret_cast<const float4*>(Ks);
  const float4* Vs4 = reinterpret_cast<const float4*>(Vs);
  float4* Ps4 = reinterpret_cast<float4*>(Ps);

  const int tid = threadIdx.x;
  const int rg = tid / kKeyGroups, cg = tid % kKeyGroups;
  const int bk = blockIdx.y;
  const int n_rows = S * G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BR;

  const Elem* qb = q + (size_t)bk * n_rows * D;
  const Elem* kb = k + (size_t)bk * T * D;
  const Elem* vb = v + (size_t)bk * T * D;
  Elem* ob = o + (size_t)bk * n_rows * D;

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

  stage<Elem, D, BR, 0>(Qs, qb, row0, n_rows, tid);
  if (t_begin < t_end) stage<Elem, D, BC, SW>(Ks, kb, t_begin, T, tid);
  cp_async_commit();

  int qpos[TM];  // this thread's score rows' query positions
#pragma unroll
  for (int i = 0; i < TM; ++i) qpos[i] = (row0 + TM * rg + i) / G;
  float m[TM], lp[TM];  // running max; this thread's part of the row sum
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    lp[i] = 0.f;
  }
  const int prg = tid / PCG, pq = tid % PCG;  // P.V: rows and columns
  float acc[TMP][NB4][4];
#pragma unroll
  for (int a = 0; a < TMP; ++a)
#pragma unroll
    for (int b = 0; b < NB4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  cp_async_wait<0>();
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += BC) {
    stage<Elem, D, BC, 0>(Vs, vb, t0, T, tid);  // lands during S = Q.K^T
    cp_async_commit();

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
    const int kc = cg & SW;
#pragma unroll 8
    for (int c = 0; c < C4; ++c) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = Qs4[(TM * rg + i) * C4 + c];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = Ks4[(cg + kKeyGroups * j) * C4 + (c ^ kc)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // the mask, only where the chunk crosses the diagonal, the window's
    // edge or the end of the keys
    const bool edge = (causal && t0 + BC - 1 > qpos_lo) ||
                      (window > 0 && qpos_hi - t0 >= window) ||
                      t0 + BC > T;
    if (edge) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (!visible(qpos[i], t0 + cg + kKeyGroups * j, T, causal, window))
            s[i][j] = kNegInf;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < TN; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], group_max(mx));
      // exp(x) as 2^(x log2 e), x = s - m formed first: its rounding is
      // relative to |s - m|, so the weights near the maximum stay exact
      // (scaling s alone first would err by |s| 2^-24 on every score)
      const float corr = exp2f((m[i] - m_new) * kLog2e);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        // keys past T are padding, not masked keys: they weigh nothing
        s[i][j] = edge && t0 + cg + kKeyGroups * j >= T
                      ? 0.f
                      : exp2f((s[i][j] - m_new) * kLog2e);
        rs += s[i][j];
      }
      lp[i] = lp[i] * corr + rs;
      m[i] = m_new;
      if (cg == 0) corr_s[TM * rg + i] = corr;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int key = cg + kKeyGroups * j;
      Ps4[key * (BR / 4) + (rg ^ (key & 7))] =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    cp_async_wait<0>();
    __syncthreads();  // P, corr and V_j visible; K_j's reads are done

    if (t0 + BC < t_end)  // lands during O += P.V
      stage<Elem, D, BC, SW>(Ks, kb, t0 + BC, T, tid);
    cp_async_commit();

    if (tid < Tl::PUSED) {
#pragma unroll
      for (int a = 0; a < TMP; ++a) {
        const float cr = corr_s[TMP * prg + a];
#pragma unroll
        for (int b = 0; b < NB4; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][b][c] *= cr;
      }
#pragma unroll 8
      for (int j = 0; j < BC; ++j) {
        float pv[TMP];
        if constexpr (TMP == 4) {
          const float4 p4 = Ps4[j * (BR / 4) + (prg ^ (j & 7))];
          pv[0] = p4.x;
          pv[1] = p4.y;
          pv[2] = p4.z;
          pv[3] = p4.w;
        } else {
#pragma unroll
          for (int a = 0; a < TMP; ++a) {
            const int row = TMP * prg + a;
            pv[a] = Ps[j * BR + 4 * ((row >> 2) ^ (j & 7)) + (row & 3)];
          }
        }
#pragma unroll
        for (int b = 0; b < NB4; ++b) {
          const float4 vv = Vs4[j * C4 + pq + PCG * b];
#pragma unroll
          for (int a = 0; a < TMP; ++a) {
            acc[a][b][0] = fmaf(pv[a], vv.x, acc[a][b][0]);
            acc[a][b][1] = fmaf(pv[a], vv.y, acc[a][b][1]);
            acc[a][b][2] = fmaf(pv[a], vv.z, acc[a][b][2]);
            acc[a][b][3] = fmaf(pv[a], vv.w, acc[a][b][3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // K_{j+1} visible; V_j's and P's reads are done
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float l = group_sum(lp[i]);
    if (cg == 0) l_s[TM * rg + i] = l;
  }
  __syncthreads();
  if (tid < Tl::PUSED) {
#pragma unroll
    for (int a = 0; a < TMP; ++a) {
      const int row = row0 + TMP * prg + a;
      if (row >= n_rows) continue;
      const float lse = fmaxf(l_s[TMP * prg + a], 1e-30f);
#pragma unroll
      for (int b = 0; b < NB4; ++b)
        store4(ob + (size_t)row * D + 4 * (pq + PCG * b),
               make_float4(acc[a][b][0] / lse, acc[a][b][1] / lse,
                           acc[a][b][2] / lse, acc[a][b][3] / lse));
    }
  }
}

template <typename Elem, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BK, int S, int T, int G, int causal, int window,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<Elem, D>;
  constexpr size_t smem = Tile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory, so two blocks of
  // 112.5 KB fit at D = 128
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
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
