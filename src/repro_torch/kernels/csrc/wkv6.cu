// RWKV-6 recurrence for Hopper (sm_90a), in chunks, parallel over time.
//
// Replaces src/repro/kernels/wkv6.py:wkv6_folded (Pallas TPU kernel, body
// _wkv6_kernel) and computes what it computes, per head (bh) from S = 0:
//     o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// and returns o (BH, T, hs) and the final S (BH, hs, hs), both fp32.  All
// math is fp32 on the FMA pipe whatever the input type (r, k, v, u fp32 or
// bf16; w fp32): bf16 or TF32 tensor cores would round the decay-scaled
// operands beyond the 2e-4 tolerance.
//
// The TPU kernel turns a chunk into matrix products by dividing k by a
// cumulative decay product, which underflows for strong decays.  Here the
// decays live in log space, lw = max(log2 w, log2 1e-38), and every factor
// is exp2 of a DIRECT sum of lw over the tokens it spans: a forward sum
// from a (sub-)chunk start, a reverse sum back from its end, or a running
// sum along a diagonal of token pairs.  Each is <= 0, so an underflow only
// drops a contribution below 1e-38, and no exponent is the difference of
// two prefix sums (which cancels: that form fails the extreme-decay tests
// of tests/test_torch_wkv6_chunked.py, which hold this algorithm's plain
// mirror, wkv6.py:wkv6_chunked_plain, to the sequential recurrence).
//
// One call of wkv6_fwd runs three kernels on the caller's stream, over
// chunks of kChunk = 64 tokens cut into sub-chunks of kSub = 16:
//
// 1. wkv6_chunk_kernel, grid (BH x chunks, hs / JB column tiles), fully
//    parallel: the state each chunk leaves when it starts from S = 0,
//        U_c = sum over sub-chunks of
//              U <- diag(2^(sum_sub lw)) U + (k_s 2^(sum_{s<m<t1} lw))^T v_s,
//    and tot_c = sum_chunk lw per row, into the caller's scratch
//    (BH x chunks x hs x hs and BH x chunks x hs, fp32).
// 2. wkv6_chain_kernel, one thread per 4 entries of each head's S: the
//    only serial part, elementwise, S_{c+1} = diag(2^tot_c) S_c + U_c,
//    writing each chunk's start state S_c over U_c and the final S.
// 3. wkv6_output_kernel, grid (BH x chunks, hs / JB), fully parallel:
//    each block starts from its chunk's S_c and walks the sub-chunks:
//        o_t = (r_t 2^(sum_{t0<=m<t} lw)) S0 + sum_{s<t} a_ts v_s
//              + (r_t . (u k_t)) v_t,
//        a_ts = sum_i r_t[i] k_s[i] 2^(sum_{s<m<t} lw[i]),
//    with S0 the state at the sub-chunk's start t0 (in shared memory,
//    advanced over each sub-chunk as in 1) and the pair sums accumulated
//    along each diagonal (about 85 M exp2s at rwkv6-3b width).  The state
//    term is split over groups of rows of S0, 4 tokens x 4 columns a
//    thread, so each shared-memory read feeds 16 FMAs.
// Kernels 1 and 3 fetch a sub-chunk's inputs into registers while the
// previous one computes.
// Kernels 1 and 3 put 4 warps on each (head, chunk): 2560 blocks at
// rwkv6-3b width (BH = 40, T = 4096) where the token-by-token form had
// 160, and the serial chain is T / 64 elementwise steps.
//
// What bounds it: the recurrence's own work, ~5 hs^2 fp32 operations and
// 4 hs inputs per token and head, is about balanced between bytes and
// operations on an H100 (PERF.md has the bound beside the time).  The
// chunked form does about twice those operations (the output pass redoes
// the state products per sub-chunk) and reads k, v and w twice, in
// exchange for that parallelism.
//
// Ragged T: the last chunk and sub-chunk are short; nothing is padded.
// The kernels allocate nothing (the wrapper passes the scratch) and
// wkv6_fwd returns the first cudaGetLastError() (the wrapper raises on
// non-zero).  Every pointer is 16-byte aligned (the wrapper ensures it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kChunk = 64;  // tokens per chunk (wkv6.py: CHUNK)
constexpr int kSub = 16;    // tokens per sub-chunk (wkv6.py: SUB)
constexpr int kChainBatch = 16;  // chunks the chain loads ahead
constexpr float kLogWMin = -126.233267606f;  // log2(1e-38)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// lg2.approx: relative error 2^-22, ~2e-7 of each term of a sum of log
// decays, far inside the 2e-4 tolerance at the factors 2^x it feeds
__device__ __forceinline__ float log_decay(float w) {
  return fmaxf(__log2f(w), kLogWMin);  // log2(0) = -inf -> log2 1e-38
}

__device__ __forceinline__ float comp(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

// ---- tiles of the chunk and output kernels --------------------------------

template <int HS>
struct OutTile {
  static constexpr int NT = 128;
  static constexpr int JB = HS < 64 ? HS : 64;  // output columns per block
  // diagonal pass: LPT lanes a token, each DI rows of it
  static constexpr int LPT = NT / kSub;
  static constexpr int DI = HS / LPT;
  static constexpr int SP = HS + LPT;  // row stride of the token rows: the
                                       // diagonal pass's 32 / LPT rows x LPT
                                       // lanes a warp reads fall on 32 banks
  static constexpr int SSP = JB + 4;  // row stride of the state tile
  static constexpr int SCP = kSub + 1;
  static constexpr int OCG = JB / 4;  // column groups of 4
  // o's state term, split over KS groups of KI rows of S0: 4 tokens x 4
  // columns a thread, so each shared-memory read feeds 16 FMAs
  static constexpr int KS = NT / JB < HS / 4 ? NT / JB : HS / 4;
  static constexpr int KI = HS / KS;
  static constexpr int KUSED = KS * (kSub / 4) * OCG;
  static constexpr int SUBP = kSub + 4;  // row stride of r 2^fwd, by row i
  // o's sum of the partials and pair terms: OT tokens x 4 columns a thread
  static constexpr int OT = kSub * OCG > NT ? kSub * OCG / NT : 1;
  static constexpr int ORG = kSub / OT;
  static constexpr int OUSED = ORG * OCG;
  // state advance: RI rows x 4 columns a thread
  static constexpr int RI = HS * OCG > NT ? HS * OCG / NT : 1;
  static constexpr int ARG = HS / RI;
  static constexpr int AUSED = ARG * OCG;
  // r, k, lw, k 2^rev rows; r 2^fwd by row; the state tile; v's columns;
  // the partial outputs; the pair weights; 2^(sum lw) and u
  static constexpr size_t SMEM =
      sizeof(float) * (4 * kSub * SP + HS * SUBP + HS * SSP + kSub * JB +
                       KS * kSub * JB + kSub * SCP + 2 * HS);
  static_assert(OUSED <= NT && AUSED <= NT && KUSED <= NT && HS <= NT &&
                    HS >= LPT,
                "tile");
};

// four consecutive elements as they lie in memory: float4 for fp32, uint2
// (four bf16) for bf16
template <typename T>
struct Raw4 {
  using type = float4;
};
template <>
struct Raw4<__nv_bfloat16> {
  using type = uint2;
};
__device__ __forceinline__ float4 cvt4(float4 x) { return x; }
__device__ __forceinline__ float4 cvt4(uint2 raw) {
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// one sub-chunk's inputs (r if WITH_R, k, w, and the block's columns of v)
// held in registers: fetched from global memory one sub-chunk ahead, so the
// loads fly while the current sub-chunk computes, then stored to shared
// memory as fp32 (w as log2 w)
template <int HS, typename T, bool WITH_R>
struct Fetch {
  using Tl = OutTile<HS>;
  using R4 = typename Raw4<T>::type;
  static constexpr int NR = (kSub * HS / 4 + Tl::NT - 1) / Tl::NT;
  static constexpr int NV = (kSub * Tl::JB / 4 + Tl::NT - 1) / Tl::NT;
  R4 r[WITH_R ? NR : 1], k[NR], v[NV];
  float4 w[NR];

  __device__ __forceinline__ void fetch(const T* rg, const T* kg,
                                        const T* vg, const float* wg,
                                        size_t base, int t0, int n, int j0,
                                        int tid) {
    const size_t g0 = base + (size_t)t0 * HS;  // the sub-chunk's rows
#pragma unroll
    for (int p = 0; p < NR; ++p) {
      const int e = tid + p * Tl::NT;
      if (e < n * HS / 4) {
        if constexpr (WITH_R)
          r[p] = *reinterpret_cast<const R4*>(rg + g0 + 4 * e);
        k[p] = *reinterpret_cast<const R4*>(kg + g0 + 4 * e);
        w[p] = *reinterpret_cast<const float4*>(wg + g0 + 4 * e);
      }
    }
#pragma unroll
    for (int p = 0; p < NV; ++p) {
      const int e = tid + p * Tl::NT;
      if (e < n * Tl::OCG) {
        const int t = e / Tl::OCG, q = e % Tl::OCG;
        v[p] = *reinterpret_cast<const R4*>(vg + g0 + (size_t)t * HS + j0 +
                                            4 * q);
      }
    }
  }

  __device__ __forceinline__ void store(float* r_s, float* k_s, float* lw_s,
                                        float* v_s, int n, int tid) const {
    constexpr int SP = Tl::SP;
#pragma unroll
    for (int p = 0; p < NR; ++p) {
      const int e = tid + p * Tl::NT;
      if (e < n * HS / 4) {
        const int t = 4 * e / HS, i = 4 * e % HS;
        if constexpr (WITH_R)
          *reinterpret_cast<float4*>(r_s + t * SP + i) = cvt4(r[p]);
        *reinterpret_cast<float4*>(k_s + t * SP + i) = cvt4(k[p]);
        *reinterpret_cast<float4*>(lw_s + t * SP + i) =
            make_float4(log_decay(w[p].x), log_decay(w[p].y),
                        log_decay(w[p].z), log_decay(w[p].w));
      }
    }
#pragma unroll
    for (int p = 0; p < NV; ++p) {
      const int e = tid + p * Tl::NT;
      if (e < n * Tl::OCG) {
        const int t = e / Tl::OCG, q = e % Tl::OCG;
        *reinterpret_cast<float4*>(v_s + t * Tl::JB + 4 * q) = cvt4(v[p]);
      }
    }
  }
};

// ---- 1: each chunk's own contribution, in parallel ------------------------

// U_c = the state a chunk leaves when it starts from S = 0, and tot_c =
// sum_chunk lw, per column: the chunk walked sub-chunk by sub-chunk with
// the output kernel's scan and state advance, U_c in registers
template <int HS, typename T>
__global__ void __launch_bounds__(OutTile<HS>::NT)
wkv6_chunk_kernel(const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ w, float* __restrict__ states,
                  float* __restrict__ totals, int T_len, int n_chunks) {
  using Tl = OutTile<HS>;
  constexpr int NT = Tl::NT, JB = Tl::JB, SP = Tl::SP, OCG = Tl::OCG,
                RI = Tl::RI;
  extern __shared__ __align__(16) float smf[];
  float* k_s = smf;                  // [kSub][SP]
  float* lw_s = k_s + kSub * SP;
  float* kr = lw_s + kSub * SP;      // k_s 2^(sum_{s<m<t1} lw)
  float* v_s = kr + kSub * SP;       // [kSub][JB]
  float* dec = v_s + kSub * JB;      // [HS]

  const int bh = blockIdx.x / n_chunks, c = blockIdx.x % n_chunks;
  const int j0 = blockIdx.y * JB;
  const int tid = threadIdx.x;
  const int c0 = c * kChunk, c1 = min(T_len, c0 + kChunk);
  const size_t base = (size_t)bh * T_len * HS;
  const int q = tid % OCG, i0 = (tid / OCG) * RI;

  float z[RI][4];
#pragma unroll
  for (int a = 0; a < RI; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) z[a][b] = 0.f;
  float tot = 0.f;  // the scanning thread's column: sum_chunk lw

  Fetch<HS, T, false> in;
  in.fetch(nullptr, k, v, w, base, c0, min(kSub, c1 - c0), j0, tid);
  for (int t0 = c0; t0 < c1; t0 += kSub) {
    const int n = min(kSub, c1 - t0);
    __syncthreads();  // the previous sub-chunk's reads are done
    in.store(nullptr, k_s, lw_s, v_s, n, tid);
    if (t0 + kSub < c1)
      in.fetch(nullptr, k, v, w, base, t0 + kSub, min(kSub, c1 - t0 - kSub),
               j0, tid);
    __syncthreads();
    if (tid < HS) {  // reverse sums back from the sub-chunk's end
      const int i = tid;
      float lv[kSub], kv[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const int tt = min(t, n - 1);
        lv[t] = lw_s[tt * SP + i];
        kv[t] = k_s[tt * SP + i];
      }
      float acc = 0.f;
#pragma unroll
      for (int t = kSub - 1; t >= 0; --t)
        if (t < n) {
          kr[t * SP + i] = kv[t] * exp2f(acc);
          acc += lv[t];
        }
      dec[i] = exp2f(acc);
      tot += acc;
    }
    __syncthreads();
    if (tid < Tl::AUSED) {  // U <- diag(dec) U + kr^T v
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        const float d = dec[i0 + a];
#pragma unroll
        for (int b = 0; b < 4; ++b) z[a][b] *= d;
      }
      for (int s = 0; s < n; ++s) {
        const float4 v4 = *reinterpret_cast<const float4*>(v_s + s * JB +
                                                           4 * q);
#pragma unroll
        for (int a = 0; a < RI; ++a) {
          const float kk = kr[s * SP + i0 + a];
          z[a][0] = fmaf(kk, v4.x, z[a][0]);
          z[a][1] = fmaf(kk, v4.y, z[a][1]);
          z[a][2] = fmaf(kk, v4.z, z[a][2]);
          z[a][3] = fmaf(kk, v4.w, z[a][3]);
        }
      }
    }
  }
  if (tid < Tl::AUSED) {
    float* u = states + ((size_t)bh * n_chunks + c) * HS * HS + j0 + 4 * q;
#pragma unroll
    for (int a = 0; a < RI; ++a)
      *reinterpret_cast<float4*>(u + (size_t)(i0 + a) * HS) =
          make_float4(z[a][0], z[a][1], z[a][2], z[a][3]);
  }
  if (blockIdx.y == 0 && tid < HS)
    totals[((size_t)bh * n_chunks + c) * HS + tid] = tot;
}

// ---- 2: the chain over chunks, elementwise ---------------------------------

// S_0 = 0, S_{c+1} = diag(2^tot_c) S_c + U_c, one thread per 4 entries of a
// head's S; slot c of `states` holds U_c on entry and S_c on exit.  The
// U_c and tot_c of kChainBatch chunks are loaded before their steps run.
template <int HS>
__global__ void __launch_bounds__(128)
wkv6_chain_kernel(float* __restrict__ states,
                  const float* __restrict__ totals, float* __restrict__ s_out,
                  int BH, int n_chunks) {
  constexpr int Q = HS / 4;
  const int e = blockIdx.x * 128 + threadIdx.x;
  if (e >= BH * HS * Q) return;
  const int bh = e / (HS * Q), i = e / Q % HS, jq = e % Q;
  float4* st = reinterpret_cast<float4*>(
      states + (size_t)bh * n_chunks * HS * HS + i * HS + 4 * jq);
  const float* tt = totals + (size_t)bh * n_chunks * HS + i;
  constexpr int CS = HS * HS / 4;  // float4s from one chunk's slot to the next
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int cb = 0; cb < n_chunks; cb += kChainBatch) {
    float4 u[kChainBatch];
    float d[kChainBatch];
#pragma unroll
    for (int p = 0; p < kChainBatch; ++p) {
      const int c = min(cb + p, n_chunks - 1);
      u[p] = st[(size_t)c * CS];
      d[p] = exp2f(tt[(size_t)c * HS]);
    }
#pragma unroll
    for (int p = 0; p < kChainBatch; ++p)
      if (cb + p < n_chunks) {
        st[(size_t)(cb + p) * CS] = s;
        s.x = fmaf(d[p], s.x, u[p].x);
        s.y = fmaf(d[p], s.y, u[p].y);
        s.z = fmaf(d[p], s.z, u[p].z);
        s.w = fmaf(d[p], s.w, u[p].w);
      }
  }
  *reinterpret_cast<float4*>(s_out + (size_t)bh * HS * HS + i * HS + 4 * jq) =
      s;
}

// ---- 3: the outputs, in parallel --------------------------------------------

template <int HS, typename T>
__global__ void __launch_bounds__(OutTile<HS>::NT)
wkv6_output_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const T* __restrict__ u, const float* __restrict__ states,
                   float* __restrict__ o, int T_len, int n_chunks) {
  using Tl = OutTile<HS>;
  constexpr int NT = Tl::NT, JB = Tl::JB, SP = Tl::SP, SSP = Tl::SSP,
                SCP = Tl::SCP, DI = Tl::DI, OCG = Tl::OCG, OT = Tl::OT,
                ORG = Tl::ORG, RI = Tl::RI;
  extern __shared__ __align__(16) float smf[];
  float* r_s = smf;                  // [kSub][SP]
  float* k_s = r_s + kSub * SP;
  float* lw_s = k_s + kSub * SP;
  float* kr = lw_s + kSub * SP;      // k_s 2^(sum_{s<m<t1} lw)
  float* raT = kr + kSub * SP;       // [HS][SUBP]: r_t 2^(sum_{t0<=m<t} lw)
  float* Ss = raT + HS * Tl::SUBP;   // [HS][SSP]: S at the sub-chunk start
  float* v_s = Ss + HS * SSP;        // [kSub][JB]
  float* part = v_s + kSub * JB;     // [KS][kSub][JB]: partial ra . S0
  float* sc = part + Tl::KS * kSub * JB;  // [kSub][SCP]: pair weights a_ts
  float* dec = sc + kSub * SCP;      // [HS]
  float* u_s = dec + HS;             // [HS]

  const int bh = blockIdx.x / n_chunks, c = blockIdx.x % n_chunks;
  const int j0 = blockIdx.y * JB;
  const int tid = threadIdx.x;
  const int c0 = c * kChunk, c1 = min(T_len, c0 + kChunk);
  const size_t base = (size_t)bh * T_len * HS;

  // S_c by cp.async: first needed after the first sub-chunk's pair weights
  const float* sg = states + ((size_t)bh * n_chunks + c) * HS * HS + j0;
  for (int e = tid; e < HS * OCG; e += NT) {
    const int i = e / OCG, q = e % OCG;
    hopper::cp_async16(Ss + i * SSP + 4 * q, sg + (size_t)i * HS + 4 * q);
  }
  hopper::cp_async_commit();
  Fetch<HS, T, true> in;
  in.fetch(r, k, v, w, base, c0, min(kSub, c1 - c0), j0, tid);
  for (int i = tid; i < HS; i += NT) u_s[i] = to_f32(u[(size_t)bh * HS + i]);
  for (int t0 = c0; t0 < c1; t0 += kSub) {
    const int n = min(kSub, c1 - t0);
    __syncthreads();  // the previous sub-chunk's reads are done
    in.store(r_s, k_s, lw_s, v_s, n, tid);
    if (t0 + kSub < c1)
      in.fetch(r, k, v, w, base, t0 + kSub, min(kSub, c1 - t0 - kSub), j0,
               tid);
    __syncthreads();

    if (tid < HS) {  // forward and reverse sums inside the sub-chunk
      const int i = tid;
      float lv[kSub], rv[kSub], kv[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        const int tt = min(t, n - 1);
        lv[t] = lw_s[tt * SP + i];
        rv[t] = r_s[tt * SP + i];
        kv[t] = k_s[tt * SP + i];
      }
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < kSub; ++t)
        if (t < n) {
          raT[i * Tl::SUBP + t] = rv[t] * exp2f(acc);
          acc += lv[t];
        }
      acc = 0.f;
#pragma unroll
      for (int t = kSub - 1; t >= 0; --t)
        if (t < n) {
          kr[t * SP + i] = kv[t] * exp2f(acc);
          acc += lv[t];
        }
      dec[i] = exp2f(acc);
    }
    {  // pair weights: lane g of token t's LPT lanes owns rows g + LPT b
      constexpr int LPT = Tl::LPT;
      const int t = tid / LPT, g = tid % LPT;
      float rr[DI], acc[DI];
      float part = 0.f;
#pragma unroll
      for (int b = 0; b < DI; ++b) {
        const int i = g + LPT * b;
        rr[b] = r_s[t * SP + i];
        acc[b] = 0.f;
        part = fmaf(rr[b] * u_s[i], k_s[t * SP + i], part);
      }
#pragma unroll
      for (int m = 1; m < LPT; m <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, m);
      if (g == 0) {
        sc[t * SCP + t] = part;
        for (int s = t + 1; s < kSub; ++s) sc[t * SCP + s] = 0.f;
      }
      // diagonal d pairs (t, t - d), up to the warp's last token
      const int d_max = (tid / 32 + 1) * (32 / LPT) - 1;
      for (int d = 1; d <= d_max; ++d) {
        const int s = t - d;
        float p = 0.f;
        if (s >= 0) {
#pragma unroll
          for (int b = 0; b < DI; ++b) {
            const int i = g + LPT * b;
            p = fmaf(rr[b] * k_s[s * SP + i], exp2f(acc[b]), p);
            acc[b] += lw_s[s * SP + i];
          }
        }
#pragma unroll
        for (int m = 1; m < LPT; m <<= 1)
          p += __shfl_xor_sync(0xffffffffu, p, m);
        if (g == 0 && s >= 0) sc[t * SCP + s] = p;
      }
    }
    hopper::cp_async_wait<0>();  // S_c has landed (a no-op after the first)
    __syncthreads();

    if (tid < Tl::KUSED) {  // part = ra . S0 over one group of rows
      constexpr int KI = Tl::KI;
      const int q = tid % OCG, tg = tid / OCG % (kSub / 4);
      const int ks = tid / (OCG * (kSub / 4));
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 8
      for (int i = ks * KI; i < ks * KI + KI; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(raT + i * Tl::SUBP + 4 * tg);
        const float4 s4 =
            *reinterpret_cast<const float4*>(Ss + i * SSP + 4 * q);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float xa = comp(x, a);
          acc[a][0] = fmaf(xa, s4.x, acc[a][0]);
          acc[a][1] = fmaf(xa, s4.y, acc[a][1]);
          acc[a][2] = fmaf(xa, s4.z, acc[a][2]);
          acc[a][3] = fmaf(xa, s4.w, acc[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(part + (ks * kSub + 4 * tg + a) * JB +
                                   4 * q) =
            make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
    __syncthreads();  // the partials are written; every read of S0 is done

    if (tid < Tl::OUSED) {  // o = the partials' sum + a . v
      const int q = tid % OCG, org = tid / OCG;
      float acc[OT][4];
#pragma unroll
      for (int a = 0; a < OT; ++a) {
        const int t = org + ORG * a;
        float4 sum = *reinterpret_cast<const float4*>(part + t * JB + 4 * q);
#pragma unroll
        for (int ks = 1; ks < Tl::KS; ++ks) {
          const float4 p4 = *reinterpret_cast<const float4*>(
              part + (ks * kSub + t) * JB + 4 * q);
          sum.x += p4.x;
          sum.y += p4.y;
          sum.z += p4.z;
          sum.w += p4.w;
        }
        acc[a][0] = sum.x;
        acc[a][1] = sum.y;
        acc[a][2] = sum.z;
        acc[a][3] = sum.w;
      }
      for (int s = 0; s < n; ++s) {
        const float4 v4 = *reinterpret_cast<const float4*>(v_s + s * JB +
                                                           4 * q);
#pragma unroll
        for (int a = 0; a < OT; ++a) {
          const float p = sc[(org + ORG * a) * SCP + s];
          acc[a][0] = fmaf(p, v4.x, acc[a][0]);
          acc[a][1] = fmaf(p, v4.y, acc[a][1]);
          acc[a][2] = fmaf(p, v4.z, acc[a][2]);
          acc[a][3] = fmaf(p, v4.w, acc[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < OT; ++a) {
        const int t = org + ORG * a;
        if (t < n)
          *reinterpret_cast<float4*>(o + base + (size_t)(t0 + t) * HS + j0 +
                                     4 * q) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
    }
    if (t0 + kSub >= c1) break;  // the chunk's last sub-chunk: S0 unused
    if (tid < Tl::AUSED) {  // S0 <- diag(dec) S0 + kr^T v
      const int q = tid % OCG, i0 = (tid / OCG) * RI;
      float s4[RI][4];
#pragma unroll
      for (int a = 0; a < RI; ++a) {
        const float4 x = *reinterpret_cast<const float4*>(Ss + (i0 + a) * SSP +
                                                          4 * q);
        const float d = dec[i0 + a];
        s4[a][0] = x.x * d;
        s4[a][1] = x.y * d;
        s4[a][2] = x.z * d;
        s4[a][3] = x.w * d;
      }
      for (int s = 0; s < n; ++s) {
        const float4 v4 = *reinterpret_cast<const float4*>(v_s + s * JB +
                                                           4 * q);
#pragma unroll
        for (int a = 0; a < RI; ++a) {
          const float kk = kr[s * SP + i0 + a];
          s4[a][0] = fmaf(kk, v4.x, s4[a][0]);
          s4[a][1] = fmaf(kk, v4.y, s4[a][1]);
          s4[a][2] = fmaf(kk, v4.z, s4[a][2]);
          s4[a][3] = fmaf(kk, v4.w, s4[a][3]);
        }
      }
#pragma unroll
      for (int a = 0; a < RI; ++a)
        *reinterpret_cast<float4*>(Ss + (i0 + a) * SSP + 4 * q) =
            make_float4(s4[a][0], s4[a][1], s4[a][2], s4[a][3]);
    }
  }
}

template <int HS, typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* o, void* s,
                   void* states, void* totals, int BH, int T_len,
                   cudaStream_t stream) {
  using Tl = OutTile<HS>;
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  auto chunk_kernel = wkv6_chunk_kernel<HS, T>;
  auto out_kernel = wkv6_output_kernel<HS, T>;
  constexpr size_t chunk_smem =
      sizeof(float) * (3 * kSub * Tl::SP + kSub * Tl::JB + HS);
  cudaError_t err = cudaFuncSetAttribute(
      out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tl::SMEM);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory as shared memory: more blocks in flight
  err = cudaFuncSetAttribute(out_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH * n_chunks, HS / Tl::JB);
  chunk_kernel<<<grid, Tl::NT, chunk_smem, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<float*>(states),
      static_cast<float*>(totals), T_len, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_chain_kernel<HS><<<(BH * HS * HS / 4 + 127) / 128, 128, 0, stream>>>(
      static_cast<float*>(states), static_cast<const float*>(totals),
      static_cast<float*>(s), BH, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  out_kernel<<<grid, Tl::NT, Tl::SMEM, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const T*>(u), static_cast<const float*>(states),
      static_cast<float*>(o), T_len, n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* o, void* s,
                     void* states, void* totals, int BH, int T_len, int hs,
                     cudaStream_t st) {
#define WKV6_CASE(HS)                                                    \
  case HS:                                                               \
    return launch<HS, T>(r, k, v, w, u, o, s, states, totals, BH, T_len, \
                         st);
  switch (hs) {
    WKV6_CASE(8)
    WKV6_CASE(16)
    WKV6_CASE(32)
    WKV6_CASE(64)
    WKV6_CASE(128)
#undef WKV6_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v: (BH, T, hs) and u: (BH, hs) in fp32 (bf16 = 0) or bf16
// (bf16 = 1); w: (BH, T, hs) fp32; o: (BH, T, hs) fp32; s: (BH, hs, hs)
// fp32; scratch: states of BH x ceil(T / 64) x hs x hs fp32 and totals of
// BH x ceil(T / 64) x hs fp32.  All contiguous and 16-byte aligned.
// Returns a cudaError_t.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* o, void* s,
                        void* states, void* totals, int BH, int T_len,
                        int hs, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || T_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      bf16 ? dispatch<__nv_bfloat16>(r, k, v, w, u, o, s, states, totals, BH,
                                     T_len, hs, st)
           : dispatch<float>(r, k, v, w, u, o, s, states, totals, BH, T_len,
                             hs, st));
}
