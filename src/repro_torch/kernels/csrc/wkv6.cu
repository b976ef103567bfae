// RWKV-6 recurrence for Hopper (sm_90a).
//
// Replaces src/repro/kernels/wkv6.py:wkv6_folded (Pallas TPU kernel, body
// _wkv6_kernel) and computes what it computes, per head (bh) from S = 0:
//     o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] = w_t[i] * S[i][j] + k_t[i] * v_t[j]
// and returns o (BH, T, hs) and the final S (BH, hs, hs), both fp32.  All
// math is fp32 whatever the input type (r, k, v, u fp32 or bf16; w fp32).
//
// The TPU kernel re-expresses a chunk of tokens as matrix products, which
// divides k by a cumulative decay product that underflows for long chunks
// (why the registry leaves out block_t = 128).  This kernel steps token by
// token instead, which needs no division and takes no tile from block_t
// (the wrapper validates block_t as the reference does and ignores it).
//
// Design.  Column j of S depends only on v_t[j], so columns are split
// across blocks: block (bh, column group) owns JB = min(hs, 16) columns,
// and the hs rows of each column are split over kGroups = 4 adjacent lanes
// (lane g owns rows i = g, g + 4, g + 8, ...), so each thread keeps hs/4
// values of S in registers.  Per token a thread does hs/4 steps of
// acc += r_i S_ij, bonus += r_i u_i k_i, S_ij = w_i S_ij + k_i v_j; the
// four partial outputs of a column meet by two warp shuffles, with no
// block barrier per token.  r, k, w (all hs rows) and v (the block's
// columns) are staged in shared memory for L tokens at a time (26 KB at
// hs = 64), and
// the interleaved row ownership keeps the per-token reads of the four
// lanes on four distinct banks (broadcast to the other lanes).
//
// What bounds it: at rwkv6-3b width (BH = 40 at B = 1, T = 4096, hs = 64)
// the recurrence does about 5 hs^2 fp32 operations per token and head
// against 4 hs values read and hs written, so by the data sheet bytes and
// operations bound it about equally (PERF.md has the numbers beside the
// kernel's time on an H100).  What this simple design leaves on the table:
// the tokens of a head are strictly sequential inside one block, so at
// B = 1 the card has only 160 blocks of 2 warps (40 heads x 4 column
// groups) to run, one or two warps per SM; the per-token chain of dependent
// FMAs and shuffles is latency-bound, not throughput-bound.  The chunked
// form on tensor cores (with the decay kept in log space) is the way past
// that, in a later change.
//
// The kernel launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (the wrapper raises on non-zero).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kGroups = 4;  // lanes that share one column, split over rows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int HS>
struct Tile {
  static constexpr int JB = HS < 16 ? HS : 16;              // columns/block
  static constexpr int L = (2048 / HS) < 64 ? (2048 / HS) : 64;  // tokens
  static constexpr int R = HS / kGroups;                    // rows/thread
  static constexpr int NT = JB * kGroups;                   // threads
};

template <int HS, typename T>
__global__ void __launch_bounds__(Tile<HS>::NT)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const T* __restrict__ u, float* __restrict__ o,
            float* __restrict__ s_out, int T_len) {
  constexpr int JB = Tile<HS>::JB, L = Tile<HS>::L, R = Tile<HS>::R,
                NT = Tile<HS>::NT;
  __shared__ float r_s[L][HS];
  __shared__ float k_s[L][HS];
  __shared__ float w_s[L][HS];
  __shared__ float v_s[L][JB];

  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * JB;
  const int tid = threadIdx.x;
  const int g = tid % kGroups;
  const int jl = tid / kGroups;
  const int j = j0 + jl;
  const size_t base = (size_t)bh * T_len * HS;

  float S[R], uu[R];
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    S[ii] = 0.f;
    uu[ii] = to_f32(u[(size_t)bh * HS + g + kGroups * ii]);
  }

  for (int t0 = 0; t0 < T_len; t0 += L) {
    const int n = min(L, T_len - t0);
    __syncthreads();  // the previous chunk has been consumed
    for (int e = tid; e < n * HS; e += NT) {
      const int tt = e / HS, i = e % HS;
      const size_t off = base + (size_t)(t0 + tt) * HS + i;
      r_s[tt][i] = to_f32(r[off]);
      k_s[tt][i] = to_f32(k[off]);
      w_s[tt][i] = w[off];
    }
    for (int e = tid; e < n * JB; e += NT) {
      const int tt = e / JB, jj = e % JB;
      v_s[tt][jj] = to_f32(v[base + (size_t)(t0 + tt) * HS + j0 + jj]);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = v_s[tt][jl];
      float acc = 0.f, bonus = 0.f;
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const int i = g + kGroups * ii;
        const float ri = r_s[tt][i], ki = k_s[tt][i], wi = w_s[tt][i];
        acc = fmaf(ri, S[ii], acc);
        bonus = fmaf(ri * uu[ii], ki, bonus);
        S[ii] = fmaf(wi, S[ii], ki * vj);
      }
      float part = fmaf(bonus, vj, acc);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (g == 0) o[base + (size_t)(t0 + tt) * HS + j] = part;
    }
  }
#pragma unroll
  for (int ii = 0; ii < R; ++ii)
    s_out[(size_t)bh * HS * HS + (size_t)(g + kGroups * ii) * HS + j] =
        S[ii];
}

template <int HS, typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* o, void* s, int BH, int T_len,
           cudaStream_t stream) {
  const dim3 grid(BH, HS / Tile<HS>::JB);
  wkv6_kernel<HS, T><<<grid, Tile<HS>::NT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const T*>(u), static_cast<float*>(o),
      static_cast<float*>(s), T_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, void* o, void* s, int BH, int T_len, int hs,
             cudaStream_t stream) {
  switch (hs) {
    case 8: return launch<8, T>(r, k, v, w, u, o, s, BH, T_len, stream);
    case 16: return launch<16, T>(r, k, v, w, u, o, s, BH, T_len, stream);
    case 32: return launch<32, T>(r, k, v, w, u, o, s, BH, T_len, stream);
    case 64: return launch<64, T>(r, k, v, w, u, o, s, BH, T_len, stream);
    case 128: return launch<128, T>(r, k, v, w, u, o, s, BH, T_len, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v: (BH, T, hs) and u: (BH, hs) in fp32 (bf16 = 0) or bf16
// (bf16 = 1); w: (BH, T, hs) fp32; o: (BH, T, hs) fp32; s: (BH, hs, hs)
// fp32.  All contiguous.  Returns a cudaError_t.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, void* o, void* s,
                        int BH, int T_len, int hs, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || T_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? dispatch<__nv_bfloat16>(r, k, v, w, u, o, s, BH, T_len, hs,
                                        st)
              : dispatch<float>(r, k, v, w, u, o, s, BH, T_len, hs, st);
}
