// Causal / sliding-window GQA flash attention forward in bf16 on Hopper's
// tensor cores (sm_90a): TMA loads, mbarrier pipeline, wgmma.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention_folded
// (Pallas TPU kernel, body _flash_kernel) for bf16 inputs with head dim
// D in {64, 128, 256}; csrc/flash_attention.cu (fp32 math on the CUDA
// cores) keeps every other case.  It computes what _flash_kernel computes
// on the same folded layout: q (BK, S, G, D) pre-scaled by 1/sqrt(D),
// k, v (BK, T, D), o (BK, S, G, D); for one bk the (S, G) rows of q are
// one (S*G, D) matrix whose row r sits at query position r / G.  Masked
// scores are set to -1e30, keys at or past T weigh nothing, and the
// output is divided by max(l, 1e-30).  The products take bf16 in and sum
// in fp32; before P.V the softmax weights P are rounded to bf16 (the one
// rounding the fp32 route does not make: about 2^-9 of each weight).
//
// What bounds it: at qwen2.5-14b's width (S = T = 4096, G = 5, D = 128)
// it does about 860 FLOP per byte it must move, far above the H100's bf16
// ridge (989 TFLOP/s over 3.35 TB/s, about 295 FLOP/B): it is bound by
// tensor-core operations.  The design keeps the tensor cores fed:
//   * a block owns 128 rows of the (S*G) row space: two consumer
//     warpgroups of 64 rows each share every K/V chunk, and a producer
//     warpgroup (one thread of it) starts all loads.  A K/V chunk is BC keys: 128 at D <= 128
//     (the S = Q.K^T product is then one m64n128 wgmma per k-step), 64 at
//     D = 256 so that Q (64 KB) and a 2-stage K/V ring (128 KB) fit the
//     227 KB a block may use.  One block fills an SM's shared memory, and
//     its two warpgroups overlap one's softmax with the other's products;
//   * TMA copies Q once and K/V chunk by chunk into a 2-stage ring.  Each
//     stage has a "full" mbarrier (expect_tx bytes, phase bit) and an
//     "empty" one the 256 consumer threads arrive on, so chunk j + 1 is
//     in flight while chunk j is computed;
//   * S = Q.K^T by wgmma m64nBCk16 with both operands in shared memory,
//     K-major, 128-byte swizzle; O += P.V by wgmma m64nDk16 with P in
//     registers (the S accumulator's layout is the A operand's, so P is
//     only packed to bf16x2) and V, stored keys x D, read MN-major;
//   * the online softmax runs on the accumulator fragment in registers, in
//     the log2 domain (exp2 on the MUFU unit); each row's max is reduced
//     over the 4 lanes that share it, its sum only once at the end.  The
//     mask is applied only to chunks that cross the diagonal, the window
//     edge or T;
//   * key chunks the mask hides for all of a block's rows are skipped and
//     row tiles are scheduled latest first, as in csrc/flash_attention.cu
//     (skipping is off when some row has no valid key at all).
//
// Where the trouble was (see also hopper.cuh):
//   1. The tensor maps are encoded on the host by cuTensorMapEncodeTiled,
//      which lives in libcuda: -lcuda, passed for this kernel alone.  They are
//      3-D (D, rows, BK), so TMA's zero fill ends each bk's ragged tail at
//      its own edge and never reads the next bk's rows; zero-filled keys
//      past T still get weight 0 (their scores are set to -inf).  D is
//      loaded in 64-wide (128-byte) slabs, the most a 128-byte-swizzled box
//      may span; every tile is aligned to 1024 bytes.
//   2. The wgmma descriptors must match TMA's swizzled layout exactly
//      (hopper.cuh); a mismatch gives wrong numbers, not an error.
//   3. Ordering: P is packed before wgmma.fence; accumulators are fenced
//      against the compiler (hopper::fence_regs) around every product and
//      read only after wgmma.wait_group.
//   4. Registers at D = 256: O is 64 x 256 fp32 per warpgroup, 128
//      registers a thread, beside S (32) and P (16).  A block of 384
//      threads starts at 168 registers a thread (each of the SM's four
//      register banks holds 3 of its 12 warps), too few: ptxas spilled
//      and serialised the wgmmas.  So the producer warpgroup gives
//      registers back (setmaxnreg.dec to 40) and the consumers take them
//      (setmaxnreg.inc to 232), in one if / else that never reconverges.
//      With a lone producer warp (288 threads) the limit was 168 too.
//   5. G does not divide 64 (G = 5, 10): the mask works per row from
//      r / G, and a tile's rows span ceil(128 / G) + 1 query positions.
//
// The kernel launches on the caller's stream, allocates nothing and
// returns a cudaError_t, or the negated CUresult if a tensor map cannot be
// encoded (the wrapper raises on non-zero).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::desc_sw128;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_wait;
using hopper::Wgmma;

constexpr int kConsumers = 2;                       // consumer warpgroups
constexpr int kWGRows = 64;                         // rows per warpgroup
constexpr int kBlockRows = kConsumers * kWGRows;    // 128
constexpr int kConsumerThreads = kConsumers * 128;  // 256
constexpr int kThreads = kConsumerThreads + 128;    // + a producer warpgroup
constexpr int kProducerRegs = 40;                   // setmaxnreg targets:
constexpr int kConsumerRegs = 232;                  // 40 + 2 x 232 <= 512
constexpr int kStages = 2;                          // K/V ring depth
constexpr int kSlab = 64;           // bf16 columns per 128-byte swizzled row
constexpr int kRowBytes = 128;
constexpr int kAtomBytes = 8 * kRowBytes;  // 8 swizzled rows
constexpr float kNegInf = -1e30f;          // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int BC = D == 256 ? 64 : 128;     // keys per chunk
  static constexpr int kSlabs = D / kSlab;
  static constexpr int kQSlabBytes = kWGRows * kRowBytes;
  static constexpr int kQBytes = kWGRows * D * 2;    // one warpgroup's Q
  static constexpr int kKVSlabBytes = BC * kRowBytes;
  static constexpr int kKVBytes = BC * D * 2;        // K (or V), one stage
  static constexpr int kBarriers = 1 + 2 * kStages;
  // 1024 bytes of slack to align the tiles
  static constexpr size_t kSmem = 1024 + kConsumers * kQBytes +
                                  2 * kStages * kKVBytes + 8 * kBarriers;
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int T, int causal,
                                        int window) {
  return kpos < T && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(__grid_constant__ const CUtensorMap tm_q,
                      __grid_constant__ const CUtensorMap tm_k,
                      __grid_constant__ const CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, int S, int T, int G,
                      int causal, int window) {
  using Tl = Tiles<D>;
  constexpr int BC = Tl::BC;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;                              // [wg][slab][64][128 B]
  uint8_t* k_s = q_s + kConsumers * Tl::kQBytes;    // [stage][slab][BC][128 B]
  uint8_t* v_s = k_s + kStages * Tl::kKVBytes;      // [stage][slab][BC][128 B]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * Tl::kKVBytes);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kStages;

  const int tid = threadIdx.x;
  const int bk = blockIdx.y;
  const int n_rows = S * G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;

  // key chunks to sweep: skip those the mask hides for every row of the
  // block (the last row's best key decides whether every row has one)
  const int last_row = min(row0 + kBlockRows, n_rows) - 1;
  const int qpos_lo = row0 / G, qpos_hi = last_row / G;
  int t_begin = 0, t_end = T;
  const int kbest = causal ? min(qpos_hi, T - 1) : T - 1;
  if (visible(qpos_hi, kbest, T, causal, window)) {
    if (causal) t_end = min(T, qpos_hi + 1);
    if (window > 0) t_begin = max(0, qpos_lo - window + 1) / BC * BC;
  }
  const int n_chunks = (t_end - t_begin + BC - 1) / BC;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&kv_full[s], 1);
      hopper::mbar_init(&kv_empty[s], kConsumerThreads);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // producer warpgroup: one thread starts every TMA load
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid != kConsumerThreads) return;
    mbar_expect_tx(q_full, kConsumers * Tl::kQBytes);
    for (int w = 0; w < kConsumers; ++w)
      for (int sl = 0; sl < Tl::kSlabs; ++sl)
        hopper::tma_load_3d(q_s + w * Tl::kQBytes + sl * Tl::kQSlabBytes,
                            &tm_q, q_full, sl * kSlab, row0 + w * kWGRows,
                            bk);
    for (int j = 0; j < n_chunks; ++j) {
      const int st = j % kStages;
      if (j >= kStages) mbar_wait(&kv_empty[st], (j / kStages - 1) & 1);
      mbar_expect_tx(&kv_full[st], 2 * Tl::kKVBytes);
      const int t0 = t_begin + j * BC;
      for (int sl = 0; sl < Tl::kSlabs; ++sl) {
        const int off = st * Tl::kKVBytes + sl * Tl::kKVSlabBytes;
        hopper::tma_load_3d(k_s + off, &tm_k, &kv_full[st], sl * kSlab, t0,
                            bk);
        hopper::tma_load_3d(v_s + off, &tm_v, &kv_full[st], sl * kSlab, t0,
                            bk);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows row0 + 64 wg + [0, 64)
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int c = lane % 4;
  const int row_a = row0 + wg * kWGRows + warp * 16 + lane / 4;  // and +8
  const int qpos[2] = {row_a / G, (row_a + 8) / G};
  const uint8_t* q_tile = q_s + wg * Tl::kQBytes;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_chunks; ++j) {
    const int st = j % kStages;
    const int t0 = t_begin + j * BC;
    const uint8_t* k_tile = k_s + st * Tl::kKVBytes;
    const uint8_t* v_tile = v_s + st * Tl::kKVBytes;
    mbar_wait(&kv_full[st], (j / kStages) & 1);

    // s = q . k^T over D in k-steps of 16 (32 bytes of a swizzled row)
    float s[BC / 2];
    fence_regs(s);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk % 4) * 32;
      const uint64_t da =
          desc_sw128(q_tile + (kk / 4) * Tl::kQSlabBytes + off, 16,
                     kAtomBytes);
      const uint64_t db =
          desc_sw128(k_tile + (kk / 4) * Tl::kKVSlabBytes + off, 16,
                     kAtomBytes);
      Wgmma<BC>::ss(s, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(s);

    // mask (only where the chunk crosses the diagonal, the window edge or
    // T) and online softmax in the log2 domain; element i of s is row
    // (i / 2) % 2, key t0 + 8 (i / 4) + 2 c + i % 2
    const bool need_mask = t0 + BC > T || (causal && t0 + BC - 1 > qpos_lo) ||
                           (window > 0 && qpos_hi - t0 >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) {
      float x = s[i] * kLog2e;
      if (need_mask) {
        const int key = t0 + (i / 4) * 8 + 2 * c + (i % 2);
        // keys past T are padding, not masked keys: they weigh nothing
        if (key >= T)
          x = __int_as_float(0xff800000);  // -inf
        else if (!visible(qpos[(i / 2) % 2], key, T, causal, window))
          x = kNegInf;
      }
      s[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2_approx(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) {
      s[i] = exp2_approx(s[i] - m[(i / 2) % 2]);
      l[(i / 2) % 2] += s[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];

    // o += p . v: p packed to bf16 as wgmma's register A operand (done
    // before the fence), v MN-major, 16 keys (2048 bytes) per k-step
    uint32_t p[BC / 16][4];
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        p[kk][h] = pack_bf16(s[8 * kk + 2 * h], s[8 * kk + 2 * h + 1]);
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) fence_regs(p[kk]);
    fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) {
      const uint64_t db = desc_sw128(v_tile + kk * 16 * kRowBytes,
                                     Tl::kKVSlabBytes, kAtomBytes);
      Wgmma<D>::rs(acc, p[kk], db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&kv_empty[st]);
  }

  // epilogue: the row sums meet over the row's 4 lanes, then o = acc / l
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = o + (size_t)bk * n_rows * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(&ob[(size_t)row * D + 8 * j + 2 * c]) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r],
                                acc[4 * j + 2 * r + 1] * inv[r]);
  }
}

// a 3-D map (D, rows, BK) over a contiguous bf16 tensor, loaded in boxes of
// 64 columns x box_rows rows of one bk, 128-byte swizzled, zero fill
CUresult make_map(CUtensorMap* map, const void* base, int D, int rows,
                  int BK, int box_rows) {
  cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)BK};
  cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  cuuint32_t box[3] = {(cuuint32_t)kSlab, (cuuint32_t)box_rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BK,
           int S, int T, int G, int causal, int window, cudaStream_t stream) {
  using Tl = Tiles<D>;
  CUtensorMap mq, mk, mv;
  CUresult res = make_map(&mq, q, D, S * G, BK, kWGRows);
  if (res == CUDA_SUCCESS) res = make_map(&mk, k, D, T, BK, Tl::BC);
  if (res == CUDA_SUCCESS) res = make_map(&mv, v, D, T, BK, Tl::BC);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  auto kernel = flash_fwd_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S * G + kBlockRows - 1) / kBlockRows, BK);
  kernel<<<grid, kThreads, Tl::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, T, G, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o bf16, contiguous, 16-byte aligned; D in {64, 128, 256}.
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k,
                                        const void* v, void* o, int BK, int S,
                                        int T, int G, int D, int causal,
                                        int window, void* stream) {
  if (BK == 0 || S == 0 || G == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0)  // no keys: every row's sum is 0, so o = 0 / 1e-30 = 0
    return static_cast<int>(cudaMemsetAsync(
        o, 0, (size_t)BK * S * G * D * sizeof(__nv_bfloat16), st));
  switch (D) {
    case 64: return launch<64>(q, k, v, o, BK, S, T, G, causal, window, st);
    case 128: return launch<128>(q, k, v, o, BK, S, T, G, causal, window, st);
    case 256: return launch<256>(q, k, v, o, BK, S, T, G, causal, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
