// Causal / sliding-window GQA flash attention, forward and backward, in
// bf16 on Hopper's tensor cores (sm_90a): TMA loads, mbarrier pipeline,
// wgmma.  The forward's note comes first, the backward's further down.
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
// The forward also writes each row's log-sum-exp for the backward, when the
// wrapper passes a non-null `lse` (forward-only callers pass null and
// write nothing more): fp32, natural log, lse[bk * lse_stride + r] for row
// r < S*G of the (S*G) row space, so that P = exp(s - lse) for a visible
// score s (the backward works in the log2 domain, exp2((s - lse) log2 e)).
//
// The backward (flash_attention_bwd_sm90, below) has its own note.
//
// The kernels launch on the caller's stream, allocate nothing and return
// a cudaError_t, or the negated CUresult if a tensor map cannot be encoded
// (the wrapper raises on non-zero).

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
constexpr float kLn2 = 0.6931471805599453f;

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
                      __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int lse_stride, int S, int T,
                      int G, int causal, int window) {
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
    if (lse != nullptr && c == 0)  // m is in the log2 domain
      lse[(size_t)bk * lse_stride + row] = (m[r] + log2f(l[r])) * kLn2;
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
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int lse_stride, int BK, int S, int T, int G, int causal,
           int window, cudaStream_t stream) {
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
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, lse_stride, S, T, G,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward.  It replaces no Pallas kernel: the reference differentiates
// its kernel by a blockwise recompute (src/repro/kernels/ops.py,
// _flash_bwd, whose note leaves the slot for "a dedicated bwd kernel"), as
// the port did before.  Like the forward it is bound by tensor-core
// operations (five products of the forward's size where the forward makes
// two).  Given o, dO = dL/do and the forward's lse, on the same folded
// layout (q pre-scaled, so s = q.k^T and dq is dL/dq of the folded q):
//   P = exp(s - lse), delta = rowsum(dO o), dP = dO.V^T, dS = P (dP - delta)
//   dV = P^T.dO, dK = dS^T.q, dq = dS.K
// as in FlashAttention-2, in two passes over the (S*G) x T score matrix,
// each on the tensor cores with the forward's pipeline (a producer
// warpgroup of TMA loads into an mbarrier ring, two consumer warpgroups of
// 64 rows running wgmma, setmaxnreg 40 / 232):
//   1. flash_bwd_dq_sm90_kernel: a block owns 128 rows, as the forward does,
//      and walks the key chunks (64 keys) they see.  Its threads first
//      compute delta for their rows from o and dO in global memory and
//      write it out for pass 2.  Per chunk: S = Q.K^T and dP = dO.V^T (two
//      ss wgmmas, K and V K-major), then P and dS in registers, then
//      dQ += dS.K (rs wgmma, K read MN-major).
//   2. flash_bwd_dkdv_sm90_kernel: a block owns 128 keys (64 a consumer
//      warpgroup), keeps its K and V in shared memory and dK, dV in fp32
//      registers, and walks the 64-row tiles of the (S*G) row space that
//      see those keys.  Per tile: S^T = K.Q^T and dP^T = V.dO^T (ss), then
//      P^T and dS^T in registers, then dV += P^T.dO and dK += dS^T.Q (rs,
//      Q and dO read MN-major).  The G query heads of a KV head are rows of
//      that one row space, so GQA's sum over them happens in this loop.
// dq takes a pass of its own, recomputing S and dP (7 products where one
// pass with atomics would make 5), because it is deterministic: a step
// gives the same bits on every run, which the port's bitwise checks of a
// train step (a restart, the offloaded update against the on-card one)
// rely on; fp32 atomics into a scratch of BK*S*G*D*4 bytes (100 MB at
// train-4k) and a conversion pass would add in no fixed order.  Both passes skip the tiles the mask hides for every row (pass 1
// the forward's way; pass 2 from the first row that sees the block's first
// key to the last that sees its last), and schedule the heaviest first
// (pass 1 latest rows first, pass 2 first keys first).
//
// Precision: operands bf16, every accumulator fp32, lse and delta fp32;
// P and dS are rounded to bf16 just before their products, as the forward
// rounds P.  Every row must see a key (the wrapper routes shapes where a
// row sees none, S - T >= window > 0, to the blockwise recompute), so a
// masked score's P is exactly 0; masked pairs and rows or keys past the
// ends are set to P = dS = 0.  lse and delta are rows of lse_stride floats
// a bk, lse_stride at least S*G rounded up to a multiple of 128, with a
// zero padding: every 128-row block reads its rows' lse whole, and pass 2
// loads a 64-row tile's 256 bytes of each by TMA with the tile.
//
// D = 64 and 128.  At D = 256 dK and dV would take 256 fp32 registers a
// thread in a 64-key warpgroup: that shape stays on the blockwise
// recompute (the wrapper's bwd_route).

constexpr int kBwdTile = 64;      // rows (pass 2) or keys (pass 1) a step
constexpr int kBwdStages = 2;

template <int D>
struct BwdTiles {
  static constexpr int kSlabs = D / kSlab;
  static constexpr int kSlabBytes = kBwdTile * kRowBytes;   // 64 rows
  static constexpr int kTileBytes = kBwdTile * D * 2;       // 64 rows x D
  // pass 1: Q and dO of 2 warpgroups, a ring of K and V chunks
  static constexpr size_t kSmemDq = 1024 + 2 * kConsumers * kTileBytes +
                                    2 * kBwdStages * kTileBytes +
                                    8 * (1 + 2 * kBwdStages);
  // pass 2: K and V of 2 warpgroups, a ring of Q, dO, lse and delta tiles
  // Q, dO, then lse and delta (2 x 256 B) padded to keep tiles 1024-aligned
  static constexpr int kStageBytes = 2 * kTileBytes + 1024;
  static constexpr size_t kSmemDkdv = 1024 + 2 * kConsumers * kTileBytes +
                                      kBwdStages * kStageBytes +
                                      8 * (1 + 2 * kBwdStages);
};

// acc (+)= A . B^T, M = 64 rows of A, N = 64 rows of B, over D: both tiles
// K-major, 64-row slabs of 128 swizzled bytes
template <int D>
__device__ __forceinline__ void product_ss(float (&acc)[32], const uint8_t* a,
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * BwdTiles<D>::kSlabBytes + (kk % 4) * 32;
    Wgmma<64>::ss(acc, desc_sw128(a + off, 16, kAtomBytes),
                  desc_sw128(b + off, 16, kAtomBytes), kk > 0);
  }
}

// acc += A[regs] . B, K = 64 (4 k-steps of 16), B a 64-row tile read
// MN-major (D contiguous)
template <int D>
__device__ __forceinline__ void product_rs(float (&acc)[D / 2],
                                           const uint32_t (&a)[4][4],
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<D>::rs(acc, a[kk],
                 desc_sw128(b + kk * 16 * kRowBytes, BwdTiles<D>::kSlabBytes,
                            kAtomBytes));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90_kernel(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_do,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int lse_stride, int S,
                         int T, int G, int causal, int window) {
  using Tl = BwdTiles<D>;
  constexpr int BC = kBwdTile;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;                                // [wg][slab][64][128 B]
  uint8_t* do_s = q_s + kConsumers * Tl::kTileBytes;  // [wg][slab][64][128 B]
  uint8_t* k_s = do_s + kConsumers * Tl::kTileBytes;  // [stage][slab][64][..]
  uint8_t* v_s = k_s + kBwdStages * Tl::kTileBytes;   // [stage][slab][64][..]
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(v_s + kBwdStages * Tl::kTileBytes);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kBwdStages;

  const int tid = threadIdx.x;
  const int bk = blockIdx.y;
  const int n_rows = S * G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;

  // key chunks the block's rows see, as the forward bounds them
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
    for (int s = 0; s < kBwdStages; ++s) {
      hopper::mbar_init(&kv_full[s], 1);
      hopper::mbar_init(&kv_empty[s], kConsumerThreads);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid != kConsumerThreads) return;
    mbar_expect_tx(q_full, 2 * kConsumers * Tl::kTileBytes);
    for (int w = 0; w < kConsumers; ++w)
      for (int sl = 0; sl < Tl::kSlabs; ++sl) {
        const int off = w * Tl::kTileBytes + sl * Tl::kSlabBytes;
        hopper::tma_load_3d(q_s + off, &tm_q, q_full, sl * kSlab,
                            row0 + w * kWGRows, bk);
        hopper::tma_load_3d(do_s + off, &tm_do, q_full, sl * kSlab,
                            row0 + w * kWGRows, bk);
      }
    for (int j = 0; j < n_chunks; ++j) {
      const int st = j % kBwdStages;
      if (j >= kBwdStages) mbar_wait(&kv_empty[st], (j / kBwdStages - 1) & 1);
      mbar_expect_tx(&kv_full[st], 2 * Tl::kTileBytes);
      const int t0 = t_begin + j * BC;
      for (int sl = 0; sl < Tl::kSlabs; ++sl) {
        const int off = st * Tl::kTileBytes + sl * Tl::kSlabBytes;
        hopper::tma_load_3d(k_s + off, &tm_k, &kv_full[st], sl * kSlab, t0,
                            bk);
        hopper::tma_load_3d(v_s + off, &tm_v, &kv_full[st], sl * kSlab, t0,
                            bk);
      }
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int c = lane % 4;
  const int row_a = row0 + wg * kWGRows + warp * 16 + lane / 4;  // and +8
  const int qpos[2] = {row_a / G, (row_a + 8) / G};
  const uint8_t* q_tile = q_s + wg * Tl::kTileBytes;
  const uint8_t* do_tile = do_s + wg * Tl::kTileBytes;

  // delta = rowsum(dO o) of this thread's two rows, each summed over the
  // 4 lanes that share it (lane c takes D / 4 contiguous columns), and
  // each row's lse in the log2 domain
  float dl[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    float sum = 0.f;
    if (row < n_rows) {
      const size_t base = ((size_t)bk * n_rows + row) * D + c * (D / 4);
      const uint4* po = reinterpret_cast<const uint4*>(o + base);
      const uint4* pd = reinterpret_cast<const uint4*>(dout + base);
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        const uint4 a = po[j], b = pd[j];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 x = __bfloat1622float2(a2[h]);
          const float2 y = __bfloat1622float2(b2[h]);
          sum = fmaf(x.x, y.x, fmaf(x.y, y.y, sum));
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    dl[r] = sum;
    // rows past n_rows read the zeroed padding: finite, never written
    lse2[r] = lse[(size_t)bk * lse_stride + row] * kLog2e;
    if (row < n_rows && c == 0) delta[(size_t)bk * lse_stride + row] = sum;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_chunks; ++j) {
    const int st = j % kBwdStages;
    const int t0 = t_begin + j * BC;
    const uint8_t* k_tile = k_s + st * Tl::kTileBytes;
    const uint8_t* v_tile = v_s + st * Tl::kTileBytes;
    mbar_wait(&kv_full[st], (j / kBwdStages) & 1);

    // s = q . k^T and dp = dO . v^T, both over D
    float s[BC / 2], dp[BC / 2];
    fence_regs(s);
    fence_regs(dp);
    hopper::wgmma_fence();
    product_ss<D>(s, q_tile, k_tile);
    product_ss<D>(dp, do_tile, v_tile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // p = exp2((s - lse) log2 e), 0 where masked; ds = p (dp - delta),
    // packed to bf16 as the A operand of dq += ds . k; element i is row
    // (i / 2) % 2, key t0 + 8 (i / 4) + 2 c + i % 2
    const bool need_mask = t0 + BC > T || (causal && t0 + BC - 1 > qpos_lo) ||
                           (window > 0 && qpos_hi - t0 >= window);
    uint32_t ds[BC / 16][4];
#pragma unroll
    for (int i = 0; i < BC / 2; i += 2) {
      float d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = (i / 2) % 2;
        float p = exp2_approx(fmaf(s[i + e], kLog2e, -lse2[r]));
        if (need_mask) {
          const int key = t0 + (i / 4) * 8 + 2 * c + e;
          if (!visible(qpos[r], key, T, causal, window)) p = 0.f;
        }
        d2[e] = p * (dp[i + e] - dl[r]);
      }
      ds[i / 8][(i % 8) / 2] = pack_bf16(d2[0], d2[1]);
    }
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk) fence_regs(ds[kk]);
    fence_regs(acc);
    hopper::wgmma_fence();
    product_rs<D>(acc, ds, k_tile);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&kv_empty[st]);
  }

  __nv_bfloat16* gb = dq + (size_t)bk * n_rows * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = (size_t)row * D + 8 * j + 2 * c;
      *reinterpret_cast<__nv_bfloat162*>(&gb[at]) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_sm90_kernel(__grid_constant__ const CUtensorMap tm_q,
                           __grid_constant__ const CUtensorMap tm_do,
                           __grid_constant__ const CUtensorMap tm_k,
                           __grid_constant__ const CUtensorMap tm_v,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int lse_stride,
                           int S, int T, int G, int causal, int window) {
  using Tl = BwdTiles<D>;
  constexpr int BR = kBwdTile;  // rows a tile

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = smem;                                // [wg][slab][64][128 B]
  uint8_t* v_s = k_s + kConsumers * Tl::kTileBytes;   // [wg][slab][64][128 B]
  uint8_t* ring = v_s + kConsumers * Tl::kTileBytes;  // [stage] q dO lse delta
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(ring + kBwdStages * Tl::kStageBytes);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kBwdStages;

  const int tid = threadIdx.x;
  const int bk = blockIdx.y;
  const int n_rows = S * G;
  const int key0 = blockIdx.x * kBlockRows;  // first keys first: most rows

  // row tiles that see a key of the block: from the first row at or past
  // the first key (causal) to the last row inside the last key's window
  const int kmax = min(key0 + kBlockRows, T) - 1;
  const long long r_begin = causal ? (long long)key0 * G : 0;
  const long long r_end =
      window > 0 ? min((long long)n_rows, ((long long)kmax + window) * G)
                 : (long long)n_rows;
  const int j_begin = (int)(r_begin / BR);
  const int n_tiles =
      r_end > r_begin ? (int)((r_end + BR - 1) / BR) - j_begin : 0;

  if (tid == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerThreads);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (tid != kConsumerThreads) return;
    mbar_expect_tx(kv_full, 2 * kConsumers * Tl::kTileBytes);
    for (int w = 0; w < kConsumers; ++w)
      for (int sl = 0; sl < Tl::kSlabs; ++sl) {
        const int off = w * Tl::kTileBytes + sl * Tl::kSlabBytes;
        hopper::tma_load_3d(k_s + off, &tm_k, kv_full, sl * kSlab,
                            key0 + w * kWGRows, bk);
        hopper::tma_load_3d(v_s + off, &tm_v, kv_full, sl * kSlab,
                            key0 + w * kWGRows, bk);
      }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kBwdStages;
      if (j >= kBwdStages) mbar_wait(&empty[st], (j / kBwdStages - 1) & 1);
      mbar_expect_tx(&full[st], 2 * Tl::kTileBytes + 2 * BR * 4);
      const int r0 = (j_begin + j) * BR;
      uint8_t* q_t = ring + st * Tl::kStageBytes;
      uint8_t* do_t = q_t + Tl::kTileBytes;
      uint8_t* rows_t = do_t + Tl::kTileBytes;
      for (int sl = 0; sl < Tl::kSlabs; ++sl) {
        hopper::tma_load_3d(q_t + sl * Tl::kSlabBytes, &tm_q, &full[st],
                            sl * kSlab, r0, bk);
        hopper::tma_load_3d(do_t + sl * Tl::kSlabBytes, &tm_do, &full[st],
                            sl * kSlab, r0, bk);
      }
      const size_t at = (size_t)bk * lse_stride + r0;
      hopper::bulk_load(rows_t, lse + at, BR * 4, &full[st]);
      hopper::bulk_load(rows_t + BR * 4, delta + at, BR * 4, &full[st]);
    }
    return;
  }

  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int c = lane % 4;
  const int kw0 = key0 + wg * kWGRows;              // this warpgroup's keys
  const int key_a = kw0 + warp * 16 + lane / 4;     // and +8
  const uint8_t* k_tile = k_s + wg * Tl::kTileBytes;
  const uint8_t* v_tile = v_s + wg * Tl::kTileBytes;

  float gk[D / 2], gv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) gk[i] = gv[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kBwdStages;
    const int r0 = (j_begin + j) * BR;
    const uint8_t* q_t = ring + st * Tl::kStageBytes;
    const uint8_t* do_t = q_t + Tl::kTileBytes;
    const float* lse_t = reinterpret_cast<const float*>(do_t + Tl::kTileBytes);
    const float* delta_t = lse_t + BR;
    mbar_wait(&full[st], (j / kBwdStages) & 1);

    // s^T = k . q^T and dp^T = v . dO^T, both over D
    float s[BR / 2], dp[BR / 2];
    fence_regs(s);
    fence_regs(dp);
    hopper::wgmma_fence();
    product_ss<D>(s, k_tile, q_t);
    product_ss<D>(dp, v_tile, do_t);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // element i is key key_a + 8 ((i / 2) % 2), row r0 + 8 (i / 4) + 2 c +
    // i % 2; p^T and ds^T packed to bf16 as the A operands of dv and dk
    const int last = min(r0 + BR, n_rows) - 1;
    const bool need_mask =
        kw0 + kWGRows > T || r0 + BR > n_rows ||
        (causal && kw0 + kWGRows - 1 > r0 / G) ||
        (window > 0 && last / G - kw0 >= window);
    uint32_t pp[4][4], ds[4][4];
#pragma unroll
    for (int i = 0; i < BR / 2; i += 2) {
      float p2[2], d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = (i / 4) * 8 + 2 * c + e;
        float p = exp2_approx((s[i + e] - lse_t[col]) * kLog2e);
        if (need_mask) {
          const int row = r0 + col;
          const int key = key_a + 8 * ((i / 2) % 2);
          if (row >= n_rows || !visible(row / G, key, T, causal, window))
            p = 0.f;
        }
        p2[e] = p;
        d2[e] = p * (dp[i + e] - delta_t[col]);
      }
      pp[i / 8][(i % 8) / 2] = pack_bf16(p2[0], p2[1]);
      ds[i / 8][(i % 8) / 2] = pack_bf16(d2[0], d2[1]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(pp[kk]);
      fence_regs(ds[kk]);
    }
    fence_regs(gk);
    fence_regs(gv);
    hopper::wgmma_fence();
    product_rs<D>(gv, pp, do_t);
    product_rs<D>(gk, ds, q_t);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    fence_regs(gk);
    fence_regs(gv);
    mbar_arrive(&empty[st]);
  }

  __nv_bfloat16* kb = dk + (size_t)bk * T * D;
  __nv_bfloat16* vb = dv + (size_t)bk * T * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key_a + 8 * r;
    if (key >= T) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = (size_t)key * D + 8 * j + 2 * c;
      *reinterpret_cast<__nv_bfloat162*>(&kb[at]) =
          __floats2bfloat162_rn(gk[4 * j + 2 * r], gk[4 * j + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(&vb[at]) =
          __floats2bfloat162_rn(gv[4 * j + 2 * r], gv[4 * j + 2 * r + 1]);
    }
  }
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int BK, int S, int T, int G, int causal,
               int window, int lse_stride, cudaStream_t stream) {
  using Tl = BwdTiles<D>;
  CUtensorMap mq, mdo, mk, mv;
  CUresult res = make_map(&mq, q, D, S * G, BK, kBwdTile);
  if (res == CUDA_SUCCESS) res = make_map(&mdo, dout, D, S * G, BK, kBwdTile);
  if (res == CUDA_SUCCESS) res = make_map(&mk, k, D, T, BK, kBwdTile);
  if (res == CUDA_SUCCESS) res = make_map(&mv, v, D, T, BK, kBwdTile);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  auto k_dq = flash_bwd_dq_sm90_kernel<D>;
  auto k_dkdv = flash_bwd_dkdv_sm90_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      k_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmemDq);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k_dkdv,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Tl::kSmemDkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* ob = static_cast<const __nv_bfloat16*>(o);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  k_dq<<<dim3((S * G + kBlockRows - 1) / kBlockRows, BK), kThreads,
         Tl::kSmemDq, stream>>>(mq, mdo, mk, mv, ob, db, lse, delta,
                                static_cast<__nv_bfloat16*>(dq), lse_stride,
                                S, T, G, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k_dkdv<<<dim3((T + kBlockRows - 1) / kBlockRows, BK), kThreads,
           Tl::kSmemDkdv, stream>>>(mq, mdo, mk, mv, lse, delta,
                                    static_cast<__nv_bfloat16*>(dk),
                                    static_cast<__nv_bfloat16*>(dv),
                                    lse_stride, S, T, G, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o bf16, contiguous, 16-byte aligned; D in {64, 128, 256}; lse
// null, or fp32 rows of lse_stride >= S*G floats, one row a bk.
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k,
                                        const void* v, void* o, int BK, int S,
                                        int T, int G, int D, int causal,
                                        int window, float* lse,
                                        int lse_stride, void* stream) {
  if (BK == 0 || S == 0 || G == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0)  // no keys: every row's sum is 0, so o = 0 / 1e-30 = 0
    return static_cast<int>(cudaMemsetAsync(
        o, 0, (size_t)BK * S * G * D * sizeof(__nv_bfloat16), st));
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, lse_stride, BK, S, T, G, causal,
                        window, st);
    case 128:
      return launch<128>(q, k, v, o, lse, lse_stride, BK, S, T, G, causal,
                         window, st);
    case 256:
      return launch<256>(q, k, v, o, lse, lse_stride, BK, S, T, G, causal,
                         window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, k, v, o, dout (= dL/do), dq, dk, dv bf16, contiguous, 16-byte aligned;
// D in {64, 128}; lse (the forward's) and delta (scratch, written here)
// fp32 rows of lse_stride floats a bk (S*G rounded up to a multiple of
// 128, or more), 16-byte aligned, their padding zero.  Launches pass 1 (dq,
// delta) then pass 2 (dk, dv) on `stream`.
extern "C" int flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int BK, int S, int T, int G, int D, int causal, int window,
    int lse_stride, void* stream) {
  if (BK == 0 || G == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S == 0 || T == 0) {  // no scores: every gradient is 0
    const size_t nq = (size_t)BK * S * G * D, nk = (size_t)BK * T * D;
    cudaError_t err = cudaMemsetAsync(dq, 0, nq * 2, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(dk, 0, nk * 2, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, nk * 2, st);
    return static_cast<int>(err);
  }
  switch (D) {
    case 64:
      return launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, BK, S,
                            T, G, causal, window, lse_stride, st);
    case 128:
      return launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, BK, S,
                             T, G, causal, window, lse_stride, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
