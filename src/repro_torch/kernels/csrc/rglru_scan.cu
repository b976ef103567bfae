// RG-LRU diagonal linear recurrence for Hopper (sm_90a): one pass, chunked
// over time, with decoupled look-back.
//
// Replaces src/repro/kernels/rglru_scan.py:56 rglru_scan (Pallas TPU
// kernel, bodies _rglru_kernel and _scan_block) and computes what it
// computes:
//     h_t = a_t * h_{t-1} + b_t,  h_0 = 0,
// over a, b (B, T, D) fp32 into h (B, T, D) fp32.
//
// What bounds it: 12 bytes per element (a and b read once, h written once)
// for two operations, so bytes: 0.0376 ms at recurrentgemma-2b width
// (1, 4096, 2560) on an H100's 3.35 TB/s.  Coming near that takes
// megabytes in flight, so T has to be a parallel axis (a thread that walks
// all of T for its channel keeps only a few loads in flight), and the
// dependence along T has to cost little latency.
//
// The design.  Tiles of TC tokens x DC channels, chunk-major, are taken by
// persistent blocks through a ticket (atomicAdd).  A block runs three roles
// over a ring of ST shared-memory stages, each holding one tile's rows:
//   * a producer warp takes a ticket when a stage is free and fetches the
//     tile's TC rows of a and of b, one TMA bulk copy per row segment,
//     counted on the stage's mbarrier;
//   * an aggregator group (DC / 4 threads, 4 adjacent channels each, as one
//     float4) walks each tile as soon as its rows land, from h = 0: per
//     channel A = prod a_t and B = h at the chunk's end, published to the
//     caller's scratch (chunk 0 publishes B as its inclusive value I);
//   * NF finisher groups take the tiles in turn.  Each thread looks back
//     for its own channels: from p = c - 1 down, a published I_p ends the
//     walk, carry = acc_B + acc_A * I_p; a published (A_p, B_p) is folded,
//     acc_B += acc_A * B_p, acc_A *= A_p; an unpublished p is waited for
//     (backing off with __nanosleep).  It publishes I_c = B_c + A_c * carry,
//     rescans the chunk from the carry out of the stage, each step rounded
//     as the plain version rounds it (a multiply, then an add, no fused
//     multiply-add), stores h as float4s (a warp's row is 512 contiguous
//     bytes), and frees the stage.
// mbarriers hand a stage on: full (producer -> aggregator), aggd
// (aggregator -> finisher, with A and B in shared memory), empty (finisher
// -> producer).  An aggregate never waits on a look-back, and a tile's
// look-back waits only on tiles with smaller tickets, which running blocks
// hold and work on in ticket order: the smallest unfinished tile always
// progresses, and no block waits on one that was never scheduled.  After
// the last tile the producer sends NF tickets past it round the ring; each
// ends the finisher group that meets it, the NF-th the aggregator.
//
// Publication without flags.  The wrapper fills the scratch with all-ones
// words before each launch (in-stream, per call).  Every published word is
// written once, by a relaxed device-scope store, and a value whose bits
// are all ones is stored as the canonical NaN instead.  So a reader that
// sees a word other than all ones sees its final value: no flag, no fence
// and no barrier, and a batch of look-back loads (kFoldBatch predecessors'
// I, A and B at once) is one round trip.  A design with a flag per tile
// (payload, __syncthreads, st.release; ld.acquire, __syncthreads, payload)
// spent two more round trips and a fence on each tile (PERF.md).
//
// It moves the 12 bytes per element once, plus 12 bytes of scratch per
// channel and chunk and the look-back's reads of those (from L2).  At the
// tile it is built for (kTc x kDc, below) the stages and their (A, B) rows
// take 198 KB of shared memory, one block an SM.
//
// Edges: a ragged last chunk (T % TC != 0) has fewer rows, a ragged last
// channel tile fewer channels.  D not a multiple of 4, or a, b or h not
// 16-byte aligned, take the scalar path of the same kernel (VEC = false):
// no staging, element loads from device memory in both passes, element
// stores.  Batch rows run independent look-back chains.  The scratch is
// the call's own, so calls that follow each other without a sync, or run
// on two streams at once, never see each other's values.  The kernel
// launches on the caller's stream and allocates nothing; rglru_scan_fwd
// returns cudaGetLastError() (the wrapper raises on non-zero).

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "hopper.cuh"

namespace {

// a scratch word that holds this bit pattern has not been published yet;
// the wrapper fills the scratch with it before each launch.  Arithmetic on
// the card yields the canonical NaN 0x7fffffff, and publish4 maps this
// pattern to it in any case, so no published value is ever mistaken for it
constexpr uint32_t kUnpublished = 0xffffffffu;
constexpr int kFoldBatch = 8;  // predecessors whose values one load round
                               // trip brings

__device__ __forceinline__ bool published(float v) {
  return __float_as_uint(v) != kUnpublished;
}
__device__ __forceinline__ float sane(float v) {
  return published(v) ? v : __uint_as_float(0x7fffffffu);
}

// every word is published once and read only through these (relaxed,
// device scope: each 32-bit element is single-copy atomic), so a reader
// sees either the pattern or the final value, and needs no flag and no
// fence
__device__ __forceinline__ void publish4(float* p, float4 v) {
  asm volatile("st.relaxed.gpu.global.v4.f32 [%0], {%1, %2, %3, %4};\n"
               ::"l"(p), "f"(sane(v.x)), "f"(sane(v.y)), "f"(sane(v.z)),
               "f"(sane(v.w))
               : "memory");
}
__device__ __forceinline__ float4 peek4(const float* p) {
  float4 v;
  asm volatile("ld.relaxed.gpu.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// one step of the recurrence, rounded as the plain version rounds it
__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}
__device__ __forceinline__ float4 step4(float4 a, float4 h, float4 b) {
  return make_float4(step(a.x, h.x, b.x), step(a.y, h.y, b.y),
                     step(a.z, h.z, b.z), step(a.w, h.w, b.w));
}
__device__ __forceinline__ float4 mul4(float4 x, float4 y) {
  return make_float4(__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y),
                     __fmul_rn(x.z, y.z), __fmul_rn(x.w, y.w));
}
__device__ __forceinline__ float4 splat4(float x) {
  return make_float4(x, x, x, x);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// one call's geometry and buffers, and the steps of a tile on them
template <int TC, int DC, int ST, bool VEC>
struct Scan {
  static constexpr int NT = DC / 4;  // threads a group, 4 channels each
  static constexpr int STAGE = 2 * TC * DC;  // TC rows of a, then of b

  const float* a;
  const float* b;
  float* h;
  float* agg_a;  // scratch planes (B, n_chunks, Dp): each chunk's A,
  float* agg_b;  // its B
  float* inc;    // and its inclusive value I
  float* smem;   // ST stages, then ST x (A, B) rows of DC
  int B, T_len, D, Dp, n_chunks, n_dt, n_tiles;
  int tid, ch;   // thread in its group, its first channel in a tile

  // a tile: chunk c of batch row bi, channel tile dt; rows [t0, t0 + n),
  // channels [d0, d0 + nch); g0 is the offset of element (bi, t0, d0)
  struct Tile {
    int c, bi, dt, n, d0, nch;
    size_t g0;
  };

  __device__ __forceinline__ Tile tile(int id) const {
    Tile x;
    x.c = id / (B * n_dt);
    x.bi = id % (B * n_dt) / n_dt;
    x.dt = id % n_dt;
    const int t0 = x.c * TC;
    x.n = min(TC, T_len - t0);
    x.d0 = x.dt * DC;
    x.nch = min(DC, D - x.d0);
    x.g0 = ((size_t)x.bi * T_len + t0) * D + x.d0;
    return x;
  }
  __device__ __forceinline__ bool active(const Tile& x) const {
    return ch < x.nch;
  }
  // offset of this thread's channels of chunk c in a scratch plane
  __device__ __forceinline__ size_t at(const Tile& x, int c) const {
    return ((size_t)x.bi * n_chunks + c) * Dp + x.d0 + ch;
  }
  // this stage's (A, B) of the tile, handed from aggregator to finisher
  __device__ __forceinline__ float* agg_row(int s) const {
    return smem + ST * STAGE + s * 2 * DC + ch;
  }

  // row t of a (or b) at this thread's channels: from the stage (VEC), or
  // element by element from device memory, zero past the tile's channels
  __device__ __forceinline__ float4 row(const Tile& x, int s, int t,
                                        bool of_b) const {
    if constexpr (VEC) {
      return ld4(smem + s * STAGE + (of_b ? TC * DC : 0) + t * DC + ch);
    } else {
      const float* g = (of_b ? b : a) + x.g0 + (size_t)t * D + ch;
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = ch + j < x.nch ? g[j] : 0.f;
      return make_float4(e[0], e[1], e[2], e[3]);
    }
  }

  // producer warp (VEC): one TMA bulk copy per row segment of a and of b
  // into stage s, counted on `full`
  __device__ __forceinline__ void fetch(const Tile& x, int s, uint64_t* full,
                                        int lane) const {
    const uint32_t bytes = (uint32_t)x.nch * sizeof(float);
    if (lane == 0) hopper::mbar_expect_tx(full, 2 * x.n * bytes);
    __syncwarp();
    float* buf = smem + s * STAGE;
    for (int q = lane; q < 2 * x.n; q += 32) {
      const int t = q % x.n;
      const float* src = (q < x.n ? a : b) + x.g0 + (size_t)t * D;
      hopper::bulk_load(buf + (q < x.n ? 0 : TC * DC) + t * DC, src, bytes,
                        full);
    }
  }

  // aggregator group: the chunk's product A and its scan B from h = 0,
  // published (for chunk 0, B as its inclusive value) and left in the
  // stage's (A, B) rows for the finisher
  __device__ __forceinline__ void aggregate(const Tile& x, int s) const {
    if (!active(x)) return;
    float4 A = splat4(1.f), Bv = splat4(0.f);
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      if (t < x.n) {
        const float4 av = row(x, s, t, false);
        Bv = step4(av, Bv, row(x, s, t, true));
        A = mul4(A, av);
      }
    }
    st4(agg_row(s), A);
    st4(agg_row(s) + DC, Bv);
    if (x.c == 0) {
      publish4(inc + at(x, 0), Bv);
    } else {
      publish4(agg_a + at(x, x.c), A);
      publish4(agg_b + at(x, x.c), Bv);
    }
  }

  // finisher group, each thread on its own: the scan's value at the end of
  // chunk x.c - 1 for each of its channels, by decoupled look-back: from
  // p = x.c - 1 down, a published inclusive value I_p ends the walk with
  // carry = acc_B + acc_A * I_p; else a published aggregate is folded,
  // acc_B += acc_A * B_p, acc_A *= A_p; else the channel waits for p.
  // Then I = B + A * carry is published
  __device__ __forceinline__ float4 look_back(const Tile& x, int s) const {
    float carry[4] = {0.f, 0.f, 0.f, 0.f};
    if (x.c == 0 || !active(x)) return splat4(0.f);
    float acc_a[4] = {1.f, 1.f, 1.f, 1.f}, acc_b[4] = {0.f, 0.f, 0.f, 0.f};
    int pos[4];  // the predecessor each channel needs next, -1 once done
#pragma unroll
    for (int j = 0; j < 4; ++j) pos[j] = ch + j < x.nch ? x.c - 1 : -1;
    for (int ns = 0;;) {
      const int top = max(max(pos[0], pos[1]), max(pos[2], pos[3]));
      if (top < 0) break;
      float4 I[kFoldBatch], A[kFoldBatch], Bp[kFoldBatch];
#pragma unroll
      for (int i = 0; i < kFoldBatch; ++i) {
        if (top - i >= 0) {
          const size_t off = at(x, top - i);
          I[i] = peek4(inc + off);
          A[i] = peek4(agg_a + off);
          Bp[i] = peek4(agg_b + off);
        }
      }
      bool moved = false;
#pragma unroll
      for (int i = 0; i < kFoldBatch; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // only a channel whose next predecessor this is
          if (pos[j] < 0 || pos[j] != top - i) continue;
          const float iv = comp(I[i], j);
          const float av = comp(A[i], j), bv = comp(Bp[i], j);
          if (published(iv)) {
            carry[j] = step(acc_a[j], iv, acc_b[j]);
            pos[j] = -1;
            moved = true;
          } else if (published(av) && published(bv)) {
            acc_b[j] = step(acc_a[j], bv, acc_b[j]);
            acc_a[j] = __fmul_rn(acc_a[j], av);
            --pos[j];
            moved = true;
          }
        }
      }
      if (moved) {
        ns = 0;
      } else {
        ns = ns ? min(2 * ns, 1024) : 32;
        __nanosleep(ns);
      }
    }
    const float4 cv = make_float4(carry[0], carry[1], carry[2], carry[3]);
    publish4(inc + at(x, x.c),
             step4(ld4(agg_row(s)), cv, ld4(agg_row(s) + DC)));
    return cv;
  }

  // finisher group: h over the chunk from the carry
  __device__ __forceinline__ void rescan(const Tile& x, int s,
                                         float4 carry) const {
    if (!active(x)) return;
    float4 hv = carry;
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      if (t < x.n) {
        hv = step4(row(x, s, t, false), hv, row(x, s, t, true));
        float* out = h + x.g0 + (size_t)t * D + ch;
        if constexpr (VEC) {
          st4(out, hv);
        } else {
          const float e[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (ch + j < x.nch) out[j] = e[j];
        }
      }
    }
  }
};

// Three roles a block, each walking the block's tiles in ticket order
// through a ring of ST stages: a producer warp takes a ticket when a stage
// is free and fetches the tile's rows; an aggregator group publishes each
// tile's aggregate as soon as its rows land; NF finisher groups, taking
// the tiles in turn, look back, publish the inclusive value and rescan,
// then free the stage.  mbarriers hand each stage on: full (producer ->
// aggregator), aggd (aggregator -> finisher), empty (finisher ->
// producer).  After the last tile the producer sends NF tickets past it
// round the ring like tiles; each ends the finisher group that meets it,
// and the NF-th the aggregator.  ST >= NF, so the stages they take are
// freed by real tiles.
template <int TC, int DC, int ST, int NF, bool VEC>
__global__ void __launch_bounds__((NF + 1) * (DC / 4) + 32)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, float* __restrict__ scratch, int B,
                  int T_len, int D) {
  using S = Scan<TC, DC, ST, VEC>;
  constexpr int NT = S::NT;
  static_assert(NT >= 32 && NT % 32 == 0 && ST >= NF, "tile");
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t full[ST], aggd[ST], empty[ST];
  __shared__ int s_tile[ST];

  S sc;
  sc.a = a;
  sc.b = b;
  sc.h = h;
  sc.smem = smem;
  sc.B = B;
  sc.T_len = T_len;
  sc.D = D;
  sc.Dp = (D + 3) & ~3;  // D rounded up to 4: each thread's float4 aligned
  sc.n_chunks = (T_len + TC - 1) / TC;
  sc.n_dt = (D + DC - 1) / DC;
  sc.n_tiles = B * sc.n_chunks * sc.n_dt;
  const size_t plane = (size_t)B * sc.n_chunks * sc.Dp;
  sc.agg_a = scratch;
  sc.agg_b = scratch + plane;
  sc.inc = scratch + 2 * plane;
  // after the planes, the ticket, filled with -1 like every scratch word
  int* ticket = reinterpret_cast<int*>(scratch + 3 * plane);
  // 0 aggregator, 1 .. NF finishers, NF + 1 producer
  const int role = threadIdx.x / NT;
  sc.tid = threadIdx.x % NT;
  sc.ch = 4 * sc.tid;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&aggd[s], NT);
      hopper::mbar_init(&empty[s], NT);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (role == NF + 1) {
    // after the last tile, NF tickets past it, one for each finisher group
    const int lane = sc.tid;
    for (int j = 0, ends = 0;; ++j) {
      const int s = j % ST;
      if (j >= ST) hopper::mbar_wait(&empty[s], (j / ST - 1) & 1);
      int id = sc.n_tiles;
      if (ends == 0) {
        if (lane == 0) id = atomicAdd(ticket, 1) + 1;
        id = __shfl_sync(0xffffffffu, id, 0);
      }
      if (lane == 0) s_tile[s] = id;
      if (VEC && id < sc.n_tiles) {
        sc.fetch(sc.tile(id), s, &full[s], lane);
      } else {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&full[s]);
      }
      if (id >= sc.n_tiles && ++ends == NF) return;
    }
  } else if (role == 0) {
    for (int j = 0, ends = 0;; ++j) {
      const int s = j % ST;
      hopper::mbar_wait(&full[s], (j / ST) & 1);
      const int id = s_tile[s];
      if (id < sc.n_tiles) sc.aggregate(sc.tile(id), s);
      hopper::mbar_arrive(&aggd[s]);
      if (id >= sc.n_tiles && ++ends == NF) return;
    }
  } else {
    // finisher group role - 1 takes tiles role - 1, role - 1 + NF, ...;
    // ST >= NF, so a stage's earlier phase has completed before a group
    // waits on its next one
    for (int j = role - 1;; j += NF) {
      const int s = j % ST;
      hopper::mbar_wait(&aggd[s], (j / ST) & 1);
      const int id = s_tile[s];
      if (id >= sc.n_tiles) return;
      const typename S::Tile x = sc.tile(id);
      sc.rescan(x, s, sc.look_back(x, s));
      hopper::mbar_arrive(&empty[s]);
    }
  }
}

// The tile, chosen by measuring Tc in {16, 32, 64} x Dc in {256, 512} at
// recurrentgemma-2b width (PERF.md): 32 tokens x 256 channels, three
// stages, two finisher groups.  kernels/rglru_scan.py's CHUNK and DTILE
// mirror kTc and kDc.
constexpr int kTc = 32, kDc = 256, kSt = 3, kNf = 2;
constexpr int kThreads = (kNf + 1) * (kDc / 4) + 32;
// the stages, and each stage's (A, B) rows
constexpr int kSmem = kSt * 2 * (kTc + 1) * kDc * (int)sizeof(float);
constexpr int kMaxDevices = 64;

template <bool VEC>
cudaError_t launch(const float* a, const float* b, float* h, float* scratch,
                   int B, int T_len, int D, long long tiles, cudaStream_t st) {
  auto kernel = rglru_scan_kernel<kTc, kDc, kSt, kNf, VEC>;
  // persistent: as many blocks as the card holds at once, at most one a
  // tile.  That capacity, and the shared-memory attribute, are set up once
  // per device
  static std::atomic<int> capacity[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int blocks = capacity[dev].load(std::memory_order_relaxed);
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, kSmem)) != cudaSuccess)
      return err;
    blocks = std::max(1, sms * per_sm);
    capacity[dev].store(blocks, std::memory_order_relaxed);
  }
  const long long grid = std::min<long long>(tiles, blocks);
  kernel<<<(unsigned)grid, kThreads, kSmem, st>>>(a, b, h, scratch, B, T_len,
                                                  D);
  return cudaGetLastError();
}

}  // namespace

// a, b, h: (B, T, D) fp32, contiguous.  scratch: 3 x B x ceil(T / kTc) x Dp
// 32-bit words (Dp = D rounded up to 4: the A, B and I planes) and one for
// the ticket, 16-byte aligned, every bit set.  Returns a cudaError_t.
extern "C" int rglru_scan_fwd(const void* a, const void* b, void* h,
                              void* scratch, int B, int T_len, int D,
                              void* stream) {
  if (B <= 0 || T_len <= 0 || D <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (long long)B * ((T_len + kTc - 1) / kTc) *
                          ((D + kDc - 1) / kDc);
  if (tiles > INT_MAX / 2)  // int tickets
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* fh = static_cast<float*>(h);
  float* fs = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 &&
                   ((uintptr_t)a | (uintptr_t)b | (uintptr_t)h) % 16 == 0;
  return static_cast<int>(
      vec ? launch<true>(fa, fb, fh, fs, B, T_len, D, tiles, s)
          : launch<false>(fa, fb, fh, fs, B, T_len, D, tiles, s));
}
