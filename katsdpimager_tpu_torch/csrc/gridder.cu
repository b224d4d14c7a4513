// Fused gridder kernels for Hopper (sm_90a): K1 (band accumulation into
// the colour planes) and K2 (colour-plane combine).  Plain C interface,
// loaded with ctypes by katsdpimager_tpu_torch/ops/_build.py; the Python
// wrappers and plain PyTorch versions are in ops/fused_gridder.py.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError().  Neither kernel allocates or synchronises.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "wgmma.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------------------------------
// K1 -- replaces katsdpimager_tpu/ops/pallas_gridder.py:_make_kernel
// (launched by _grid_chunks_planes).
//
// What it computes: for each run of consecutive chunks that share one tile
// anchor, the (2ts x 2ts) complex band
//     band[j, k] = sum_m conj(K_v[m, j]) * sample[m] * conj(K_u[m, k])
// summed over the first count[c] slots of each of the run's chunks (the
// valid slots: a prefix of every chunk, the planner's invariant), written
// once into the colour plane block that the run's slot names.
//
// What bounds it on this card: the band products on the tensor cores,
// (2ts)^2 complex MACs per valid visibility on the dense window, 12 TF32
// MACs each in 3xTF32: at the production plan 34,712 batches of 16
// visibilities, 0.44 ms at 495 TF32 TFLOP/s; the bytes written 0.15 ms.
//
// Arithmetic: the window, padded to Wp = 64 ceil(2ts / 64) rows and
// columns, is cut into tiles of 64 rows by BN = 128 (Wp a multiple of
// 128) or 64 (otherwise) columns, each 64 x 64 sub-block of a tile summed
// by one consumer warpgroup.  A run's tile is a complex matrix product
// A^T B over its valid slots, kKB = 16 visibilities a batch (two wgmma
// k-steps; a batch never spans chunks, so padding costs nothing), A[m, j]
// = conj(K_v) sample for the tile's rows j and B[m, k] = conj(K_u) for its
// columns k, on the tensor cores with wgmma.mma_async m64n64k8 TF32 as
// four real products in the 3xTF32 scheme (wgmma_tf32x3): each staged
// operand is split once into hi = tf32_rna(x) and lo = tf32_rna(x - hi),
// and every product sums lo*hi + hi*lo + hi*hi, so the band keeps FP32
// accuracy; plain TF32 would not.  Rows and columns at or past 2ts (the
// padding) stage as zeros and are never stored.
//
// Accumulation (wgmma.cuh): the tensor cores' FP32 sums truncate, and
// their error grows with the adds they take.  So each warpgroup's
// accumulators sum one batch afresh (scale_d = 0), and are then promoted
// by IEEE adds into a segment's FP32 totals in registers; every kSegment
// batches, and at the end of the run, the segment goes by one more IEEE
// add into the run's totals, which live in the run's own block of the
// colour plane: the first such add stores 0 + segment, later ones load,
// add and store, one owner per value.  These are the adds, in the order,
// of the schedule that kept the run's totals in registers (2.7-4.3e-7 of
// the peak from a float64 run on an H100), so the planes are bitwise the
// same; a batch's accumulators and a segment's totals take 128 registers
// a thread, not 192.
//
// Schedule: persistent and warp-specialised.  One CTA per SM, three
// warpgroups: two consumers, which only issue wgmmas and promote, and one
// producer, which loads each chunk's slots (the next chunk's prefetched
// while a batch stages) and stages each batch's split operands into a
// ring of shared-memory stages with an mbarrier full/empty pair each (one
// arrival a warp), so that staging, the next run's first batches and the
// last run's stores overlap the tensor cores.  At BN = 128 the CTA is one
// lane: a ring of kStagesOne stages of a 64 x 128 tile (A's 64 rows once,
// both halves of B), the consumers taking the tile's two column halves
// of every batch, their wgmmas issued in turn (named barriers), so that
// one promotes while the other's products run.  At BN = 64 (Wp = 64, and
// the wide windows that are odd multiples of 64) the CTA is two lanes, a
// consumer each over its own ring of kStagesTwo stages of a 64 x 64 tile
// and its own work, the producer staging a batch of each lane in turn.
// No CTA-wide barrier after the schedule is found.  Where the caller
// hands in `stats`, each worker's producer writes there the items and
// batches it took (a diagnostic, held to the schedule's plain model on
// the card).
//
// Work: an item is (pass, anchor run), a pass being (polarization, tile).
// Its weight is the run's batches plus kItemWeight; the items in pass
// order, and in chunk order within a pass, are dealt to the workers (the
// lanes of all CTAs) as contiguous ranges of equal weight: every CTA finds
// its lanes' first items by a block-wide prefix sum over the chunks'
// weights at its start, inside the launch (nothing on the host).  So a
// worker's load is its share of the whole plus at most one run: the
// longest run bounds the tail, and sits with no more than a share of
// other work.  The result does not depend on the schedule: each value has
// one owner and no sum uses atomics.
//
// What bounds it (measured on an H100, PERF.md): the producer.  Twice its
// staging costs 1.4-1.8 times the time, twice the consumers' wgmmas 1.1
// times; without its table gathers the kernel takes 15% less, without its
// shared-memory stores 2.5% less.  The gathers are served from L1 (both
// operands from one 8-byte table, 123 KB at the production plan; loads
// that skip or evict from L1 cost 25-45% more), and they share the SM's
// L1/shared-memory bandwidth with the tensor cores' operand reads.  Tried
// and slower or no faster (PERF.md): a pre-split 16-byte table for B;
// cvt.rna for the TF32 split (tf32_round instead); A from registers;
// two producer warpgroups with setmaxnreg (ptxas kept every thread at
// 128 registers and the consumers spilled); two batches a gather round;
// other ring depths.  mma.sync m16n8k8 runs TF32 at a quarter of wgmma's
// rate.  The design before this one (the run's totals in registers, one
// CTA per run and block, every warp staging, waiting and promoting in
// step, one barrier a batch) took 1.37 ms at the production plan.
// ---------------------------------------------------------------------------

// Visibilities per batch: one stretch of kPromoteSteps wgmma k-steps of
// 8, staged in one round and promoted at its end.
constexpr int kKB = 8 * kPromoteSteps;
constexpr int kMaxMc = 256;    // slots per chunk held in shared memory
constexpr int kConsumers = 2;  // consumer warpgroups a CTA
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer's
// Staged batches a lane's ring holds: one lane (a 64 x 128 tile, 48 KB a
// batch) or two (64 x 64, 32 KB).  The rest of the SM's 256 KB is L1,
// which caches the kernel table the producer gathers from.
constexpr int kStagesOne = 3;
constexpr int kStagesTwo = 2;
constexpr int kItemWeight = 1;  // a work item's own cost, in batches

// The ring of a CTA whose tiles are 64 rows by BN columns.  A staged batch
// holds kKB visibilities in eight planes, A (re hi, re lo, im hi, im lo;
// 64 rows) then B (likewise; BN columns), each in the K-major core-matrix
// layout of smem_desc: row r (j - the tile's first row for A, k - its
// first column for B), slot m at float ((r / 8) (kKB / 4) + m / 4) 32 +
// (r % 8) 4 + m % 4.
template <int BN>
struct Ring {
  static constexpr int kLanes = BN == 128 ? 1 : 2;
  static constexpr int kPlaneA = kKB * 64;    // floats
  static constexpr int kPlaneB = kKB * BN;
  static constexpr int kStage = 4 * kPlaneA + 4 * kPlaneB;
  static constexpr int kStages = kLanes == 1 ? kStagesOne : kStagesTwo;
  static constexpr int kRingBytes =
      kLanes * kStages * kStage * static_cast<int>(sizeof(float));
  static constexpr int kProducers = 128;  // threads, staging each lane
  static constexpr int kLaneConsumers = 128 * kConsumers / kLanes;
  // Arrivals that complete a stage's full and empty barriers: one a warp.
  static constexpr int kFullCount = kProducers / 32;
  static constexpr int kEmptyCount = kLaneConsumers / 32;
  static constexpr int kAcc = 32;  // m64n64 accumulators a thread, each
};

// One chunk's slot data, loaded once per chunk into shared memory.
struct __align__(16) ChunkSlots {
  int iv[kMaxMc], sv[kMaxMc], iu[kMaxMc], su[kMaxMc];
  float sr[kMaxMc], si[kMaxMc];
};

// What a staged batch is, written by the producer beside it.
enum : int { kFirst = 1, kLast = 2, kEmpty = 4, kEnd = 8 };
struct __align__(16) StageInfo {
  long long base;  // the run's block of the colour planes (floats)
  int jr0, jc0;    // the tile's first window row and column
  int flags;       // kFirst, kLast: the item's first, last batch; kEmpty:
                   // an item with no batch; kEnd: the lane's work is done
  int pad[3];
};
static_assert(sizeof(StageInfo) == 32, "a stage's info is 32 bytes");
static_assert(sizeof(ChunkSlots) % 16 == 0, "slot buffers stay 16-aligned");

// Dynamic shared memory: the ring, then per lane two chunks' slots (the
// chunk being staged and the next, prefetched), the stages' infos and the
// full and empty barriers.
template <int BN>
struct Smem {
  using R = Ring<BN>;
  static constexpr int kSlots = R::kRingBytes;
  static constexpr int kInfo =
      kSlots + 2 * R::kLanes * static_cast<int>(sizeof(ChunkSlots));
  static constexpr int kBars =
      kInfo + R::kLanes * R::kStages * static_cast<int>(sizeof(StageInfo));
  static constexpr int kBytes = kBars + 2 * R::kLanes * R::kStages * 8;
  // The slot buffers are read as 16-byte vectors, the barriers are 8
  // bytes; with the static Schedule, under the 227 KB a block can take.
  static_assert(kSlots % 16 == 0 && kInfo % 16 == 0 && kBars % 8 == 0,
                "shared-memory regions keep their alignment");
  static_assert(R::kStages >= 2, "a ring of at least two stages");
};

// Where each of a CTA's lanes starts: the pass, the chunk that starts
// its first run (n: none in that pass) and that chunk's position in the
// pass (the weights of the chunks before it).
struct Schedule {
  long long lo[2], hi[2];  // the lane's positions over all passes
  int pass[2];             // the pass of lo
  int chunk[2], pos[2];
  int total;               // W
  int warp[kThreads / 32];
};
static_assert(Smem<128>::kBytes + sizeof(Schedule) <= 227 * 1024 &&
                  Smem<64>::kBytes + sizeof(Schedule) <= 227 * 1024,
              "every instance fits a block's shared memory");

// Chunk c's weight: its batches, plus kItemWeight where it starts a run.
__device__ __forceinline__ int chunk_weight(const int* __restrict__ slot,
                                            const int* __restrict__ count,
                                            int n, int c, bool& first) {
  first = false;
  if (c >= n) return 0;
  first = c == 0 || slot[c] != slot[c - 1];
  return (count[c] + kKB - 1) / kKB + (first ? kItemWeight : 0);
}

// The weight W of a pass over the first n chunks, and where each of the
// CTA's kLanes workers starts: worker k = lane * gridDim.x + blockIdx.x
// of NW takes the items whose position q W + pos lies in [k L / NW,
// (k + 1) L / NW), L = passes W.  Every thread of the CTA enters.
constexpr int kScanPer = 8;  // chunks a thread, a round of the scan

template <int kLanes>
__device__ void find_starts(Schedule& sc, const int* __restrict__ slot,
                            const int* __restrict__ count, int n,
                            long long passes) {
  const int tid = threadIdx.x, l32 = tid % 32, warp = tid / 32;
  int local = 0;
  for (int b0 = 0; b0 < n; b0 += kThreads * kScanPer) {
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      bool f;
      local += chunk_weight(slot, count, n, b0 + tid * kScanPer + j, f);
    }
  }
  local = __reduce_add_sync(0xffffffffu, local);
  if (tid == 0) sc.total = 0;
  __syncthreads();
  if (l32 == 0) atomicAdd(&sc.total, local);
  __syncthreads();
  if (tid == 0) {
    const long long W = sc.total;
    const long long nw = static_cast<long long>(kLanes) * gridDim.x;
    for (int l = 0; l < kLanes; ++l) {
      const long long k =
          static_cast<long long>(l) * gridDim.x + blockIdx.x;
      sc.lo[l] = k * (passes * W) / nw;
      sc.hi[l] = (k + 1) * (passes * W) / nw;
      sc.pass[l] = static_cast<int>(sc.lo[l] / W);
      sc.chunk[l] = sc.lo[l] == sc.pass[l] * W ? 0 : n;
      sc.pos[l] = 0;
    }
  }
  __syncthreads();
  long long lo_in[2];
  for (int l = 0; l < kLanes; ++l)
    lo_in[l] = sc.lo[l] - static_cast<long long>(sc.pass[l]) * sc.total;
  // The first run start whose position is at or past lo_in: a block-wide
  // prefix sum over the chunks' weights, kThreads * kScanPer a round.
  int running = 0;
  for (int b0 = 0; b0 < n; b0 += kThreads * kScanPer) {
    bool done = true;
    for (int l = 0; l < kLanes; ++l) done = done && sc.chunk[l] < n;
    if (done) break;
    int w[kScanPer];
    bool f[kScanPer];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      w[j] = chunk_weight(slot, count, n, b0 + tid * kScanPer + j, f[j]);
      mine += w[j];
    }
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (l32 >= d) incl += v;
    }
    if (l32 == 31) sc.warp[warp] = incl;
    __syncthreads();
    int before = running, round = 0;
    for (int i = 0; i < kThreads / 32; ++i) {
      const int v = sc.warp[i];
      before += i < warp ? v : 0;
      round += v;
    }
    const int pos0 = before + incl - mine;
    int pos = pos0;
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      const int c = b0 + tid * kScanPer + j;
      for (int l = 0; l < kLanes; ++l)
        if (f[j] && pos >= lo_in[l]) atomicMin(&sc.chunk[l], c);
      pos += w[j];
    }
    __syncthreads();
    pos = pos0;
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      const int c = b0 + tid * kScanPer + j;
      for (int l = 0; l < kLanes; ++l)
        if (f[j] && c == sc.chunk[l]) sc.pos[l] = pos;
      pos += w[j];
    }
    running += round;
    __syncthreads();
  }
}

// This producer thread's slots of chunk c (polarization p) into
// registers: slot pt + i kProducers, each below Mc (slots past the
// chunk's count are loaded and never staged).
template <int BN>
__device__ __forceinline__ void fetch_slots(
    int4 (&ints)[kMaxMc / Ring<BN>::kProducers],
    float2 (&smp)[kMaxMc / Ring<BN>::kProducers], int c, int p, int pt,
    const int* __restrict__ iu, const int* __restrict__ iv,
    const int* __restrict__ su, const int* __restrict__ sv,
    const float* __restrict__ sre, const float* __restrict__ sim, int Mc,
    int P) {
  constexpr int kN = Ring<BN>::kProducers;
  const size_t cm = static_cast<size_t>(c) * Mc;
  const size_t cp = (static_cast<size_t>(c) * P + p) * Mc;
#pragma unroll
  for (int i = 0; i < kMaxMc / kN; ++i) {
    const int m = pt + i * kN;
    if (m < Mc) {
      ints[i] = make_int4(iv[cm + m], sv[cm + m], iu[cm + m], su[cm + m]);
      smp[i] = make_float2(sre[cp + m], sim[cp + m]);
    }
  }
}

template <int BN>
__device__ __forceinline__ void store_slots(
    ChunkSlots& cs, const int4 (&ints)[kMaxMc / Ring<BN>::kProducers],
    const float2 (&smp)[kMaxMc / Ring<BN>::kProducers], int pt, int Mc) {
  constexpr int kN = Ring<BN>::kProducers;
#pragma unroll
  for (int i = 0; i < kMaxMc / kN; ++i) {
    const int m = pt + i * kN;
    if (m < Mc) {
      cs.iv[m] = ints[i].x;
      cs.sv[m] = ints[i].y;
      cs.iu[m] = ints[i].z;
      cs.su[m] = ints[i].w;
      cs.sr[m] = smp[i].x;
      cs.si[m] = smp[i].y;
    }
  }
}

// Chunk c's slots into cs, now (the chunk was not prefetched).
template <int BN>
__device__ __forceinline__ void load_chunk(
    ChunkSlots& cs, int c, int p, int pt, const int* __restrict__ iu,
    const int* __restrict__ iv, const int* __restrict__ su,
    const int* __restrict__ sv, const float* __restrict__ sre,
    const float* __restrict__ sim, int Mc, int P) {
  int4 ints[kMaxMc / Ring<BN>::kProducers];
  float2 smp[kMaxMc / Ring<BN>::kProducers];
  fetch_slots<BN>(ints, smp, c, p, pt, iu, iv, su, sv, sre, sim, Mc, P);
  store_slots<BN>(cs, ints, smp, pt, Mc);
}

// Offset (floats) of row r, slots 4 k4 .. 4 k4 + 3 in a staged plane.
__device__ __forceinline__ int core_offset(int r, int k4) {
  return ((r >> 3) * (kKB / 4) + k4) * 32 + (r & 7) * 4;
}

// Visibilities m0 .. m0 + kKB - 1 of the chunk in `cs` (slots at or past
// cnt give zeros) as split planes into stage S, for window rows jr0 ..
// jr0 + 63 (A) and columns jc0 .. jc0 + BN - 1 (B); rows and columns at
// or past ts2 give zeros.  Producer thread pt takes kGA groups of A and
// kGB of B, a group being one row (or column) and 4 consecutive slots,
// whose slot data it reads as vectors and whose 4 values per plane are
// contiguous in the core-matrix layout: one 16-byte store per plane, free
// of bank conflicts.  Every table gather is issued before any is used.
// A's products are split here, and B's table values, by tf32_round (the
// integer pipe: the conversion unit bounded the producer); B gathers the
// 8-byte table values, not a pre-split table of twice the bytes.  Ends
// with the async-proxy fence.
template <int BN, bool kPad>
__device__ __forceinline__ void stage_batch(float* S, const ChunkSlots& cs,
                                            int m0, int cnt,
                                            const float2* __restrict__ tab,
                                            int K, int ts2, int jr0, int jc0,
                                            int pt) {
  using R = Ring<BN>;
  constexpr int kGA = (kKB / 4) * 64 / R::kProducers;
  constexpr int kGB = (kKB / 4) * BN / R::kProducers;
  float2 ta[kGA][4], tb[kGB][4];
  unsigned live = 0;  // bit 4 a + u: A's tap (a, u) lies in the window
#pragma unroll
  for (int a = 0; a < kGA; ++a) {
    const int grp = pt + a * R::kProducers;
    const int jr = jr0 + grp % 64;
    const int mq = m0 + 4 * (grp / 64);
    const int4 sv4 = *reinterpret_cast<const int4*>(cs.sv + mq);
    const int4 iv4 = *reinterpret_cast<const int4*>(cs.iv + mq);
    const int svs[4] = {sv4.x, sv4.y, sv4.z, sv4.w};
    const int ivs[4] = {iv4.x, iv4.y, iv4.z, iv4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int dv = jr - svs[u];
      ta[a][u] = make_float2(0.f, 0.f);
      if (mq + u < cnt && (!kPad || jr < ts2) &&
          static_cast<unsigned>(dv) < static_cast<unsigned>(K)) {
        ta[a][u] = tab[ivs[u] * K + dv];
        live |= 1u << (4 * a + u);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kGB; ++b) {
    const int grp = pt + b * R::kProducers;
    const int jc = jc0 + grp % BN;
    const int mq = m0 + 4 * (grp / BN);
    const int4 su4 = *reinterpret_cast<const int4*>(cs.su + mq);
    const int4 iu4 = *reinterpret_cast<const int4*>(cs.iu + mq);
    const int sus[4] = {su4.x, su4.y, su4.z, su4.w};
    const int ius[4] = {iu4.x, iu4.y, iu4.z, iu4.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int du = jc - sus[u];
      tb[b][u] = make_float2(0.f, 0.f);
      if (mq + u < cnt && (!kPad || jc < ts2) &&
          static_cast<unsigned>(du) < static_cast<unsigned>(K))
        tb[b][u] = tab[ius[u] * K + du];
    }
  }
#pragma unroll
  for (int a = 0; a < kGA; ++a) {
    const int grp = pt + a * R::kProducers;
    const int k4 = grp / 64;
    const int mq = m0 + 4 * k4;
    const float4 sr4 = *reinterpret_cast<const float4*>(cs.sr + mq);
    const float4 si4 = *reinterpret_cast<const float4*>(cs.si + mq);
    const float srs[4] = {sr4.x, sr4.y, sr4.z, sr4.w};
    const float sis[4] = {si4.x, si4.y, si4.z, si4.w};
    float v[4][4];  // [plane][slot]: re hi, re lo, im hi, im lo
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 t = ta[a][u];
      float ar = 0.f, ai = 0.f;
      if (live >> (4 * a + u) & 1u) {
        ar = t.x * srs[u] - t.y * sis[u];
        ai = t.x * sis[u] + t.y * srs[u];
      }
      const float rh = tf32_round(ar);
      const float ih = tf32_round(ai);
      v[0][u] = rh;
      v[1][u] = tf32_round(ar - rh);
      v[2][u] = ih;
      v[3][u] = tf32_round(ai - ih);
    }
    const int off = core_offset(grp % 64, k4);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(S + q * R::kPlaneA + off) =
          make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
  }
#pragma unroll
  for (int b = 0; b < kGB; ++b) {
    const int grp = pt + b * R::kProducers;
    float v[4][4];  // [plane][slot]: re hi, re lo, im hi, im lo
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 t = tb[b][u];
      const float rh = tf32_round(t.x);
      const float ih = tf32_round(t.y);
      v[0][u] = rh;
      v[1][u] = tf32_round(t.x - rh);
      v[2][u] = ih;
      v[3][u] = tf32_round(t.y - ih);
    }
    const int off = core_offset(grp % BN, grp / BN);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(S + 4 * R::kPlaneA + q * R::kPlaneB +
                                 off) =
          make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
  }
  fence_proxy_async();
}

// Column half cb's band sums of a staged batch, afresh, in 3xTF32: for
// each k-step, re += Ar Br - Ai Bi, im += Ar Bi + Ai Br, each product by
// wgmma_tf32x3.  Issues the wgmmas and commits them; the caller waits.
template <int BN>
__device__ __forceinline__ void band_issue(float (&acc_r)[32],
                                           float (&acc_i)[32],
                                           const float* S, int cb) {
  using R = Ring<BN>;
  fence_operands(acc_r);
  fence_operands(acc_i);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kPromoteSteps; ++ks) {
    // Planes A re hi .. A im lo (the tile's 64 rows), B re hi .. B im lo
    // at the warpgroup's 64 columns (8 groups of 8), at k-step ks (the
    // next 8 slots: 2 core matrices along K): LBO the next 4 slots, SBO
    // the next 8 rows.
    uint64_t a[4], b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = smem_desc(S + q * R::kPlaneA + ks * 64, 128, 128 * (kKB / 4));
      b[q] = smem_desc(S + 4 * R::kPlaneA + q * R::kPlaneB + ks * 64 +
                           cb * 8 * (kKB / 4) * 32,
                       128, 128 * (kKB / 4));
    }
    const int sd = ks > 0;  // the first k-step starts afresh
    wgmma_tf32x3<1>(acc_r, a[0], a[1], b[0], b[1], sd);   // + Ar Br
    wgmma_tf32x3<1>(acc_i, a[0], a[1], b[2], b[3], sd);   // + Ar Bi
    wgmma_tf32x3<-1>(acc_r, a[2], a[3], b[2], b[3], 1);   // - Ai Bi
    wgmma_tf32x3<1>(acc_i, a[2], a[3], b[0], b[1], 1);    // + Ai Br
  }
  wgmma_commit();
}

// The run's totals at its block (base), rows row0 + 0..63, columns col0 +
// 0..63 of the window, by one IEEE add of the segment's totals: onto the
// stored totals (add) or onto 0 (the first).  Total i of n8 block nb8:
// row r0 + g (+ 8 for i & 2), column 8 nb8 + 2 t (+ 1 for i & 1); the
// window's padding past ts2 is not stored (ts2 is even, so a pair lies
// wholly inside or outside).  Each value is this thread's alone.
template <bool kPad>
__device__ __forceinline__ void add_totals(
    const float (&seg_r)[32], const float (&seg_i)[32], bool add,
    float* __restrict__ accr, float* __restrict__ acci, long long base,
    int row0, int col0, int ts2, size_t ext2) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = ((threadIdx.x / 32) % 4) * 16;  // this warp's 16 rows
#pragma unroll
  for (int nb8 = 0; nb8 < 8; ++nb8) {
    const int col = col0 + 8 * nb8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + r0 + g + 8 * h;
      if (kPad && (row >= ts2 || col >= ts2)) continue;
      const size_t off = base + row * ext2 + col;
      const int i = 4 * nb8 + 2 * h;
      float2 r = make_float2(0.f, 0.f), m = make_float2(0.f, 0.f);
      if (add) {
        r = *reinterpret_cast<const float2*>(accr + off);
        m = *reinterpret_cast<const float2*>(acci + off);
      }
      *reinterpret_cast<float2*>(accr + off) =
          make_float2(r.x + seg_r[i], r.y + seg_r[i + 1]);
      *reinterpret_cast<float2*>(acci + off) =
          make_float2(m.x + seg_i[i], m.y + seg_i[i + 1]);
    }
  }
}

// A lane's walk over its items; every producer thread holds the same.
struct Walk {
  long long hi;      // the lane's items lie below position hi
  int q, c, pos;     // the next item: pass, first chunk, position
  int cc, m0, cnt;   // the next batch: chunk, first slot, valid slots
  int s, p, jr0, jc0, batches, flags;
  long long base;    // the item's block of the colour planes
  int it;            // stages published
  int items, staged; // items opened and batches staged, for `stats`
  int cs_c, cs_p;    // the chunk and polarization in the lane's slots
  int cur;           // which of the lane's two slot buffers is cs_c's
  int nx_c, nx_p;    // the chunk prefetched into the other (-1: none)
  bool open, done;
};

// One stage of a lane's ring, by producer thread pt of R::kProducers:
// the next batch of the lane's item, an empty item's mark, or the end.
template <int BN, bool kPad>
__device__ __forceinline__ void produce_step(
    Walk& w, int pt, long long W, int passes, int tiles, int nbc,
    float* ring, ChunkSlots* cs, StageInfo* info, uint64_t* full,
    uint64_t* empty, const int* __restrict__ slot, int n,
    const int* __restrict__ count, const int* __restrict__ iu,
    const int* __restrict__ iv, const int* __restrict__ su,
    const int* __restrict__ sv, const float* __restrict__ sre,
    const float* __restrict__ sim, const float2* __restrict__ tab, int Mc,
    int P, int K, int ts2, int nt2) {
  using R = Ring<BN>;
  auto acquire = [&]() {
    const int st = w.it % R::kStages;
    mbar_wait(&empty[st], ((w.it / R::kStages) & 1) ^ 1);
    return st;
  };
  auto publish = [&](int st, int flags) {
    if (pt == 0) {
      StageInfo& in = info[st];
      in.base = w.base;
      in.jr0 = w.jr0;
      in.jc0 = w.jc0;
      in.flags = flags;
    }
    __syncwarp();
    if (pt % 32 == 0) mbar_arrive(&full[st]);
    ++w.it;
  };
  // The run's batches: (chunk cc, first slot m0), empty chunks skipped.
  auto settle = [&]() {
    while (w.m0 >= w.cnt) {
      ++w.cc;
      w.m0 = 0;
      if (w.cc >= n || slot[w.cc] != w.s) return false;
      w.cnt = count[w.cc];
    }
    return true;
  };
  auto close = [&]() {
    w.open = false;
    w.pos += kItemWeight + w.batches;
    w.c = w.cc;  // the next run's first chunk, or n
    if (w.c >= n) {
      ++w.q;
      w.c = 0;
      w.pos = 0;
    }
  };
  if (!w.open) {
    if (!(w.q < passes && w.q * W + w.pos < w.hi)) {
      publish(acquire(), kEnd);
      w.done = true;
      return;
    }
    ++w.items;
    const int t = w.q % tiles;
    w.p = w.q / tiles;
    w.jr0 = (t / nbc) * 64;
    w.jc0 = (t % nbc) * BN;
    // Decode the run's slot: colour (a, b) = tile parities, then the tile
    // of the colour plane; the planes are (2, 2, P, ext2, ext2) images.
    w.s = slot[w.c];
    const int colour = w.s / (nt2 * nt2);
    const int rem = w.s - colour * (nt2 * nt2);
    const int tv2 = rem / nt2;
    const int tu2 = rem - tv2 * nt2;
    const size_t ext2 = static_cast<size_t>(nt2) * ts2;
    w.base = static_cast<long long>(
        ((static_cast<size_t>(colour) * P + w.p) * ext2 +
         static_cast<size_t>(tv2) * ts2) * ext2 +
        static_cast<size_t>(tu2) * ts2);
    w.cc = w.c;
    w.m0 = 0;
    w.cnt = count[w.c];
    w.batches = 0;
    w.flags = kFirst;
    if (!settle()) {
      publish(acquire(), kFirst | kLast | kEmpty);
      close();
      return;
    }
    w.open = true;
  }
  // A new chunk: its slots are in the other buffer if they were
  // prefetched, else they load now.  The named barrier also tells that
  // every producer thread is done with the buffer that is reused.
  const bool fresh = w.cc != w.cs_c || w.p != w.cs_p;
  if (fresh) {
    bar_sync(1, R::kProducers);
    if (w.nx_c == w.cc && w.nx_p == w.p) {
      w.cur ^= 1;
    } else {
      load_chunk<BN>(cs[w.cur], w.cc, w.p, pt, iu, iv, su, sv, sre, sim, Mc,
                     P);
      bar_sync(1, R::kProducers);
    }
    w.cs_c = w.cc;
    w.cs_p = w.p;
    w.nx_c = -1;
  }
  // At a chunk's first batch, the next chunk's slots are loaded into
  // registers before this batch stages, and stored into the other buffer
  // after: its global loads overlap the staging.
  const int nx = w.cc + 1;
  const bool prefetch = fresh && nx < n;
  int4 pf_i[kMaxMc / R::kProducers];
  float2 pf_s[kMaxMc / R::kProducers];
  if (prefetch)
    fetch_slots<BN>(pf_i, pf_s, nx, w.p, pt, iu, iv, su, sv, sre, sim, Mc,
                    P);
  const int mb = w.m0, cb = w.cnt;
  w.m0 += kKB;
  const bool have = settle();
  const int st = acquire();
  stage_batch<BN, kPad>(ring + st * R::kStage, cs[w.cur], mb, cb, tab, K,
                        ts2, w.jr0, w.jc0, pt);
  publish(st, w.flags | (have ? 0 : kLast));
  if (prefetch) {
    store_slots<BN>(cs[w.cur ^ 1], pf_i, pf_s, pt, Mc);
    w.nx_c = nx;
    w.nx_p = w.p;
  }
  w.flags = 0;
  ++w.batches;
  ++w.staged;
  if (!have) close();
}

// Consumer warpgroup wg: each staged batch of its lane, its 64 columns of
// the tile, until the end.
template <int BN, bool kPad>
__device__ __forceinline__ void consume(int wg, float* ring, StageInfo* info,
                                        uint64_t* full, uint64_t* empty,
                                        float* __restrict__ accr,
                                        float* __restrict__ acci, int ts2,
                                        int nt2) {
  using R = Ring<BN>;
  constexpr bool kTurns = R::kLanes == 1;  // one lane: issue in turn
  const int cb = R::kLanes == 1 ? wg : 0;  // the tile's column half
  const size_t ext2 = static_cast<size_t>(nt2) * ts2;
  // The tensor cores' accumulators (one batch) and the segment's totals
  // (wgmma.cuh); the run's totals are in the planes.
  float acc_r[R::kAcc], acc_i[R::kAcc], seg_r[R::kAcc], seg_i[R::kAcc];
#pragma unroll
  for (int i = 0; i < R::kAcc; ++i) {
    acc_r[i] = 0.f;
    acc_i[i] = 0.f;
    seg_r[i] = 0.f;
    seg_i[i] = 0.f;
  }
  int stretches = 0;
  bool stored = false;  // the run's totals are in the planes
  // In turns: warpgroup 0 issues first; each waits at its own named
  // barrier (3 + wg) for the other's issue of the batch before.
  if (kTurns && wg == 1) bar_arrive(3, 256);
  for (int it = 0;; ++it) {
    const int st = it % R::kStages;
    mbar_wait(&full[st], (it / R::kStages) & 1);
    const StageInfo in = info[st];
    if (in.flags & kEnd) break;
    if (in.flags & kFirst) {
#pragma unroll
      for (int i = 0; i < R::kAcc; ++i) {
        seg_r[i] = 0.f;
        seg_i[i] = 0.f;
      }
      stretches = 0;
      stored = false;
    }
    if (!(in.flags & kEmpty)) {
      if (kTurns) bar_sync(3 + wg, 256);
      band_issue<BN>(acc_r, acc_i, ring + st * R::kStage, cb);
      if (kTurns) bar_arrive(3 + (wg ^ 1), 256);
      wgmma_wait_all();
      fence_operands(acc_r);
      fence_operands(acc_i);
    }
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[st]);  // planes read
    if (!(in.flags & kEmpty)) {
      promote(seg_r, acc_r);
      promote(seg_i, acc_i);
      if (++stretches == kSegment) {
        add_totals<kPad>(seg_r, seg_i, stored, accr, acci, in.base, in.jr0,
                         in.jc0 + 64 * cb, ts2, ext2);
#pragma unroll
        for (int i = 0; i < R::kAcc; ++i) {
          seg_r[i] = 0.f;
          seg_i[i] = 0.f;
        }
        stored = true;
        stretches = 0;
      }
    }
    if (in.flags & kLast)
      add_totals<kPad>(seg_r, seg_i, stored, accr, acci, in.base, in.jr0,
                       in.jc0 + 64 * cb, ts2, ext2);
  }
  if (kTurns && wg == 0) bar_sync(3, 256);  // the other's last turn
}

// Persistent: one CTA per SM (the grid), kThreads threads; the CTA's
// lanes take their items (find_starts) and run them.  kPad: the window
// has padding past 2ts.
template <int BN, bool kPad>
__global__ void __launch_bounds__(kThreads, 1)
grid_planes_kernel(const int* __restrict__ slot, int n,
                   const int* __restrict__ count,
                   const int* __restrict__ iu, const int* __restrict__ iv,
                   const int* __restrict__ su, const int* __restrict__ sv,
                   const float* __restrict__ sre,
                   const float* __restrict__ sim,
                   const float2* __restrict__ tab,
                   float* __restrict__ accr, float* __restrict__ acci,
                   int* __restrict__ stats, int Mc, int P, int K, int ts2,
                   int wp, int nt2) {
  using R = Ring<BN>;
  using L = Smem<BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Schedule sc;
  float* ring = reinterpret_cast<float*>(smem);
  ChunkSlots* cs = reinterpret_cast<ChunkSlots*>(smem + L::kSlots);
  StageInfo* info = reinterpret_cast<StageInfo*>(smem + L::kInfo);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + R::kLanes * R::kStages;
  if (threadIdx.x == 0)
    for (int i = 0; i < R::kLanes * R::kStages; ++i) {
      mbar_init(&full[i], R::kFullCount);
      mbar_init(&empty[i], R::kEmptyCount);
    }
  const int nbc = wp / BN;
  const int tiles = (wp / 64) * nbc;
  const int passes = P * tiles;
  find_starts<R::kLanes>(sc, slot, count, n, passes);
  const int wg = threadIdx.x / 128;
  if (wg >= kConsumers) {
    // The producer stages a batch of each lane in turn.
    const int pt = threadIdx.x - 128 * kConsumers;
    Walk w[R::kLanes];
#pragma unroll
    for (int l = 0; l < R::kLanes; ++l) {
      w[l].hi = sc.hi[l];
      w[l].cur = 0;
      w[l].nx_c = -1;
      w[l].q = sc.pass[l];
      w[l].c = sc.chunk[l];
      w[l].pos = sc.pos[l];
      if (w[l].c >= n) {
        ++w[l].q;
        w[l].c = 0;
        w[l].pos = 0;
      }
      w[l].it = 0;
      w[l].items = 0;
      w[l].staged = 0;
      w[l].cs_c = -1;
      w[l].cs_p = -1;
      w[l].open = false;
      w[l].done = false;
    }
    for (bool more = true; more;) {
      more = false;
#pragma unroll
      for (int l = 0; l < R::kLanes; ++l) {
        if (w[l].done) continue;
        produce_step<BN, kPad>(
            w[l], pt, sc.total, passes, tiles, nbc,
            ring + l * R::kStages * R::kStage, cs + 2 * l, info + l * R::kStages,
            full + l * R::kStages, empty + l * R::kStages, slot, n, count,
            iu, iv, su, sv, sre, sim, tab, Mc, P, K, ts2, nt2);
        more = more || !w[l].done;
      }
    }
    // Worker k = l gridDim.x + blockIdx.x: (items, batches) at 2 k.
    if (stats != nullptr && pt == 0) {
#pragma unroll
      for (int l = 0; l < R::kLanes; ++l) {
        const int k = l * gridDim.x + blockIdx.x;
        stats[2 * k] = w[l].items;
        stats[2 * k + 1] = w[l].staged;
      }
    }
  } else {
    const int lane = R::kLanes == 1 ? 0 : wg;
    consume<BN, kPad>(wg, ring + lane * R::kStages * R::kStage,
                      info + lane * R::kStages, full + lane * R::kStages,
                      empty + lane * R::kStages, accr, acci, ts2, nt2);
  }
}

template <int BN, bool kPad>
cudaError_t launch_grid_planes(const int* slot, int n, const int* count,
                               const int* iu, const int* iv, const int* su,
                               const int* sv, const float* sre,
                               const float* sim, const float2* tab,
                               float* accr, float* acci, int* stats, int Mc,
                               int P, int K, int ts2, int wp, int nt2,
                               cudaStream_t stream) {
  constexpr int kBytes = Smem<BN>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      grid_planes_kernel<BN, kPad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  grid_planes_kernel<BN, kPad><<<sms, kThreads, kBytes, stream>>>(
      slot, n, count, iu, iv, su, sv, sre, sim, tab, accr, acci, stats, Mc, P,
      K, ts2, wp, nt2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2 -- replaces katsdpimager_tpu/ops/pallas_gridder.py:_make_combine_kernel
// (launched by combine_planes_fused).
//
// What it computes: gr[p, r, c] = ((x00 + x01) + x10) + x11 with
// x_ab = accr[a, b, p, r - a ts, c - b ts] where that lies in the plane
// and its tile is occupied, else 0 (likewise gi from acci).  With
// `accumulate` the planes add onto the grid already in gr/gi, in the order
// of the JAX running-grid combine (pallas_gridder.py:grid_chunks_fused):
// gr = (((gr + x00) + x01) + x10) + x11.
//
// What bounds it on this card: device memory bandwidth (8 plane reads and
// 2 writes of 4 B per output pixel, about 0.7 GB at N = 4096, P = 1); no
// arithmetic to speak of.
//
// Design: one thread per output pixel, consecutive threads on consecutive
// columns, so every plane read and grid write is coalesced.  Occupancy is
// a byte per tile, read through L1.  The mask is a select, never a
// multiply, so NaNs in unwritten blocks cannot leak; the adds keep the JAX
// order and the file is built without fast-math, so the result is bitwise
// equal to the plain version.  It is CUDA rather than Triton so that all
// four kernels share one nvcc build.
// ---------------------------------------------------------------------------

__global__ void combine_planes_kernel(const float* __restrict__ accr,
                                      const float* __restrict__ acci,
                                      const unsigned char* __restrict__ occ,
                                      float* __restrict__ gr,
                                      float* __restrict__ gi, int P, int N,
                                      int ts, int nt2, int accumulate) {
  const size_t total = static_cast<size_t>(P) * N * N;
  const size_t idx =
      static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = static_cast<int>(idx % N);
  const int r = static_cast<int>((idx / N) % N);
  const int p = static_cast<int>(idx / (static_cast<size_t>(N) * N));
  const int ts2 = 2 * ts;
  const size_t ext2 = static_cast<size_t>(nt2) * ts2;
  float xr[4], xi[4];
#pragma unroll
  for (int ab = 0; ab < 4; ++ab) {
    const int a = ab >> 1, b = ab & 1;
    const int pr = r - a * ts;
    const int pc = c - b * ts;
    xr[ab] = 0.0f;
    xi[ab] = 0.0f;
    if (pr >= 0 && pc >= 0 &&
        occ[(ab * nt2 + pr / ts2) * nt2 + pc / ts2]) {
      const size_t off =
          ((static_cast<size_t>(ab) * P + p) * ext2 + pr) * ext2 + pc;
      xr[ab] = accr[off];
      xi[ab] = acci[off];
    }
  }
  if (accumulate) {
    gr[idx] = (((gr[idx] + xr[0]) + xr[1]) + xr[2]) + xr[3];
    gi[idx] = (((gi[idx] + xi[0]) + xi[1]) + xi[2]) + xi[3];
  } else {
    gr[idx] = ((xr[0] + xr[1]) + xr[2]) + xr[3];
    gi[idx] = ((xi[0] + xi[1]) + xi[2]) + xi[3];
  }
}

}  // namespace

// K1 takes every tile size ts in [1, kMaxTile] with K <= ts + 1: the
// window (2ts, padded to Wp = 64 ceil(2ts / 64)) in blocks of 64 rows by
// 128 columns where Wp is a multiple of 128, else by 64.
constexpr int kMaxTile = 256;

// stats: null, or room for (items, batches) of 2 x the SMs' workers.
extern "C" int ktt_grid_planes(const void* slot, int n, const void* count,
                               const void* iu, const void* iv,
                               const void* su, const void* sv,
                               const void* sre, const void* sim,
                               const void* tab, void* accr, void* acci,
                               void* stats, int NC, int Mc, int P, int K,
                               int ts, int nt2, void* stream) {
  if (n <= 0 || NC <= 0 || P <= 0 || P > 65535 || Mc <= 0 || Mc > kMaxMc ||
      ts <= 0 || ts > kMaxTile || K <= 0 || K > ts + 1)
    return cudaErrorInvalidValue;
  const int ts2 = 2 * ts;
  const int wp = 64 * ((ts2 + 63) / 64);
  auto launch = wp % 128 == 0
                    ? (wp == ts2 ? launch_grid_planes<128, false>
                                 : launch_grid_planes<128, true>)
                    : (wp == ts2 ? launch_grid_planes<64, false>
                                 : launch_grid_planes<64, true>);
  return launch(static_cast<const int*>(slot), n,
                static_cast<const int*>(count), static_cast<const int*>(iu),
                static_cast<const int*>(iv), static_cast<const int*>(su),
                static_cast<const int*>(sv), static_cast<const float*>(sre),
                static_cast<const float*>(sim),
                static_cast<const float2*>(tab), static_cast<float*>(accr),
                static_cast<float*>(acci), static_cast<int*>(stats), Mc, P,
                K, ts2, wp, nt2,
                static_cast<cudaStream_t>(stream));
}

extern "C" int ktt_combine_planes(const void* accr, const void* acci,
                                  const void* occ, void* gr, void* gi, int P,
                                  int N, int ts, int nt2, int accumulate,
                                  void* stream) {
  const size_t total = static_cast<size_t>(P) * N * N;
  if (total == 0) return cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  combine_planes_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(accr), static_cast<const float*>(acci),
      static_cast<const unsigned char*>(occ), static_cast<float*>(gr),
      static_cast<float*>(gi), P, N, ts, nt2, accumulate);
  return cudaGetLastError();
}
