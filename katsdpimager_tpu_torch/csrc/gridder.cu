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
// What bounds it on this card: the band products, (2ts)^2 complex MACs per
// valid visibility on the dense window; at the production plan the
// roofline (K^2 taps per visibility at the FP32 rate, 67 TFLOP/s) is
// 0.23 ms, the bytes written 0.15 ms.
//
// Design: the window, padded to Wp = 64 ceil(2ts / 64) rows and columns,
// is cut into blocks of 64 rows by BN = 128 (Wp a multiple of 128) or 64
// (otherwise) columns; one CTA per anchor run and block (grid NC x P x
// (Wp / 64) (Wp / BN)), one warpgroup per 64 columns of the block, each
// holding its 64 x 64 complex sub-block.  A CTA whose chunk is not the
// first of its run exits at once.  The CTA loops over its run's chunks,
// and in each over the valid slots only, kKB = 16 visibilities at a time
// (two wgmma k-steps): padding costs nothing.  The block is a complex
// matrix product A^T B over the staged visibilities, A[m, j] = conj(K_v)
// sample for the block's rows j and B[m, k] = conj(K_u) for its columns
// k, computed on the tensor cores with wgmma.mma_async m64n64k8 TF32 as four
// real products in the 3xTF32 scheme (wgmma_tf32x3): each staged operand
// is split once into hi = tf32_rna(x) and lo = tf32_rna(x - hi), and every
// product sums lo*hi + hi*lo + hi*hi, so the band keeps FP32 accuracy;
// plain TF32 would not.  A and B come from shared memory through
// descriptors, -Bi by the instruction's B scale of -1.  Rows and columns
// at or past 2ts (the padding) stage as zeros and are never stored.
//
// Accumulation (wgmma.cuh): the tensor cores' FP32 sums truncate, and
// their error grows with the adds they take (6 a k-step into each of the
// real and imaginary accumulators).  So each warpgroup's accumulators
// sum one batch (kPromoteSteps k-steps) afresh (scale_d = 0), and are
// then promoted by IEEE adds into FP32 totals in registers, a segment's
// and, every kSegment batches, the run's; the totals are stored once, at
// the end of the run.  The accumulators and two totals of a 64 x 64
// complex sub-block take 192 registers a thread, which is why a
// warpgroup holds 64 columns (a 64 x 128 sub-block would need 384): at
// ts 64 a run takes two CTAs, each staging its 64 rows of A and all 128
// columns of B.  (The schedule before, one accumulator per 128 x 128
// block promoted into the plane every 32 k-steps, was 3-4e-6 of the
// peak from a float64 run; this one 2.7-4.3e-7, on an H100.)
//
// Each chunk's slot data is loaded into shared memory once; while batch
// b's wgmmas run, the same threads write batch b + 1's split operands
// (double buffered), one barrier per batch.  The JAX kernel's one-hot
// selection and lane shift become an indexed table load with a bounds
// test.  Each thread stores its own totals into the run's block, pairs of
// floats (8-byte aligned for every ts: 2ts and so the plane's row stride
// are even), once: no atomics, so the result does not depend on
// scheduling.
//
// Why not the alternatives (measured, PERF.md): mma.sync m16n8k8 runs TF32
// at a quarter of wgmma's rate; with A in registers the issuing warp's own
// staging does not overlap its wgmmas; a separate staging warpgroup (12
// warps) caps registers at 168 and stages too slowly; skipping a
// warpgroup whose rows a batch misses never pays at 64-row granularity (a
// batch of K = 60 taps misses one only when all its sv <= 4).
// ---------------------------------------------------------------------------

// Visibilities per batch: one stretch of kPromoteSteps wgmma k-steps of
// 8, staged in one round and promoted at its end.
constexpr int kKB = 8 * kPromoteSteps;
constexpr int kMaxMc = 256;    // slots per chunk held in shared memory

// One CTA's block of the window, 64 rows x BN columns complex, one
// warpgroup per 64 columns.  A staged batch holds kKB visibilities in
// eight planes, A (re hi, re lo, im hi, im lo; 64 rows) then B (likewise;
// BN columns), each in the K-major core-matrix layout of smem_desc: row r
// (j - the block's first row for A, k - its first column for B), slot m
// at float ((r / 8) (kKB / 4) + m / 4) 32 + (r % 8) 4 + m % 4.
template <int BN>
struct BandTile {
  static constexpr int kThreads = 2 * BN;     // one warpgroup per 64 cols
  static constexpr int kPlaneA = kKB * 64;    // floats
  static constexpr int kPlaneB = kKB * BN;
  static constexpr int kStage = 4 * kPlaneA + 4 * kPlaneB;
  static constexpr int kSmemBytes =
      2 * kStage * static_cast<int>(sizeof(float));
  static constexpr int kAcc = 32;  // m64n64 accumulators a thread, each
};

// One chunk's slot data, loaded once per chunk into shared memory.
struct __align__(16) ChunkSlots {
  int iv[kMaxMc], sv[kMaxMc], iu[kMaxMc], su[kMaxMc];
  float sr[kMaxMc], si[kMaxMc];
};

template <int BN>
__device__ __forceinline__ void load_chunk(
    ChunkSlots& cs, int c, int cnt, int p, const int* __restrict__ iu,
    const int* __restrict__ iv, const int* __restrict__ su,
    const int* __restrict__ sv, const float* __restrict__ sre,
    const float* __restrict__ sim, int Mc, int P) {
  const size_t cm = static_cast<size_t>(c) * Mc;
  const size_t cp = (static_cast<size_t>(c) * P + p) * Mc;
  for (int m = threadIdx.x; m < cnt; m += BandTile<BN>::kThreads) {
    cs.iv[m] = iv[cm + m];
    cs.sv[m] = sv[cm + m];
    cs.iu[m] = iu[cm + m];
    cs.su[m] = su[cm + m];
    cs.sr[m] = sre[cp + m];
    cs.si[m] = sim[cp + m];
  }
}

// Offset (floats) of row r, slots 4 k4 .. 4 k4 + 3 in a staged plane.
__device__ __forceinline__ int core_offset(int r, int k4) {
  return ((r >> 3) * (kKB / 4) + k4) * 32 + (r & 7) * 4;
}

// Visibilities m0 .. m0 + kKB - 1 of the chunk in `cs` (slots at or past
// cnt give zeros) as split planes, for window rows jr0 .. jr0 + 63 (A)
// and columns jc0 .. jc0 + BN - 1 (B); rows and columns at or past ts2
// give zeros.  A thread takes one row (or column) and 4 consecutive
// slots, whose slot data it reads as vectors and whose 4 values per plane
// are contiguous in the core-matrix layout: one 16-byte store per plane,
// free of bank conflicts.  A's products are split here; B's split comes
// ready from `tabs`.  Ends with the async-proxy fence.
template <int BN, bool kPad>
__device__ __forceinline__ void stage_batch(float* S, const ChunkSlots& cs,
                                            int m0, int cnt,
                                            const float2* __restrict__ tab,
                                            const float4* __restrict__ tabs,
                                            int K, int ts2, int jr0,
                                            int jc0) {
  using T = BandTile<BN>;
#pragma unroll
  for (int grp = threadIdx.x; grp < (kKB / 4) * 64; grp += T::kThreads) {
    const int j = grp % 64;
    const int k4 = grp / 64;
    const int jr = jr0 + j;
    const int mq = m0 + 4 * k4;
    const int4 sv4 = *reinterpret_cast<const int4*>(cs.sv + mq);
    const int4 iv4 = *reinterpret_cast<const int4*>(cs.iv + mq);
    const float4 sr4 = *reinterpret_cast<const float4*>(cs.sr + mq);
    const float4 si4 = *reinterpret_cast<const float4*>(cs.si + mq);
    const int svs[4] = {sv4.x, sv4.y, sv4.z, sv4.w};
    const int ivs[4] = {iv4.x, iv4.y, iv4.z, iv4.w};
    const float srs[4] = {sr4.x, sr4.y, sr4.z, sr4.w};
    const float sis[4] = {si4.x, si4.y, si4.z, si4.w};
    float v[4][4];  // [plane][slot]: re hi, re lo, im hi, im lo
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float ar = 0.f, ai = 0.f;
      const int dv = jr - svs[u];
      if (mq + u < cnt && (!kPad || jr < ts2) && dv >= 0 && dv < K) {
        const float2 t = tab[ivs[u] * K + dv];
        ar = t.x * srs[u] - t.y * sis[u];
        ai = t.x * sis[u] + t.y * srs[u];
      }
      const float rh = __uint_as_float(tf32_rna(ar));
      const float ih = __uint_as_float(tf32_rna(ai));
      v[0][u] = rh;
      v[1][u] = __uint_as_float(tf32_rna(ar - rh));
      v[2][u] = ih;
      v[3][u] = __uint_as_float(tf32_rna(ai - ih));
    }
    const int off = core_offset(j, k4);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(S + q * T::kPlaneA + off) =
          make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
  }
#pragma unroll
  for (int grp = threadIdx.x; grp < (kKB / 4) * BN; grp += T::kThreads) {
    const int j = grp % BN;
    const int k4 = grp / BN;
    const int jc = jc0 + j;
    const int mq = m0 + 4 * k4;
    const int4 su4 = *reinterpret_cast<const int4*>(cs.su + mq);
    const int4 iu4 = *reinterpret_cast<const int4*>(cs.iu + mq);
    const int sus[4] = {su4.x, su4.y, su4.z, su4.w};
    const int ius[4] = {iu4.x, iu4.y, iu4.z, iu4.w};
    float v[4][4];  // [plane][slot]: re hi, re lo, im hi, im lo
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      const int du = jc - sus[u];
      if (mq + u < cnt && (!kPad || jc < ts2) && du >= 0 && du < K)
        b = tabs[ius[u] * K + du];
      v[0][u] = b.x;
      v[1][u] = b.y;
      v[2][u] = b.z;
      v[3][u] = b.w;
    }
    const int off = core_offset(j, k4);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      *reinterpret_cast<float4*>(S + 4 * T::kPlaneA + q * T::kPlaneB +
                                 off) =
          make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
  }
  fence_proxy_async();
}

// Warpgroup wg's band sums of a staged batch, afresh, in 3xTF32: for
// each k-step, re += Ar Br - Ai Bi, im += Ar Bi + Ai Br, each product by
// wgmma_tf32x3.  Issues the wgmmas and commits them; the caller waits.
template <int BN>
__device__ __forceinline__ void band_issue(float (&acc_r)[32],
                                           float (&acc_i)[32],
                                           const float* S, int wg) {
  using T = BandTile<BN>;
  fence_operands(acc_r);
  fence_operands(acc_i);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kPromoteSteps; ++ks) {
    // Planes A re hi .. A im lo (the block's 64 rows), B re hi .. B im lo
    // at the warpgroup's 64 columns (8 groups of 8), at k-step ks (the
    // next 8 slots: 2 core matrices along K): LBO the next 4 slots, SBO
    // the next 8 rows.
    uint64_t a[4], b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = smem_desc(S + q * T::kPlaneA + ks * 64, 128, 128 * (kKB / 4));
      b[q] = smem_desc(S + 4 * T::kPlaneA + q * T::kPlaneB + ks * 64 +
                           wg * 8 * (kKB / 4) * 32,
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

// The band of the anchor run that starts at chunk c0, polarization p, for
// the block of window rows jr0 .. jr0 + 63 and columns jc0 .. jc0 + BN -
// 1, written into the run's block of the colour plane.  Every thread of
// the CTA enters; the shared memory is the caller's.
template <int BN, bool kPad>
__device__ __forceinline__ void grid_run(
    int c0, int p, int jr0, int jc0, float* stage, ChunkSlots& cs,
    const int* __restrict__ slot, int n, const int* __restrict__ count,
    const int* __restrict__ iu, const int* __restrict__ iv,
    const int* __restrict__ su, const int* __restrict__ sv,
    const float* __restrict__ sre, const float* __restrict__ sim,
    const float2* __restrict__ tab, const float4* __restrict__ tabs,
    float* __restrict__ accr, float* __restrict__ acci, int Mc, int P, int K,
    int ts2, int nt2) {
  using T = BandTile<BN>;
  const int s = slot[c0];
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int wg = threadIdx.x / 128;             // this warpgroup's columns
  const int r0 = ((threadIdx.x / 32) % 4) * 16; // this warp's 16 rows

  // The tensor cores' accumulators (one stretch), the segment's totals
  // and the run's (wgmma.cuh).
  float acc_r[T::kAcc], acc_i[T::kAcc], seg_r[T::kAcc], seg_i[T::kAcc],
      tot_r[T::kAcc], tot_i[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) {
    acc_r[i] = 0.f;
    acc_i[i] = 0.f;
    seg_r[i] = 0.f;
    seg_i[i] = 0.f;
    tot_r[i] = 0.f;
    tot_i[i] = 0.f;
  }

  // The run's batches: (chunk c, first slot m0), empty chunks skipped.
  // Each warpgroup issues batch b's wgmmas (both operands in shared
  // memory, so the issue holds no registers), then every thread stages
  // batch b + 1 into the other buffer while they run, then waits: one
  // barrier per batch, one more when a chunk's slots load.
  int c = c0, m0 = 0, cnt = count[c0];
  auto settle = [&]() {
    while (m0 >= cnt) {
      ++c;
      m0 = 0;
      if (c >= n || slot[c] != s) return false;
      cnt = count[c];
    }
    return true;
  };
  auto stage_at = [&](float* S, bool new_chunk) {
    if (new_chunk) {
      // The wgmmas in flight read only their own staged planes.
      load_chunk<BN>(cs, c, cnt, p, iu, iv, su, sv, sre, sim, Mc, P);
      __syncthreads();
    }
    stage_batch<BN, kPad>(S, cs, m0, cnt, tab, tabs, K, ts2, jr0, jc0);
  };
  // One batch: its wgmmas, the next batch staged while they run, the
  // wait and the promotion; returns whether the run has a next batch.
  int buf = 0, stretches = 0;
  auto band_step = [&]() {
    const float* S = stage + buf * T::kStage;
    const int c_now = c;
    m0 += kKB;
    const bool next = settle();
    band_issue<BN>(acc_r, acc_i, S, wg);
    if (next) stage_at(stage + (buf ^ 1) * T::kStage, c != c_now);
    wgmma_wait_all();
    fence_operands(acc_r);
    fence_operands(acc_i);
    promote(seg_r, acc_r);
    promote(seg_i, acc_i);
    if (++stretches == kSegment) {
      promote<true>(tot_r, seg_r);
      promote<true>(tot_i, seg_i);
      stretches = 0;
    }
    __syncthreads();
    buf ^= 1;
    return next;
  };
  bool have = settle();
  if (have) stage_at(stage, true);
  __syncthreads();
  while (have) have = band_step();
  promote(tot_r, seg_r);
  promote(tot_i, seg_i);

  // Decode the slot: colour (a, b) = tile parities, then the tile of the
  // colour plane; the planes are (2, 2, P, ext2, ext2) images.  Total i
  // of n8 block nb8: block row r0 + g (+ 8 for i & 2), column 64 wg +
  // 8 nb8 + 2 t (+ 1 for i & 1); the window's padding past ts2 is not
  // stored (ts2 is even, so a pair lies wholly inside or outside).
  const int colour = s / (nt2 * nt2);
  const int rem = s - colour * (nt2 * nt2);
  const int tv2 = rem / nt2;
  const int tu2 = rem - tv2 * nt2;
  const size_t ext2 = static_cast<size_t>(nt2) * ts2;
  const size_t base =
      ((static_cast<size_t>(colour) * P + p) * ext2 +
       static_cast<size_t>(tv2) * ts2) * ext2 +
      static_cast<size_t>(tu2) * ts2;
#pragma unroll
  for (int nb8 = 0; nb8 < 8; ++nb8) {
    const int col = jc0 + 64 * wg + 8 * nb8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = jr0 + r0 + g + 8 * h;
      if (kPad && (row >= ts2 || col >= ts2)) continue;
      const size_t off = base + row * ext2 + col;
      const int i = 4 * nb8 + 2 * h;
      *reinterpret_cast<float2*>(accr + off) =
          make_float2(tot_r[i], tot_r[i + 1]);
      *reinterpret_cast<float2*>(acci + off) =
          make_float2(tot_i[i], tot_i[i + 1]);
    }
  }
}

// One CTA per chunk c0 (grid x), polarization (y) and block of the
// window (z: row block z / nbc, column block z % nbc); the CTA whose chunk
// starts a run grids it.  kPad: the window has padding past 2ts.
template <int BN, bool kPad>
__global__ void __launch_bounds__(BandTile<BN>::kThreads, 1)
grid_planes_kernel(const int* __restrict__ slot, int n,
                   const int* __restrict__ count,
                   const int* __restrict__ iu, const int* __restrict__ iv,
                   const int* __restrict__ su, const int* __restrict__ sv,
                   const float* __restrict__ sre,
                   const float* __restrict__ sim,
                   const float2* __restrict__ tab,
                   const float4* __restrict__ tabs,
                   float* __restrict__ accr, float* __restrict__ acci,
                   int Mc, int P, int K, int ts2, int nbc, int nt2) {
  const int c0 = blockIdx.x;
  if (c0 >= n) return;
  if (c0 > 0 && slot[c0 - 1] == slot[c0]) return;  // not a run's first chunk
  extern __shared__ __align__(128) float stage[];  // [2][kStage]
  __shared__ ChunkSlots cs;                    // the current chunk's slots
  grid_run<BN, kPad>(c0, blockIdx.y, (blockIdx.z / nbc) * 64,
                     (blockIdx.z % nbc) * BN, stage, cs, slot, n, count, iu,
                     iv, su, sv, sre, sim, tab, tabs, accr, acci, Mc, P, K,
                     ts2, nt2);
}

template <int BN, bool kPad>
cudaError_t launch_grid_planes(const int* slot, int n, const int* count,
                               const int* iu, const int* iv, const int* su,
                               const int* sv, const float* sre,
                               const float* sim, const float2* tab,
                               const float4* tabs, float* accr, float* acci,
                               int NC, int Mc, int P, int K, int ts2, int wp,
                               int nt2, cudaStream_t stream) {
  using T = BandTile<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      grid_planes_kernel<BN, kPad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int nbc = wp / BN;
  grid_planes_kernel<BN, kPad><<<dim3(NC, P, (wp / 64) * nbc), T::kThreads,
                                 T::kSmemBytes, stream>>>(
      slot, n, count, iu, iv, su, sv, sre, sim, tab, tabs, accr, acci, Mc, P,
      K, ts2, nbc, nt2);
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

extern "C" int ktt_grid_planes(const void* slot, int n, const void* count,
                               const void* iu, const void* iv,
                               const void* su, const void* sv,
                               const void* sre, const void* sim,
                               const void* tab, const void* tabs, void* accr,
                               void* acci, int NC, int Mc, int P, int K,
                               int ts, int nt2, void* stream) {
  if (n <= 0 || NC <= 0 || P <= 0 || P > 65535 || Mc <= 0 || Mc > kMaxMc ||
      ts <= 0 || ts > kMaxTile || K <= 0 || K > ts + 1)
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<const int*>(slot);
  auto cn = static_cast<const int*>(count);
  auto u = static_cast<const int*>(iu);
  auto v = static_cast<const int*>(iv);
  auto du = static_cast<const int*>(su);
  auto dv = static_cast<const int*>(sv);
  auto r = static_cast<const float*>(sre);
  auto i = static_cast<const float*>(sim);
  auto t = static_cast<const float2*>(tab);
  auto ts4 = static_cast<const float4*>(tabs);
  auto ar = static_cast<float*>(accr);
  auto ai = static_cast<float*>(acci);
  const int ts2 = 2 * ts;
  const int wp = 64 * ((ts2 + 63) / 64);
  if (wp % 128 == 0)
    return wp == ts2 ? launch_grid_planes<128, false>(
                           s, n, cn, u, v, du, dv, r, i, t, ts4, ar, ai, NC,
                           Mc, P, K, ts2, wp, nt2, st)
                     : launch_grid_planes<128, true>(
                           s, n, cn, u, v, du, dv, r, i, t, ts4, ar, ai, NC,
                           Mc, P, K, ts2, wp, nt2, st);
  return wp == ts2 ? launch_grid_planes<64, false>(s, n, cn, u, v, du, dv, r,
                                                   i, t, ts4, ar, ai, NC, Mc,
                                                   P, K, ts2, wp, nt2, st)
                   : launch_grid_planes<64, true>(s, n, cn, u, v, du, dv, r,
                                                  i, t, ts4, ar, ai, NC, Mc,
                                                  P, K, ts2, wp, nt2, st);
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
