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
// is cut into square blocks of B = 128 (Wp a multiple of 128) or 64
// (otherwise); one CTA per anchor run and block (grid NC x P x
// (Wp / B)^2), so ts 32 and 64 keep one CTA per run, and a thread never
// holds more than 64 + 64 accumulators (a 256- or 512-wide band at ts 128
// or 256 would not fit one CTA's registers).  A CTA whose chunk is not
// the first of its run exits at once.  The CTA loops over its run's
// chunks, and in each over the valid slots only, kKB = 8 visibilities at a
// time (the MMA depth): padding costs nothing.  The block is a complex
// matrix product A^T B over the staged visibilities, A[m, j] = conj(K_v)
// sample for the block's rows j and B[m, k] = conj(K_u) for its columns
// k, computed on the tensor cores with wgmma.mma_async m64nBk8 TF32 as
// four real products in the 3xTF32 scheme: each staged operand is split
// once into hi = tf32_rna(x) and lo = tf32_rna(x - hi), and every product
// sums lo*hi + hi*lo + hi*hi in FP32 accumulators (the lo*lo term, below
// 2^-22 of the product, is dropped), so the band keeps FP32 accuracy;
// plain TF32 would not.  One warpgroup per 64 rows of the block keeps its
// rows in accumulator registers across the run; A and B come from shared
// memory through descriptors, -Bi by the instruction's B scale of -1.
// Rows and columns at or past 2ts (the padding) stage as zeros and are
// never stored.  Every kPromote batches of a longer run the accumulators
// are promoted into the run's block of the plane by IEEE adds: the tensor
// cores' accumulation loses more than rounding would, and its error grows
// with the adds it takes (see kPromote).  A wide window (kWide: any ts but
// 32 and 64, whose window is one unpadded block) does so in the one
// kernel.  At ts 32 and 64 (the production tile), where most runs hold
// one or two chunks, the promotion's code in the band loop would cost
// every run: there each CTA first counts its run's batches (run_batches)
// and then takes one of two bodies, the code without promotion or bounds
// tests for a short run (at most kPromote batches) and the promoting code
// for a long one.
// Each chunk's slot data is loaded into shared memory once;
// while batch b's wgmmas run, the same threads write batch b + 1's split
// operands (double buffered), one barrier per batch.  The JAX kernel's
// one-hot selection and lane shift become an indexed table load with a
// bounds test.  Each thread stores its own elements of the run's block,
// pairs of floats (8-byte aligned for every ts: 2ts and so the plane's
// row stride are even), at the end of the run and at each promotion: no
// atomics, so the result does not depend on scheduling.
//
// Why not the alternatives (measured, PERF.md): mma.sync m16n8k8 runs TF32
// at a quarter of wgmma's rate; with A in registers the issuing warp's own
// staging does not overlap its wgmmas; a separate staging warpgroup (12
// warps) caps registers at 168 and stages too slowly; skipping a
// warpgroup whose rows a batch misses never pays at 64-row granularity (a
// batch of K = 60 taps misses one only when all its sv <= 4).
// ---------------------------------------------------------------------------

constexpr int kKB = 8;         // visibilities per batch (the MMA depth)
constexpr int kMaxMc = 256;    // slots per chunk held in shared memory

// One CTA's block of the window, B x B complex, over B / 64 warpgroups
// of 64 rows.  A staged batch holds kKB visibilities in eight planes, A
// (re hi, re lo, im hi, im lo) then B (likewise), each in the K-major
// core-matrix layout of smem_desc: row r (j - the block's first row for
// A, k - its first column for B), slot m at float
// ((r / 8) (kKB / 4) + m / 4) 32 + (r % 8) 4 + m % 4.
template <int B>
struct BandTile {
  static constexpr int kThreads = 2 * B;      // one warpgroup per 64 rows
  static constexpr int kPlane = kKB * B;      // floats
  static constexpr int kStage = 8 * kPlane;
  static constexpr int kSmemBytes =
      2 * kStage * static_cast<int>(sizeof(float));
  static constexpr int kAcc = B / 2;          // accumulators a thread, each
  static constexpr int kSteps = kKB / 8;      // wgmma k-steps a batch
};

// Batches the tensor cores accumulate before the sums are promoted into
// the run's block of the colour plane.  A wgmma's FP32 accumulation
// loses more than IEEE rounding would (it appears to truncate), and its
// error grows with the number of adds (measured on an H100 against a
// float64 reference:
// 5.2e-5 of the peak at ts = 128, K = 128 and 1.7e-4 at ts = 256, K = 200
// when a run's sums stayed in the accumulators, against 5e-7 for FP32
// sums on the CUDA cores); the promoted totals take IEEE adds, so each
// stretch of kPromote batches (6 kPromote adds a value) bounds it: with
// kPromote = 32, 4.0e-6 and 3.7e-6 at those two.  A run of at most
// kPromote batches is stored once.  The totals live in the plane, not
// in shared memory: 128 KB more of it would leave the L1 cache that K1's
// table loads go through too small.  At ts 64, promoting in the one band
// loop cost every run 8% (kPromote 32) to 16% (16) of K1's time, though
// most runs there are short: hence the two bodies at ts 32 and 64.
constexpr int kPromote = 32;

// One chunk's slot data, loaded once per chunk into shared memory.
struct __align__(16) ChunkSlots {
  int iv[kMaxMc], sv[kMaxMc], iu[kMaxMc], su[kMaxMc];
  float sr[kMaxMc], si[kMaxMc];
};

template <int B>
__device__ __forceinline__ void load_chunk(
    ChunkSlots& cs, int c, int cnt, int p, const int* __restrict__ iu,
    const int* __restrict__ iv, const int* __restrict__ su,
    const int* __restrict__ sv, const float* __restrict__ sre,
    const float* __restrict__ sim, int Mc, int P) {
  const size_t cm = static_cast<size_t>(c) * Mc;
  const size_t cp = (static_cast<size_t>(c) * P + p) * Mc;
  for (int m = threadIdx.x; m < cnt; m += BandTile<B>::kThreads) {
    cs.iv[m] = iv[cm + m];
    cs.sv[m] = sv[cm + m];
    cs.iu[m] = iu[cm + m];
    cs.su[m] = su[cm + m];
    cs.sr[m] = sre[cp + m];
    cs.si[m] = sim[cp + m];
  }
}

// Visibilities m0 .. m0 + kKB - 1 of the chunk in `cs` (slots at or past
// cnt give zeros) as split planes, for window rows jr0 .. jr0 + B - 1 (A)
// and columns jc0 .. jc0 + B - 1 (B); rows and columns at or past ts2
// give zeros.
// A thread takes one block position j and 4 consecutive slots, whose
// slot data it reads as vectors and whose 4 values per plane are
// contiguous in the core-matrix layout: one 16-byte store per plane,
// free of bank conflicts.  A's products are split here; B's split comes
// ready from `tabs`.  Ends with the async-proxy fence.
template <int B, bool kWide>
__device__ __forceinline__ void stage_batch(float* S, const ChunkSlots& cs,
                                            int m0, int cnt,
                                            const float2* __restrict__ tab,
                                            const float4* __restrict__ tabs,
                                            int K, int ts2, int jr0,
                                            int jc0) {
  using T = BandTile<B>;
#pragma unroll
  for (int grp = threadIdx.x; grp < (kKB / 4) * B; grp += T::kThreads) {
    const int j = grp % B;
    const int k4 = grp / B;
    const int jr = jr0 + j;
    const int jc = jc0 + j;
    const int mq = m0 + 4 * k4;
    const int4 sv4 = *reinterpret_cast<const int4*>(cs.sv + mq);
    const int4 iv4 = *reinterpret_cast<const int4*>(cs.iv + mq);
    const int4 su4 = *reinterpret_cast<const int4*>(cs.su + mq);
    const int4 iu4 = *reinterpret_cast<const int4*>(cs.iu + mq);
    const float4 sr4 = *reinterpret_cast<const float4*>(cs.sr + mq);
    const float4 si4 = *reinterpret_cast<const float4*>(cs.si + mq);
    const int svs[4] = {sv4.x, sv4.y, sv4.z, sv4.w};
    const int ivs[4] = {iv4.x, iv4.y, iv4.z, iv4.w};
    const int sus[4] = {su4.x, su4.y, su4.z, su4.w};
    const int ius[4] = {iu4.x, iu4.y, iu4.z, iu4.w};
    const float srs[4] = {sr4.x, sr4.y, sr4.z, sr4.w};
    const float sis[4] = {si4.x, si4.y, si4.z, si4.w};
    float v[8][4];  // [plane][slot]: A re hi, re lo, im hi, im lo; B ...
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool live = mq + u < cnt;
      float ar = 0.f, ai = 0.f;
      const int dv = jr - svs[u];
      if (live && (!kWide || jr < ts2) && dv >= 0 && dv < K) {
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
      float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
      const int du = jc - sus[u];
      if (live && (!kWide || jc < ts2) && du >= 0 && du < K)
        b = tabs[ius[u] * K + du];
      v[4][u] = b.x;
      v[5][u] = b.y;
      v[6][u] = b.z;
      v[7][u] = b.w;
    }
    const int off = ((j >> 3) * (kKB / 4) + k4) * 32 + (j & 7) * 4;
#pragma unroll
    for (int q = 0; q < 8; ++q)
      *reinterpret_cast<float4*>(S + q * T::kPlane + off) =
          make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);
  }
  fence_proxy_async();
}

// Warpgroup wg's band update from a staged batch, in 3xTF32: for each
// k-step and each of the terms lo hi, hi lo, hi hi: re += Ar Br - Ai Bi,
// im += Ar Bi + Ai Br.  Issues the wgmmas and commits them; the caller
// waits.
template <int B>
__device__ __forceinline__ void band_issue(
    float (&acc_r)[BandTile<B>::kAcc], float (&acc_i)[BandTile<B>::kAcc],
    const float* S, int wg) {
  using T = BandTile<B>;
  fence_operands(acc_r);
  fence_operands(acc_i);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < T::kSteps; ++ks) {
    // Planes A re hi .. A im lo, B re hi .. B im lo at k-step ks (the
    // next 8 slots: 2 core matrices along K); A from the warpgroup's 64
    // rows (8 groups of 8).  LBO: the next 4 slots; SBO: the next 8 rows.
    uint64_t desc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      desc[q] = smem_desc(S + q * T::kPlane + ks * 64 +
                              (q < 4 ? wg * 8 * (kKB / 4) * 32 : 0),
                          128, 128 * (kKB / 4));
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      const int ah = term == 0 ? 1 : 0;  // A lo in the first term
      const int bh = term == 1 ? 1 : 0;  // B lo in the second
      wgmma_tf32<1>(acc_r, desc[ah], desc[4 + bh]);
      wgmma_tf32<1>(acc_i, desc[ah], desc[6 + bh]);
      wgmma_tf32<-1>(acc_r, desc[2 + ah], desc[6 + bh]);
      wgmma_tf32<1>(acc_i, desc[2 + ah], desc[4 + bh]);
    }
  }
  wgmma_commit();
}

// The band of the anchor run that starts at chunk c0, polarization p, for
// the block of window rows jr0 .. and columns jc0 .. (both 0 but in a wide
// window), written into the run's block of the colour plane.  With
// kPromoteSums the accumulators are promoted into the plane every
// kPromote batches.  Every thread of the CTA enters; the shared memory is
// the caller's.
template <int B, bool kWide, bool kPromoteSums>
__device__ __forceinline__ void grid_run(
    int c0, int p, int jr0, int jc0, float* stage, ChunkSlots& cs,
    const int* __restrict__ slot, int n, const int* __restrict__ count,
    const int* __restrict__ iu, const int* __restrict__ iv,
    const int* __restrict__ su, const int* __restrict__ sv,
    const float* __restrict__ sre, const float* __restrict__ sim,
    const float2* __restrict__ tab, const float4* __restrict__ tabs,
    float* __restrict__ accr, float* __restrict__ acci, int Mc, int P, int K,
    int ts2, int nt2) {
  using T = BandTile<B>;
  // The window's extent: a window that is one unpadded block (ts 32 and
  // 64) knows it at compile time.
  const int w2 = kWide ? ts2 : B;
  const int s = slot[c0];

  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;      // this warp's 16 rows

  float acc_r[T::kAcc];
  float acc_i[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) {
    acc_r[i] = 0.f;
    acc_i[i] = 0.f;
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
      load_chunk<B>(cs, c, cnt, p, iu, iv, su, sv, sre, sim, Mc, P);
      __syncthreads();
    }
    stage_batch<B, kWide>(S, cs, m0, cnt, tab, tabs, K, w2, jr0, jc0);
  };
  // Decode the slot: colour (a, b) = tile parities, then the tile of the
  // colour plane; the planes are (2, 2, P, ext2, ext2) images.
  const int colour = s / (nt2 * nt2);
  const int rem = s - colour * (nt2 * nt2);
  const int tv2 = rem / nt2;
  const int tu2 = rem - tv2 * nt2;
  const size_t ext2 = static_cast<size_t>(nt2) * w2;
  const size_t base =
      ((static_cast<size_t>(colour) * P + p) * ext2 +
       static_cast<size_t>(tv2) * w2) * ext2 +
      static_cast<size_t>(tu2) * w2;
  // Stores this thread's accumulators into the run's block, added onto
  // what an earlier promotion stored there (the thread's own values).
  // Accumulator i of n8 block nb8: block row g (+ 8 for i & 2), block
  // column 8 nb8 + 2 t (+ 1 for i & 1); the window's padding past w2 is
  // not stored (w2 is even, so a pair lies wholly inside or outside).
  bool promoted = false;
  auto flush = [&]() {
#pragma unroll
    for (int nb8 = 0; nb8 < B / 8; ++nb8) {
      const int col = jc0 + 8 * nb8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = jr0 + r0 + g + 8 * h;
        if (kWide && (row >= w2 || col >= w2)) continue;
        const size_t off = base + row * ext2 + col;
        const int i = 4 * nb8 + 2 * h;
        float2 re = make_float2(acc_r[i], acc_r[i + 1]);
        float2 im = make_float2(acc_i[i], acc_i[i + 1]);
        if (kPromoteSums && promoted) {
          const float2 tr = *reinterpret_cast<const float2*>(accr + off);
          const float2 ti = *reinterpret_cast<const float2*>(acci + off);
          re = make_float2(tr.x + re.x, tr.y + re.y);
          im = make_float2(ti.x + im.x, ti.y + im.y);
        }
        *reinterpret_cast<float2*>(accr + off) = re;
        *reinterpret_cast<float2*>(acci + off) = im;
      }
    }
  };
  // One batch: its wgmmas, the next batch staged while they run, the
  // wait; returns whether the run has a next batch.
  int buf = 0;
  auto band_step = [&]() {
    const float* S = stage + buf * T::kStage;
    const int c_now = c;
    m0 += kKB;
    const bool next = settle();
    band_issue<B>(acc_r, acc_i, S, threadIdx.x / 128);
    if (next) stage_at(stage + (buf ^ 1) * T::kStage, c != c_now);
    wgmma_wait_all();
    fence_operands(acc_r);
    fence_operands(acc_i);
    __syncthreads();
    buf ^= 1;
    return next;
  };
  bool have = settle();
  if (have) stage_at(stage, true);
  __syncthreads();
  if constexpr (!kPromoteSums) {
    while (have) have = band_step();
  } else {
    // Stretches of at most kPromote batches, each promoted into the
    // plane before the next: the promotion stays out of the batch loop.
    while (have) {
      for (int b = 0; have && b < kPromote; ++b) have = band_step();
      if (have) {
        flush();
        promoted = true;
#pragma unroll
        for (int i = 0; i < T::kAcc; ++i) {
          acc_r[i] = 0.f;
          acc_i[i] = 0.f;
        }
      }
    }
  }

  flush();
}

// The batches of the anchor run that starts at chunk c0 (ceil(count /
// kKB) summed over its chunks, as the band loop takes them), or a number
// past kPromote once the count is past it.  Each warp counts on its own,
// 32 chunks at a time, so every thread of the CTA gets the same number
// with no barrier; most runs end within the first 32 chunks.
__device__ __forceinline__ int run_batches(const int* __restrict__ slot,
                                           int n,
                                           const int* __restrict__ count,
                                           int c0) {
  const int lane = threadIdx.x % 32;
  const int s = slot[c0];
  int batches = 0;
  for (int base = c0; base < n && batches <= kPromote; base += 32) {
    const int d = base + lane;
    // Both loads issue before either is used: one memory latency a step.
    const int sd = d < n ? slot[d] : -1;
    const int cd = d < n ? count[d] : 0;
    const unsigned in = __ballot_sync(~0u, sd == s);
    const int len = in == ~0u ? 32 : __ffs(~in) - 1;  // the run's chunks here
    int b = lane < len ? (cd + kKB - 1) / kKB : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) b += __shfl_xor_sync(~0u, b, o);
    batches += b;
    if (len < 32) break;
  }
  return batches;
}

// One CTA per chunk c0 (grid x), polarization (y) and block of the
// window (z); the CTA whose chunk starts a run grids it.  A wide window
// promotes its sums.  At ts 32 and 64 (kWide false) the run's length in
// batches picks one of two bodies once per CTA: a short run takes the
// code with neither bounds tests nor promotion, a long run the promoting
// one.  The kernel takes the larger body's registers (222 at ts 64, where
// the short body alone took 202; one CTA an SM either way).
template <int B, bool kWide>
__global__ void __launch_bounds__(BandTile<B>::kThreads, 1)
grid_planes_kernel(const int* __restrict__ slot, int n,
                   const int* __restrict__ count,
                   const int* __restrict__ iu, const int* __restrict__ iv,
                   const int* __restrict__ su, const int* __restrict__ sv,
                   const float* __restrict__ sre,
                   const float* __restrict__ sim,
                   const float2* __restrict__ tab,
                   const float4* __restrict__ tabs,
                   float* __restrict__ accr, float* __restrict__ acci,
                   int Mc, int P, int K, int ts2, int nb, int nt2) {
  const int c0 = blockIdx.x;
  if (c0 >= n) return;
  if (c0 > 0 && slot[c0 - 1] == slot[c0]) return;  // not a run's first chunk
  extern __shared__ __align__(128) float stage[];  // [2][kStage]
  __shared__ ChunkSlots cs;                    // the current chunk's slots
  if (kWide)
    grid_run<B, true, true>(c0, blockIdx.y, (blockIdx.z / nb) * B,
                            (blockIdx.z % nb) * B, stage, cs, slot, n, count,
                            iu, iv, su, sv, sre, sim, tab, tabs, accr, acci,
                            Mc, P, K, ts2, nt2);
  else if (run_batches(slot, n, count, c0) <= kPromote)
    grid_run<B, false, false>(c0, blockIdx.y, 0, 0, stage, cs, slot, n,
                              count, iu, iv, su, sv, sre, sim, tab, tabs,
                              accr, acci, Mc, P, K, B, nt2);
  else
    grid_run<B, false, true>(c0, blockIdx.y, 0, 0, stage, cs, slot, n, count,
                             iu, iv, su, sv, sre, sim, tab, tabs, accr, acci,
                             Mc, P, K, B, nt2);
}

template <int B, bool kWide>
cudaError_t launch_grid_planes(const int* slot, int n, const int* count,
                               const int* iu, const int* iv, const int* su,
                               const int* sv, const float* sre,
                               const float* sim, const float2* tab,
                               const float4* tabs, float* accr, float* acci,
                               int NC, int Mc, int P, int K, int ts2, int nb,
                               int nt2, cudaStream_t stream) {
  using T = BandTile<B>;
  cudaError_t err = cudaFuncSetAttribute(
      grid_planes_kernel<B, kWide>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return err;
  grid_planes_kernel<B, kWide><<<dim3(NC, P, nb * nb), T::kThreads,
                                 T::kSmemBytes, stream>>>(
      slot, n, count, iu, iv, su, sv, sre, sim, tab, tabs, accr, acci, Mc, P,
      K, ts2, nb, nt2);
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
// window (2ts, padded to Wp = 64 ceil(2ts / 64)) in blocks of 128 where
// Wp is a multiple of 128, else of 64.
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
  if (ts2 == 128)
    return launch_grid_planes<128, false>(s, n, cn, u, v, du, dv, r, i, t,
                                          ts4, ar, ai, NC, Mc, P, K, ts2, 1,
                                          nt2, st);
  if (ts2 == 64)
    return launch_grid_planes<64, false>(s, n, cn, u, v, du, dv, r, i, t,
                                         ts4, ar, ai, NC, Mc, P, K, ts2, 1,
                                         nt2, st);
  if (wp % 128 == 0)
    return launch_grid_planes<128, true>(s, n, cn, u, v, du, dv, r, i, t,
                                         ts4, ar, ai, NC, Mc, P, K, ts2,
                                         wp / 128, nt2, st);
  return launch_grid_planes<64, true>(s, n, cn, u, v, du, dv, r, i, t, ts4,
                                      ar, ai, NC, Mc, P, K, ts2, wp / 64, nt2,
                                      st);
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
