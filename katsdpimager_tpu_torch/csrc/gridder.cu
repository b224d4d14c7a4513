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

namespace {

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
// Design: one CTA per anchor run (grid NC x P); a CTA whose chunk is not
// the first of its run exits at once.  The CTA loops over its run's
// chunks, and in each over the valid slots only, kKB = 8 visibilities at a
// time (the MMA depth): padding costs nothing.  The band is a complex
// matrix product A^T B over the staged visibilities, A[m, j] = conj(K_v)
// sample and B[m, k] = conj(K_u), computed on the tensor cores with
// wgmma.mma_async m64nNk8 TF32 (N = 2ts) as four real products in the
// 3xTF32 scheme: each staged operand is split once into hi = tf32_rna(x)
// and lo = tf32_rna(x - hi), and every product sums lo*hi + hi*lo + hi*hi
// in FP32 accumulators (the lo*lo term, below 2^-22 of the product, is
// dropped), so the band keeps FP32 accuracy; plain TF32 would not.  One
// warpgroup per 64 window rows keeps its rows of the band in accumulator
// registers across the run; A and B come from shared memory through
// descriptors, -Bi by the instruction's B scale of -1.  Each chunk's slot
// data is loaded into shared memory once; while batch b's wgmmas run, the
// same threads write batch b + 1's split operands (double buffered), one
// barrier per batch.  The JAX kernel's one-hot selection and lane shift
// become an indexed table load with a bounds test.  The run is written
// once with plain stores: no atomics, so the result does not depend on
// scheduling.
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

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// wgmma.mma_async m64nNk8, TF32 inputs, FP32 accumulation, d += a b
// (kScaleB = 1) or d -= a b (kScaleB = -1); A and B through shared-memory
// matrix descriptors.
template <int kScaleB>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "n"(1), "n"(kScaleB));
}

template <int kScaleB>
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "n"(1), "n"(kScaleB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma window.
template <int ND>
__device__ __forceinline__ void fence_operands(float (&d)[ND]) {
#pragma unroll
  for (int i = 0; i < ND; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Makes this thread's shared-memory writes visible to the tensor cores'
// (async proxy) reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a K-major operand without swizzle: core matrices of 8
// rows x 16 bytes stored contiguously, LBO bytes apart along K and SBO
// bytes apart along M or N.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// The window of one anchor run, TS2 x TS2 complex, over TS2 / 64
// warpgroups of 64 rows.  A staged batch holds kKB visibilities in eight
// planes, A (re hi, re lo, im hi, im lo) then B (likewise), each in the
// K-major core-matrix layout of smem_desc: row r (j for A, k for B), slot
// m at float ((r / 8) (kKB / 4) + m / 4) 32 + (r % 8) 4 + m % 4.
template <int TS2>
struct BandTile {
  static constexpr int kThreads = 2 * TS2;    // one warpgroup per 64 rows
  static constexpr int kPlane = kKB * TS2;    // floats
  static constexpr int kStage = 8 * kPlane;
  static constexpr int kSmemBytes =
      2 * kStage * static_cast<int>(sizeof(float));
  static constexpr int kAcc = TS2 / 2;        // accumulators a thread, each
  static constexpr int kSteps = kKB / 8;      // wgmma k-steps a batch
};

// One chunk's slot data, loaded once per chunk into shared memory.
struct __align__(16) ChunkSlots {
  int iv[kMaxMc], sv[kMaxMc], iu[kMaxMc], su[kMaxMc];
  float sr[kMaxMc], si[kMaxMc];
};

template <int TS2>
__device__ __forceinline__ void load_chunk(
    ChunkSlots& cs, int c, int cnt, int p, const int* __restrict__ iu,
    const int* __restrict__ iv, const int* __restrict__ su,
    const int* __restrict__ sv, const float* __restrict__ sre,
    const float* __restrict__ sim, int Mc, int P) {
  const size_t cm = static_cast<size_t>(c) * Mc;
  const size_t cp = (static_cast<size_t>(c) * P + p) * Mc;
  for (int m = threadIdx.x; m < cnt; m += BandTile<TS2>::kThreads) {
    cs.iv[m] = iv[cm + m];
    cs.sv[m] = sv[cm + m];
    cs.iu[m] = iu[cm + m];
    cs.su[m] = su[cm + m];
    cs.sr[m] = sre[cp + m];
    cs.si[m] = sim[cp + m];
  }
}

// Visibilities m0 .. m0 + kKB - 1 of the chunk in `cs` (slots at or past
// cnt give zeros) as split planes.
// A thread takes one window position j and 4 consecutive slots, whose
// slot data it reads as vectors and whose 4 values per plane are
// contiguous in the core-matrix layout: one 16-byte store per plane,
// free of bank conflicts.  A's products are split here; B's split comes
// ready from `tabs`.  Ends with the async-proxy fence.
template <int TS2>
__device__ __forceinline__ void stage_batch(float* S, const ChunkSlots& cs,
                                            int m0, int cnt,
                                            const float2* __restrict__ tab,
                                            const float4* __restrict__ tabs,
                                            int K) {
  using T = BandTile<TS2>;
#pragma unroll
  for (int grp = threadIdx.x; grp < (kKB / 4) * TS2; grp += T::kThreads) {
    const int j = grp % TS2;
    const int k4 = grp / TS2;
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
      const int dv = j - svs[u];
      if (live && dv >= 0 && dv < K) {
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
      const int du = j - sus[u];
      if (live && du >= 0 && du < K) b = tabs[ius[u] * K + du];
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
template <int TS2>
__device__ __forceinline__ void band_issue(
    float (&acc_r)[BandTile<TS2>::kAcc], float (&acc_i)[BandTile<TS2>::kAcc],
    const float* S, int wg) {
  using T = BandTile<TS2>;
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

template <int TS2>
__global__ void __launch_bounds__(BandTile<TS2>::kThreads, 1)
grid_planes_kernel(const int* __restrict__ slot, int n,
                   const int* __restrict__ count,
                   const int* __restrict__ iu, const int* __restrict__ iv,
                   const int* __restrict__ su, const int* __restrict__ sv,
                   const float* __restrict__ sre,
                   const float* __restrict__ sim,
                   const float2* __restrict__ tab,
                   const float4* __restrict__ tabs,
                   float* __restrict__ accr, float* __restrict__ acci,
                   int Mc, int P, int K, int nt2) {
  using T = BandTile<TS2>;
  const int c0 = blockIdx.x;
  const int p = blockIdx.y;
  if (c0 >= n) return;
  const int s = slot[c0];
  if (c0 > 0 && slot[c0 - 1] == s) return;  // not the first chunk of its run

  extern __shared__ __align__(128) float stage[];  // [2][kStage]
  __shared__ ChunkSlots cs;                    // the current chunk's slots

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
      load_chunk<TS2>(cs, c, cnt, p, iu, iv, su, sv, sre, sim, Mc, P);
      __syncthreads();
    }
    stage_batch<TS2>(S, cs, m0, cnt, tab, tabs, K);
  };
  bool have = settle();
  int buf = 0;
  if (have) stage_at(stage, true);
  __syncthreads();
  while (have) {
    const float* S = stage + buf * T::kStage;
    const int c_now = c;
    m0 += kKB;
    const bool next = settle();
    band_issue<TS2>(acc_r, acc_i, S, threadIdx.x / 128);
    if (next) stage_at(stage + (buf ^ 1) * T::kStage, c != c_now);
    wgmma_wait_all();
    fence_operands(acc_r);
    fence_operands(acc_i);
    __syncthreads();
    buf ^= 1;
    have = next;
  }

  // Decode the slot: colour (a, b) = tile parities, then the tile of the
  // colour plane; the planes are (2, 2, P, ext2, ext2) images.
  const int colour = s / (nt2 * nt2);
  const int rem = s - colour * (nt2 * nt2);
  const int tv2 = rem / nt2;
  const int tu2 = rem - tv2 * nt2;
  const size_t ext2 = static_cast<size_t>(nt2) * TS2;
  const size_t base =
      ((static_cast<size_t>(colour) * P + p) * ext2 +
       static_cast<size_t>(tv2) * TS2) * ext2 +
      static_cast<size_t>(tu2) * TS2;
  // Accumulator i of n8 block nb: row g (+ 8 for i & 2), column 8 nb + 2 t
  // (+ 1 for i & 1).
#pragma unroll
  for (int nb = 0; nb < TS2 / 8; ++nb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t off = base + (r0 + g + 8 * h) * ext2 + 8 * nb + 2 * t;
      *reinterpret_cast<float2*>(accr + off) =
          make_float2(acc_r[4 * nb + 2 * h], acc_r[4 * nb + 2 * h + 1]);
      *reinterpret_cast<float2*>(acci + off) =
          make_float2(acc_i[4 * nb + 2 * h], acc_i[4 * nb + 2 * h + 1]);
    }
  }
}

template <int TS2>
cudaError_t launch_grid_planes(const int* slot, int n, const int* count,
                               const int* iu, const int* iv, const int* su,
                               const int* sv, const float* sre,
                               const float* sim, const float2* tab,
                               const float4* tabs, float* accr, float* acci,
                               int NC, int Mc, int P, int K, int nt2,
                               cudaStream_t stream) {
  using T = BandTile<TS2>;
  cudaError_t err = cudaFuncSetAttribute(
      grid_planes_kernel<TS2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmemBytes);
  if (err != cudaSuccess) return err;
  grid_planes_kernel<TS2><<<dim3(NC, P), T::kThreads, T::kSmemBytes,
                            stream>>>(slot, n, count, iu, iv, su, sv, sre,
                                      sim, tab, tabs, accr, acci, Mc, P, K,
                                      nt2);
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

extern "C" int ktt_grid_planes(const void* slot, int n, const void* count,
                               const void* iu, const void* iv,
                               const void* su, const void* sv,
                               const void* sre, const void* sim,
                               const void* tab, const void* tabs, void* accr,
                               void* acci, int NC, int Mc, int P, int K,
                               int ts, int nt2, void* stream) {
  if (n <= 0 || NC <= 0 || P <= 0 || Mc <= 0 || Mc > kMaxMc)
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
  switch (ts) {
    case 64:
      return launch_grid_planes<128>(s, n, cn, u, v, du, dv, r, i, t, ts4, ar,
                                     ai, NC, Mc, P, K, nt2, st);
    case 32:
      return launch_grid_planes<64>(s, n, cn, u, v, du, dv, r, i, t, ts4, ar,
                                    ai, NC, Mc, P, K, nt2, st);
    default:
      return cudaErrorInvalidValue;
  }
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
