// Numerics probes P1 (A, B, C) and P2 (E, F) on Hopper (sm_90a): does a
// product on this card's tensor cores keep f32 exact?  Plain C interface,
// loaded with ctypes by katsdpimager_tpu_torch/ops/_build.py; the Python
// wrappers, the plain PyTorch versions and the probe data are in
// katsdpimager_tpu_torch/probes.py.
//
// Replaces the inline Pallas probes of scripts/mosaic_num_probe.py (A at
// :64, B at :86, C at :124) and scripts/mosaic_num_probe2.py (E at :90, F
// at :112).  There each probe asked what the TPU's matrix unit does to f32
// data: A and F one-hot select from a table split three ways into bf16,
// B one-hot selects at Precision.HIGHEST (the matrix unit's f32-faithful
// multi-pass mode), C is the stacked 2 x 2 band dot [a, b]^T [c, d] at
// HIGHEST against four separate dots.  Here each asks the same of the
// route a kernel of the port takes on the tensor cores:
//
// - A / F (select_bf16_kernel): the one-hot selection through bf16
//   wgmma.mma_async m64n64k16 with f32 accumulation.  The (W, 3L) table
//   [hi | mid | lo] is staged once per CTA by TMA, 128-byte swizzled, in
//   the MN-major layout the B descriptor reads (no pass through
//   registers); the one-hot A operand is built in registers from idx.  A
//   recombines (hi + mid) + lo in registers, F stores the three thirds.
//   Exact: each output sums one bf16 value and zeros.
// - B (band_dot_kernel<kOneHot3>): the f32 one-hot selection on the TF32
//   tensor cores in f32-faithful form, the card's counterpart of HIGHEST:
//   the table split into three TF32 pieces (hi, mid, lo, each by
//   cvt.rna), one-hot . hi + one-hot . mid + one-hot . lo.  Three 11-bit
//   pieces cover f32's 24 bits, so every value rebuilds exactly; K1's two
//   pieces leave up to 2^-22 of it.
// - C (band_dot_kernel<kSplit2>): x^T y by 3xTF32 wgmma m64n64k8 from
//   shared memory, with K1's split, instruction and accumulation
//   (wgmma.cuh): lo hi + hi lo + hi hi with hi = tf32_rna(v), lo =
//   tf32_rna(v - hi) into one FP32 accumulator (wgmma_tf32x3) that sums
//   kPromoteSteps k-steps of 8 and is then promoted by IEEE adds into a
//   segment's total, that into the tile's every kSegment stretches
//   (promote), as K1 does each batch.  The stacked form reads [a, b] and
//   [c, d]; the separate form is the same launch reading a, b, c and d,
//   each tile lying in one 128 x 128 block of the output, as the TPU's
//   kern_sep writes the four blocks of one output.  The tensor cores'
//   accumulation truncates and its error grows with the adds it takes:
//   K1's schedule before (one accumulator promoted every 32 k-steps:
//   none at this contraction of 256, so 96 adds) gave 1.9e-6 here, above
//   the probe's 1e-6 (PERF.md).
// - C_tf32 (band_dot_kernel<kSplit1>): the same dot in one TF32 pass, no
//   split: TF32 keeps 10 mantissa bits, about 3e-4 relative here.  This is
//   the trap that the port's rule "no f32 dot in TF32" guards against.
// - E (recombine_kernel): (hi + mid) + lo with no dot, 16-byte loads and
//   stores, one pass.  Exact.
//
// What bounds them: launch latency.  At the probes' size (M = W = 256,
// L = 128) the bound of each kernel's bytes or operations is 0.08-0.24 us,
// below one launch (E, a single pass, takes 1.3 us on an H100).  So each
// kernel is one launch that reads its inputs from device memory once, by
// TMA into shared memory where the tensor cores read them (A, B, C, F).
// A and F take one CTA (one warpgroup) per 64 x 64 tile of the output.
// B and C, whose staging splits every operand into TF32 pieces chunk by
// chunk, take a cluster of four CTAs per tile, each a quarter of the
// contraction, summed through distributed shared memory: 32 and 64 CTAs,
// and two chunks each where one CTA for the whole contraction looped over
// eight.  The partial sums go by remote stores and one cluster barrier.
// On an H100 SXM at 700 W: 4.4 and 4.7 us, against 7.4 and 7.6 for one
// CTA a tile and 5.4 and 5.6 for remote reads between two barriers
// (PERF.md).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "wgmma.cuh"

namespace {

using namespace hopper;
namespace cg = cooperative_groups;

constexpr uint16_t kBf16One = 0x3F80;

// ---------------------------------------------------------------------------
// Shared memory, TMA and mbarriers

// The first address at or past p that is a multiple of `align` bytes in
// the shared window.
template <int kAlign>
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

// This thread's arrival, announcing `bytes` of TMA transfers to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// A 2-D box of `map` at (c0 columns, c1 rows) into shared memory at dst,
// its bytes reported to `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// Cluster barriers and the bf16 wgmma (the TF32 one and the fences are in
// wgmma.cuh)

// The two halves of a cluster barrier: this thread's arrival (relaxed: it
// orders no memory) and the wait for every thread of the cluster's.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// d (+)= a b, m64n64k16, bf16 inputs: A from registers (K-major), B from
// a shared-memory descriptor of an MN-major operand (imm-trans-b = 1),
// FP32 accumulation.
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// The kPieces TF32 pieces of x: piece i = tf32_rna(x - pieces before it).
template <int kPieces>
__device__ __forceinline__ void split_tf32(float x, float (&p)[kPieces]) {
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    p[i] = __uint_as_float(tf32_rna(x));
    x -= p[i];
  }
}

constexpr int kTile = 64;  // output rows and columns of a CTA (one wgmma)
constexpr int kThreads = 128;  // one warpgroup

// Calls store(row, col, i) for each pair of this thread's m64n64 f32
// accumulators: accumulators i and i + 1 (i even; column block nb8 = i / 4)
// are tile row 16 warp + g (+ 8 for i & 2), tile columns 8 nb8 + 2 t and
// the next.
template <typename F>
__device__ __forceinline__ void for_each_pair(F&& store) {
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
#pragma unroll
  for (int nb8 = 0; nb8 < kTile / 8; ++nb8)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store(r0 + 8 * h, c0 + 8 * nb8, 4 * nb8 + 2 * h);
}

// ---------------------------------------------------------------------------
// B and C: TF32 products on the tensor cores, A and B from shared memory.
//
// out (I, J) = x^T y over a contraction of Mk <= 256: x is up to two
// (Mk, xb) blocks side by side in its columns, y up to two (Mk, yb) (the
// separate form; the stacked form is one block each).  In the one-hot
// route x is the one-hot matrix of idx (x[k, i] = idx[i] == k) and y the
// table.  Each 64 x 64 tile of out is one cluster of kSplitK CTAs, each
// CTA a quarter of the contraction (at most kRankChunks chunks of kKC):
// its rows of the tile's (Mk, 64) slices of x and y arrive by TMA, a chunk
// to a barrier; chunk by chunk the CTA splits them into TF32 planes in
// the K-major core-matrix layout of the wgmma descriptors (double
// buffered: chunk c + 1 is staged while chunk c's wgmmas run) and after
// each chunk adds the chunk's accumulators into f32 totals.  Then each
// CTA of the cluster sums a quarter of the tile's rows over the cluster's
// totals, in rank order, and stores it: the totals come to it by remote
// stores into its shared memory.  (One CTA over the whole contraction
// took 7.4-7.7 us on an H100, its chunk loop latency-bound; PERF.md.)

constexpr int kKC = 32;                 // contraction per staged chunk
constexpr int kPlane = kTile * kKC;     // floats of one split plane
constexpr int kMaxK = 256;              // contraction a tile takes
constexpr int kSplitK = 4;              // CTAs of a tile's cluster
constexpr int kRankChunks = kMaxK / kKC / kSplitK;  // chunks a CTA at most
constexpr int kRows = kTile / kSplitK;  // rows of the tile a CTA sums
constexpr int kRedStride = kTile + 8;   // floats a row of partial totals

enum Route { kSplit2 = 0, kSplit1 = 1, kOneHot3 = 2 };

// Pieces of the A (x) and B (y) operands and the products summed: term t
// multiplies A piece a(t) by B piece b(t).
template <int kRoute>
struct DotRoute;

template <>
struct DotRoute<kSplit2> {  // 3xTF32 (hi, lo): wgmma_tf32x3's terms
  static constexpr int kPa = 2, kPb = 2;
};

template <>
struct DotRoute<kSplit1> {  // one TF32 pass
  static constexpr int kPa = 1, kPb = 1, kTerms = 1;
  __host__ __device__ static constexpr int a(int) { return 0; }
  __host__ __device__ static constexpr int b(int) { return 0; }
};

template <>
struct DotRoute<kOneHot3> {  // one-hot . hi + one-hot . mid + one-hot . lo
  static constexpr int kPa = 1, kPb = 3, kTerms = 3;
  __host__ __device__ static constexpr int a(int) { return 0; }
  __host__ __device__ static constexpr int b(int t) { return t; }
};

struct DotMaps {
  CUtensorMap x[2], y[2];
};

// Shared memory of a CTA: its raw rows of x (but in the one-hot route)
// and y, two staged chunks, and the cluster's partial totals of its rows.
template <int kRoute>
__host__ __device__ constexpr size_t dot_smem_bytes() {
  using R = DotRoute<kRoute>;
  return ((kRoute == kOneHot3 ? 1 : 2) * kRankChunks * kKC * kTile +
          2 * (R::kPa + R::kPb) * kPlane + kSplitK * kRows * kRedStride) *
             sizeof(float) +
         128;
}

template <int kRoute>
__global__ void __launch_bounds__(kThreads)
    band_dot_kernel(const __grid_constant__ DotMaps maps,
                    const int* __restrict__ idx, float* __restrict__ out,
                    int Mk, int xb, int yb, int J) {
  using R = DotRoute<kRoute>;
  constexpr bool kOneHot = kRoute == kOneHot3;
  constexpr int kStage = (R::kPa + R::kPb) * kPlane;
  constexpr int kRaw = kRankChunks * kKC * kTile;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kRankChunks];
  float* raw_x = reinterpret_cast<float*>(align_smem<128>(smem_raw));
  float* raw_y = raw_x + (kOneHot ? 0 : kRaw);
  float* stage = raw_y + kRaw;
  float* red = stage + 2 * kStage;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // waited for before the first remote store

  const int tid = threadIdx.x;
  const int rank = blockIdx.x;  // the cluster spans the grid's x
  const int j0 = blockIdx.y * kTile;
  const int i0 = blockIdx.z * kTile;
  const int xq = i0 / xb;
  const int yq = j0 / yb;
  const int all = Mk / kKC;
  const int first = rank * all / kSplitK;  // this CTA's first chunk
  const int chunks = (rank + 1) * all / kSplitK - first;
  if (tid == 0)
    for (int c = 0; c < chunks; ++c) mbar_init(&bars[c], 1);
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < chunks; ++c) {
      const int row = (first + c) * kKC;
      mbar_expect_tx(&bars[c], (kOneHot ? 1 : 2) * kKC * kTile * 4);
      if (!kOneHot)
        tma_load_2d(raw_x + c * kPlane, &maps.x[xq], i0 - xq * xb, row,
                    &bars[c]);
      tma_load_2d(raw_y + c * kPlane, &maps.y[yq], j0 - yq * yb, row,
                  &bars[c]);
    }
  }
  // A thread stages one tile row or column j (its x and y column) and 4
  // consecutive k at a time: a warp reads 32 consecutive floats of a raw
  // row, and each plane gets one 16-byte store, free of bank conflicts.
  const int j = tid % kTile;
  const int hot = kOneHot ? idx[i0 + j] : 0;

  auto stage_chunk = [&](float* S, int c) {
    mbar_wait(&bars[c], 0);
    const float* rx = raw_x + c * kPlane;
    const float* ry = raw_y + c * kPlane;
#pragma unroll
    for (int r = 0; r < kTile * kKC / 4 / kThreads; ++r) {
      const int k4 = tid / kTile + r * (kThreads / kTile);
      float a[R::kPa][4], b[R::kPb][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = 4 * k4 + u;
        float pa[R::kPa], pb[R::kPb];
        if constexpr (kOneHot)
          pa[0] = hot == (first + c) * kKC + k ? 1.f : 0.f;
        else
          split_tf32<R::kPa>(rx[k * kTile + j], pa);
        split_tf32<R::kPb>(ry[k * kTile + j], pb);
#pragma unroll
        for (int q = 0; q < R::kPa; ++q) a[q][u] = pa[q];
#pragma unroll
        for (int q = 0; q < R::kPb; ++q) b[q][u] = pb[q];
      }
      const int off = ((j >> 3) * (kKC / 4) + k4) * 32 + (j & 7) * 4;
#pragma unroll
      for (int q = 0; q < R::kPa; ++q)
        *reinterpret_cast<float4*>(S + q * kPlane + off) =
            make_float4(a[q][0], a[q][1], a[q][2], a[q][3]);
#pragma unroll
      for (int q = 0; q < R::kPb; ++q)
        *reinterpret_cast<float4*>(S + (R::kPa + q) * kPlane + off) =
            make_float4(b[q][0], b[q][1], b[q][2], b[q][3]);
    }
    fence_proxy_async();
  };

  // Descriptors of every plane at k-step ks of the staged chunk S (8 k:
  // 2 core matrices along K).  LBO: the next 4 k; SBO: the next 8 rows.
  auto descs = [&](const float* S, int ks, uint64_t (&da)[R::kPa],
                   uint64_t (&db)[R::kPb]) {
#pragma unroll
    for (int q = 0; q < R::kPa; ++q)
      da[q] = smem_desc(S + q * kPlane + ks * 64, 128, 128 * (kKC / 4));
#pragma unroll
    for (int q = 0; q < R::kPb; ++q)
      db[q] = smem_desc(S + (R::kPa + q) * kPlane + ks * 64, 128,
                        128 * (kKC / 4));
  };
  constexpr int kAcc = kRoute == kSplit2 ? 1 : 3;
  static_assert((kKC / 8) % kPromoteSteps == 0, "whole stretches a chunk");
  float acc[kAcc][32], total[32], seg[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int q = 0; q < kAcc; ++q) acc[q][i] = 0.f;
    total[i] = 0.f;
    seg[i] = 0.f;
  }
  int stretches = 0;
  if (chunks > 0) stage_chunk(stage, 0);
  __syncthreads();
  for (int c = 0; c < chunks; ++c) {
    const float* S = stage + (c & 1) * kStage;
    if constexpr (kRoute == kSplit2) {
      // K1's schedule (wgmma.cuh): the three products into one
      // accumulator, kPromoteSteps k-steps a stretch, each stretch
      // promoted into the segment's total `seg` and that into `total`
      // every kSegment stretches; the next chunk stages under the first.
      for (int h = 0; h < kKC / 8 / kPromoteSteps; ++h) {
        fence_operands(acc[0]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kPromoteSteps; ++k) {
          uint64_t da[R::kPa], db[R::kPb];
          descs(S, h * kPromoteSteps + k, da, db);
          wgmma_tf32x3(acc[0], da[0], da[1], db[0], db[1], k > 0);
        }
        wgmma_commit();
        if (h == 0 && c + 1 < chunks)
          stage_chunk(stage + ((c + 1) & 1) * kStage, c + 1);
        wgmma_wait_all();
        fence_operands(acc[0]);
        promote(seg, acc[0]);
        if (++stretches == kSegment) {
          promote<true>(total, seg);
          stretches = 0;
        }
      }
    } else {
      // B and C_tf32: the chunk's wgmmas go round kAcc accumulators (term
      // t at k-step ks into (kTerms ks + t) % kAcc, zeroed by its first
      // wgmma of the chunk); the chunk's sums are then promoted into
      // `total` as (acc0 + acc1) + acc2 (B: (hi + mid) + lo, exact).
#pragma unroll
      for (int q = 0; q < kAcc; ++q) fence_operands(acc[q]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKC / 8; ++ks) {
        uint64_t da[R::kPa], db[R::kPb];
        descs(S, ks, da, db);
#pragma unroll
        for (int t = 0; t < R::kTerms; ++t) {
          const int w = ks * R::kTerms + t;
          wgmma_tf32(acc[w % kAcc], da[R::a(t)], db[R::b(t)], w >= kAcc);
        }
      }
      wgmma_commit();
      if (c + 1 < chunks) stage_chunk(stage + ((c + 1) & 1) * kStage, c + 1);
      wgmma_wait_all();
#pragma unroll
      for (int q = 0; q < kAcc; ++q) fence_operands(acc[q]);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        total[i] += (acc[0][i] + acc[1][i]) + acc[2][i];
    }
    __syncthreads();
  }

  if constexpr (kRoute == kSplit2) promote(total, seg);

  // Warp w's rows are the tile's rows 16 w .. 16 w + 15, which CTA w of
  // the cluster sums: each warp stores its totals into that CTA's `red`,
  // at this CTA's slot (remote stores, once every CTA of the cluster has
  // started); after one cluster barrier each CTA sums its rows' slots in
  // rank order and stores them, coalesced.
  static_assert(kSplitK == kThreads / 32 && kRows == 16, "a warp a CTA");
  cluster_wait();
  float* mine =
      cluster.map_shared_rank(red, tid / 32) + rank * kRows * kRedStride;
  for_each_pair([&](int row, int col, int i) {
    *reinterpret_cast<float2*>(mine + (row % kRows) * kRedStride + col) =
        make_float2(total[i], total[i + 1]);
  });
  cluster.sync();
#pragma unroll
  for (int u = 0; u < kRows * kTile / kThreads; ++u) {
    const int e = tid + u * kThreads;
    const int row = e / kTile;
    const int col = e % kTile;
    float v = red[row * kRedStride + col];
#pragma unroll
    for (int r = 1; r < kSplitK; ++r)
      v += red[(r * kRows + row) * kRedStride + col];
    out[static_cast<size_t>(i0 + rank * kRows + row) * J + j0 + col] = v;
  }
}

// ---------------------------------------------------------------------------
// A (kRecombine) and F: sel = onehot(idx) @ [hi | mid | lo] in bf16.
//
// One CTA per 64 output rows and 64 columns of each third: the three
// (W, 64) column slices of the table arrive by TMA, each row 128 bytes,
// 128-byte swizzled (the layout of an MN-major wgmma operand with a
// 128-byte swizzle: 8-row atoms of 1024 bytes), so the tensor cores read
// them as they land.  The one-hot A fragment (rows 16 warp + g and + 8,
// k 2 t, 2 t + 1, 2 t + 8, 2 t + 9 of each k-step) is built in registers.

constexpr int kBf16Row = 128;  // bytes of a staged table row (64 bf16)
constexpr int kMaxSelectSteps = 256 / 16;  // k-steps of the largest W

__host__ __device__ constexpr size_t select_smem_bytes(int W) {
  return 3 * static_cast<size_t>(W) * kBf16Row + 1024;
}

__device__ __forceinline__ uint32_t hot2(int i, int k) {
  return static_cast<uint32_t>(i == k ? kBf16One : 0) |
         (static_cast<uint32_t>(i == k + 1 ? kBf16One : 0) << 16);
}

template <bool kRecombine>
__global__ void __launch_bounds__(kThreads)
    select_bf16_kernel(const __grid_constant__ CUtensorMap tab_map,
                       const int* __restrict__ idx, float* __restrict__ out,
                       int W, int L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  unsigned char* tab = align_smem<1024>(smem_raw);
  const int third = W * kBf16Row;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kTile;
  const int m0 = blockIdx.y * kTile;
  if (tid == 0) mbar_init(&bar, 1);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar, 3 * third);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      tma_load_2d(tab + q * third, &tab_map, q * L + n0, 0, &bar);
  }
  const int lane = tid % 32;
  const int r0 = m0 + (tid / 32) * 16 + lane / 4;
  const int i0 = idx[r0];
  const int i1 = idx[r0 + 8];
  // Every k-step's A fragment is built before the first wgmma: a register
  // that an issued wgmma still reads is not written until the wait.
  const int t2 = 2 * (lane % 4);
  uint32_t a[kMaxSelectSteps][4];
#pragma unroll
  for (int ks = 0; ks < kMaxSelectSteps; ++ks) {
    const int k = 16 * ks + t2;
    a[ks][0] = hot2(i0, k);
    a[ks][1] = hot2(i1, k);
    a[ks][2] = hot2(i0, k + 8);
    a[ks][3] = hot2(i1, k + 8);
  }
  float acc[3][32];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
  mbar_wait(&bar, 0);

  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kMaxSelectSteps; ++ks) {
    if (ks >= W / 16) break;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      // k-step ks: 16 rows, two 8-row atoms (SBO apart); one atom wide.
      const uint64_t db =
          smem_desc(tab + q * third + ks * 16 * kBf16Row, 8 * kBf16Row,
                    8 * kBf16Row, 1);
      wgmma_bf16_rs(acc[q], a[ks], db, ks > 0);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int q = 0; q < 3; ++q) fence_operands(acc[q]);
  for_each_pair([&](int row, int col, int i) {
    const size_t r = static_cast<size_t>(m0 + row);
    if (kRecombine) {
      *reinterpret_cast<float2*>(out + r * L + n0 + col) =
          make_float2((acc[0][i] + acc[1][i]) + acc[2][i],
                      (acc[0][i + 1] + acc[1][i + 1]) + acc[2][i + 1]);
    } else {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        *reinterpret_cast<float2*>(out + r * 3 * L + q * L + n0 + col) =
            make_float2(acc[q][i], acc[q][i + 1]);
    }
  });
}

// ---------------------------------------------------------------------------
// E: out[w, l] = (hi + mid) + lo from the (W, 3L) bf16 table, no dot.  A
// thread takes 8 consecutive l: one 16-byte load from each third, two
// 16-byte stores.

__device__ __forceinline__ float bf16_half(uint32_t v, int upper) {
  return __uint_as_float(upper ? v & 0xFFFF0000u : v << 16);
}

__global__ void __launch_bounds__(kThreads)
    recombine_kernel(const uint4* __restrict__ tab, float4* __restrict__ out,
                     int W, int L) {
  const int per_row = L / 8;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= W * per_row) return;
  const int w = t / per_row;
  const int c = t - w * per_row;
  const uint4* row = tab + static_cast<size_t>(w) * 3 * per_row;
  const uint4 h = row[c];
  const uint4 m = row[per_row + c];
  const uint4 l = row[2 * per_row + c];
  const uint32_t hs[4] = {h.x, h.y, h.z, h.w};
  const uint32_t ms[4] = {m.x, m.y, m.z, m.w};
  const uint32_t ls[4] = {l.x, l.y, l.z, l.w};
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = (bf16_half(hs[e / 2], e & 1) + bf16_half(ms[e / 2], e & 1)) +
           bf16_half(ls[e / 2], e & 1);
  float4* o = out + static_cast<size_t>(w) * (L / 4) + 2 * c;
  o[0] = make_float4(v[0], v[1], v[2], v[3]);
  o[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// ---------------------------------------------------------------------------
// Host side: tensor maps through libcuda's cuTensorMapEncodeTiled, found
// at run time (the library links only the CUDA runtime).

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map of a row-major (rows, cols) matrix of `esize`-byte elements,
// boxes of (box_rows, box_cols).
int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
             int esize, int rows, int cols, int box_rows, int box_cols,
             CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

template <int kRoute>
int launch_band_dot(const DotMaps& maps, const int* idx, float* out, int Mk,
                    int I, int J, int xb, int yb, cudaStream_t stream) {
  const size_t smem = dot_smem_bytes<kRoute>();
  auto kernel = band_dot_kernel<kRoute>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplitK, J / kTile, I / kTile);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplitK;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps, idx, out, Mk, xb, yb, J);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool dot_shape_ok(int Mk, int n, int nb) {
  return Mk > 0 && Mk <= kMaxK && Mk % kKC == 0 && nb > 0 && nb % kTile == 0 &&
         n % nb == 0 && n / nb >= 1 && n / nb <= 2;
}

}  // namespace

// Probes A (recombine = 1) and F: (M,) int32 idx, (W, 3L) bf16 table ->
// (M, L) or (M, 3L) f32.  M % 64 == L % 64 == W % 16 == 0, W <= 256.
extern "C" int ktt_probe_select_bf16(const void* idx, const void* tab,
                                     void* out, int M, int W, int L,
                                     int recombine, void* stream) {
  if (M <= 0 || W <= 0 || L <= 0 || M % kTile || L % kTile || W % 16 ||
      W > 256)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  int err = make_map(&map, tab, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, W,
                     3 * L, W, kTile, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const size_t smem = select_smem_bytes(W);
  const dim3 grid(L / kTile, M / kTile);
  auto st = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int*>(idx);
  auto o = static_cast<float*>(out);
  if (recombine) {
    err = cudaFuncSetAttribute(select_bf16_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err) return err;
    select_bf16_kernel<true><<<grid, kThreads, smem, st>>>(map, i, o, W, L);
  } else {
    err = cudaFuncSetAttribute(select_bf16_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err) return err;
    select_bf16_kernel<false><<<grid, kThreads, smem, st>>>(map, i, o, W, L);
  }
  return cudaGetLastError();
}

// Probe B: (M,) int32 idx, (W, L) f32 table -> (M, L) f32 by the
// three-piece TF32 one-hot product.  M % 64 == L % 64 == W % 32 == 0,
// W <= 256.
extern "C" int ktt_probe_select_tf32x3(const void* idx, const void* table,
                                       void* out, int M, int W, int L,
                                       void* stream) {
  if (M <= 0 || M % kTile || !dot_shape_ok(W, L, L))
    return cudaErrorInvalidValue;
  DotMaps maps = {};
  int err = make_map(&maps.y[0], table, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                     W, L, kKC, kTile, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err) return err;
  maps.y[1] = maps.y[0];
  return launch_band_dot<kOneHot3>(maps, static_cast<const int*>(idx),
                                   static_cast<float*>(out), W, M, L, M, L,
                                   static_cast<cudaStream_t>(stream));
}

// Probe C: out (I, J) = x^T y, x (Mk, I) and y (Mk, J) f32, each given as
// one or two column blocks of xb (yb) columns, each block its own
// contiguous (Mk, xb) matrix (x0 = x1 and xb = I for one block); split =
// 1 for 3xTF32, 0 for one TF32 pass.  Mk % 32 == 0, Mk <= 256, xb % 64 ==
// yb % 64 == 0.
extern "C" int ktt_probe_band_dot(const void* x0, const void* x1,
                                  const void* y0, const void* y1, void* out,
                                  int Mk, int I, int J, int xb, int yb,
                                  int split, void* stream) {
  if (!dot_shape_ok(Mk, I, xb) || !dot_shape_ok(Mk, J, yb))
    return cudaErrorInvalidValue;
  DotMaps maps = {};
  const void* xs[2] = {x0, x1};
  const void* ys[2] = {y0, y1};
  for (int q = 0; q < 2; ++q) {
    int err = make_map(&maps.x[q], xs[q], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                       Mk, xb, kKC, kTile, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!err)
      err = make_map(&maps.y[q], ys[q], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                     Mk, yb, kKC, kTile, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
  }
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  return split ? launch_band_dot<kSplit2>(maps, nullptr, o, Mk, I, J, xb, yb,
                                          st)
               : launch_band_dot<kSplit1>(maps, nullptr, o, Mk, I, J, xb, yb,
                                          st);
}

// Probe E: (W, 3L) bf16 table -> (W, L) f32, (hi + mid) + lo.  L % 8 == 0.
extern "C" int ktt_probe_recombine(const void* tab, void* out, int W, int L,
                                   void* stream) {
  if (W <= 0 || L <= 0 || L % 8) return cudaErrorInvalidValue;
  const int threads = W * (L / 8);
  recombine_kernel<<<(threads + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(tab), static_cast<float4*>(out), W, L);
  return cudaGetLastError();
}
