// Column-DFT kernels for the grid <-> image transforms on Hopper (sm_90a):
// K3 (checkerboard + inverse column DFT, transposed store) and K4 (inverse
// column DFT + imaging corrections of one or several W slices, accumulated
// into the transposed dirty image) for grid -> image; K6 (image -> layer
// prologue + forward column DFT, transposed store) and K7 (forward column
// DFT + output checkerboard) for image -> grid; K8 (plain column DFT,
// natural orientation) for the 2-D transform building block; and K23, K2
// fused into K3 (K3 summing the four colour planes of the gridder as it
// loads), which the slice loop takes in place of K2 then K3.  Plain C
// interface, loaded with ctypes by katsdpimager_tpu_torch/ops/_build.py;
// the Python wrappers and plain PyTorch versions are in ops/fused_fft.py.
//
// Built WITHOUT -use_fast_math: the W-phase 2 pi w (n - 1) of K4 and K6
// reaches far beyond +-pi, where __sinf/__cosf lose all accuracy.
//
// All six run on the four-step column-FFT tile core of col_fft_tile.cuh
// (one launch, clusters of Q CTAs, radix-16/32 butterflies in registers),
// each with its own load and store hooks (K6 also with a per-value hook
// for its prologue).  What bounds them on this card is device memory: the
// core reads every input once and writes every output once, and the
// 5 N log2 N flops per column are about a percent of the FP32 rate.
//
// The TPU kernels' Bailey four-step with 64 x 64 DFT matrices suited the
// MXU but costs about 10x the flops of an FFT in FP32 at N = 4096, so it
// is not carried over.

#include <cuda_runtime.h>

#include <cstddef>

#include "col_fft_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// The tile kernels: K8, K3, K4, K6, K7 and K23 on the core of
// col_fft_tile.cuh, one launch each, a cluster of Q CTAs per 16-column tile
// and plane (grid (Q, tiles, planes)), N = Q R four-step: each CTA reads
// its R rows q + Q r2 once (64-byte row segments), does the length-R DFT as
// two register-resident radix passes with one shared-memory exchange, and
// after a cluster barrier finishes a length-Q DFT over the cluster's shared
// memory.  What bounds them on this card: device memory, one read
// and one write of two planes (268 MB at (1, 4096, 4096): 0.080 ms at
// 3.35 TB/s; K6 reads one plane, 201 MB); the 5 N log2 N flops per column
// are about a percent of the FP32 rate.
// ---------------------------------------------------------------------------

template <int R, int R1, int R2, int Q>
struct Plan {
  static constexpr int kR = R, kR1 = R1, kR2 = R2, kQ = Q;
  using Tile = col_fft_tile::Tile<R, R1, R2, Q>;
};

// f(Plan<R, R1, R2, Q>{}) at the plan of N, the same for every tile
// kernel; other N are refused.
template <typename F>
cudaError_t with_plan(int N, F f) {
  switch (N) {
    case 256:
      return f(Plan<256, 16, 16, 1>{});
    case 512:
      return f(Plan<512, 32, 16, 1>{});
    case 1024:
      return f(Plan<512, 32, 16, 2>{});
    case 2048:
      return f(Plan<512, 32, 16, 4>{});
    case 4096:
      return f(Plan<512, 32, 16, 8>{});
    case 8192:
      return f(Plan<1024, 32, 32, 8>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// Launches a tile kernel of plan Pn over `tiles` column tiles of `planes`
// planes, in clusters of Q CTAs along x, with the tile's shared memory and
// `extra_smem` bytes more.
template <typename Pn, typename... KArgs, typename... Args>
cudaError_t launch_tiles(void (*kernel)(KArgs...), int tiles, int planes,
                         void* stream, int extra_smem, Args... args) {
  using T = typename Pn::Tile;
  if (tiles > 65535 || planes <= 0 || planes > 65535)
    return cudaErrorInvalidValue;
  const int smem = T::kSmemBytes + extra_smem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Pn::kQ, tiles, planes);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Pn::kQ;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = Pn::kQ > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8 -- replaces katsdpimager_tpu/ops/pallas_fft.py:_make_col_kernel
// (col_fft, driven twice by fft2_pallas).
//
// y[b, k, c] = sum_r x[b, r, c] exp(sgn 2 pi i r k / N): the plain
// unnormalised DFT of every column of a (B, N, M) plane pair, sgn = -1
// forward, +1 inverse, stored in natural orientation.  A ragged last tile
// loads zeros and stores nothing past M.
// ---------------------------------------------------------------------------

template <int R, int R1, int R2, int Q>
__global__ void __launch_bounds__(col_fft_tile::Tile<R, R1, R2, Q>::kThreads,
                                  col_fft_tile::Tile<R, R1, R2, Q>::kMinBlocks)
col_fft_k8_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float2* __restrict__ tw, float* __restrict__ yr,
                  float* __restrict__ yi, int N, int M, float sgn) {
  extern __shared__ float2 tile_buf[];
  const size_t plane = static_cast<size_t>(blockIdx.z) * N * M;
  const int c0 = static_cast<int>(blockIdx.y) * col_fft_tile::kCols;
  xr += plane;
  xi += plane;
  yr += plane;
  yi += plane;
  col_fft_tile::col_fft_tile<R, R1, R2, Q>(
      tile_buf, tw, N, Q == 1 ? 0 : static_cast<int>(blockIdx.x), sgn,
      [&](int r, int c) {
        const size_t off = static_cast<size_t>(r) * M + c0 + c;
        return c0 + c < M ? make_float2(__ldcs(xr + off), __ldcs(xi + off))
                          : make_float2(0.f, 0.f);
      },
      [&](int k2, int c, const float2(&y)[Q]) {
        if (c0 + c < M) {
#pragma unroll
          for (int k1 = 0; k1 < Q; ++k1) {
            const size_t off = static_cast<size_t>(k2 + R * k1) * M + c0 + c;
            __stcs(yr + off, y[k1].x);
            __stcs(yi + off, y[k1].y);
          }
        }
      });
}

// ---------------------------------------------------------------------------
// K3 -- replaces katsdpimager_tpu/ops/pallas_fft.py:_make_cb_col_kernel
// (pass A of grid_to_image_fused_parts) and the XLA transpose after it.
//
// y[p, c, k] = sum_r (-1)^(r+c) x[p, r, c] exp(+2 pi i r k / N): the
// unnormalised inverse DFT of every column of cb * x, stored TRANSPOSED,
// so pass B again transforms columns.  The checkerboard is an exact sign
// flip as the values load.  The transposed store: with clusters (N >=
// 1024), the finish runs along k (Finish::kAlongK), so each warp stores
// 128 contiguous bytes of an output row; with none (N = 256, 512), the
// outputs are staged in shared memory, then written row by row.
// ---------------------------------------------------------------------------

template <int R, int R1, int R2, int Q>
__global__ void __launch_bounds__(col_fft_tile::Tile<R, R1, R2, Q>::kThreads,
                                  col_fft_tile::Tile<R, R1, R2, Q>::kMinBlocks)
cb_col_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float2* __restrict__ tw, float* __restrict__ yr,
                  float* __restrict__ yi) {
  constexpr int N = Q * R;
  extern __shared__ float2 tile_buf[];
  const size_t plane = static_cast<size_t>(blockIdx.z) * N * N;
  const int c0 = static_cast<int>(blockIdx.y) * col_fft_tile::kCols;
  xr += plane;
  xi += plane;
  yr += plane;
  yi += plane;
  auto load = [&](int r, int c) {
    const size_t off = static_cast<size_t>(r) * N + c0 + c;
    const float2 x = make_float2(__ldcs(xr + off), __ldcs(xi + off));
    return ((r + c0 + c) & 1) ? make_float2(-x.x, -x.y) : x;
  };
  if constexpr (Q == 1) {
    col_fft_tile::col_fft_tile<R, R1, R2, Q>(
        tile_buf, tw, N, 0, 1.0f, load,
        [&](int k, int c, const float2(&y)[1]) {
          tile_buf[col_fft_tile::column_slot<R>(k, c)] = y[0];
        });
    __syncthreads();
    col_fft_tile::store_staged_transposed<R, R1, R2>(tile_buf, yr, yi, N, c0);
  } else {
    col_fft_tile::col_fft_tile<R, R1, R2, Q, col_fft_tile::Finish::kAlongK>(
        tile_buf, tw, N, static_cast<int>(blockIdx.x), 1.0f, load,
        [&](int k2, int c, const float2(&y)[Q]) {
#pragma unroll
          for (int k1 = 0; k1 < Q; ++k1) {
            const size_t off = static_cast<size_t>(c0 + c) * N + k2 + R * k1;
            __stcs(yr + off, y[k1].x);
            __stcs(yi + off, y[k1].y);
          }
        });
  }
}

// ---------------------------------------------------------------------------
// K23 -- K2 fused into K3: replaces, on the slice loop's path, K2
// (csrc/gridder.cu, katsdpimager_tpu/ops/pallas_gridder.py:
// _make_combine_kernel) then K3 (cb_col_fft_kernel above,
// katsdpimager_tpu/ops/pallas_fft.py:_make_cb_col_kernel).
//
// y[p, c, k] = sum_r (-1)^(r+c) g[p, r, c] exp(+2 pi i r k / N) with
// g[p, r, c] = ((x00 + x01) + x10) + x11 and x_ab the colour plane
// (a, b) at (r - a ts, c - b ts) where that lies in the plane and its
// tile's `occ` byte is set, else +0.0f: K2's value in K2's add order, then
// K3's sign flip, transform and transposed store, so the output is bitwise
// K3's on K2's grid.  The grid is never written or read back.
//
// What bounds it on this card: device memory.  It reads the colour
// planes' values that land in the N x N grid from occupied blocks, once
// (at most 4 x 8 B a pixel, 537 MB at N = 4096, P = 1, all occupied), and
// writes the transposed pair once (134 MB); K2 + K3 moved those bytes plus
// the grid, written then read (268 MB).
//
// Design: K3's tile core, whose load reads each value from shared memory
// where the kernel has just summed it.  Four terms a value cannot all be
// in flight in registers the way K3's loads are (a thread holds 32
// complex values, at most 85 registers at three CTAs an SM; summing in
// registers while the terms arrive spilled), so the kernel first works
// through its values four at a time, with nothing else live: the four
// terms' loads predicated on presence (an absent term, off the plane or
// in a block K1 never wrote, is never read, so the garbage of unwritten
// blocks, torch.empty, cannot leak), the adds in K2's order, the
// checkerboard sign, and the sum stored in the tile slot that pass 1
// later reads the value from and writes its output to.  Those slots are
// the thread's own, so no barrier is needed.  Which terms are present is
// worked out before any load, into a bit mask per colour, from `occ` read
// through L1: the thread's values lie N / R1 rows apart in one column, so
// each value's tile row follows from the last by an add.  At ts = 64 a
// 16-column tile segment lies in one colour tile, so a warp's loads of an
// absent block are all skipped.  A CTA reads 64 bytes of each row it
// touches, the pattern that holds K3 near 55% of the card's bandwidth, so
// the loads ask L2 for whole 128-byte lines (load_term), which serve the
// neighbouring column tile's CTA too.  Every ts and every N of with_plan
// run; ts >= 1.
// ---------------------------------------------------------------------------

// K23's load of a term: not kept in L1 (read once), and on a miss L2
// fetches the whole 128-byte line, the 64-byte row segment of this column
// tile and that of its neighbour, whose CTAs run at the same time.
// Volatile, so that it is never moved out of the test of the term's
// presence (an absent term's address may lie off the planes).
__device__ __forceinline__ float load_term(const float* p) {
  float v;
  asm volatile("ld.global.L1::no_allocate.L2::128B.f32 %0, [%1];"
               : "=f"(v)
               : "l"(p));
  return v;
}

template <int R, int R1, int R2, int Q>
__global__ void __launch_bounds__(col_fft_tile::Tile<R, R1, R2, Q>::kThreads,
                                  col_fft_tile::Tile<R, R1, R2, Q>::kMinBlocks)
combine_cb_col_fft_kernel(const float* __restrict__ accr,
                          const float* __restrict__ acci,
                          const unsigned char* __restrict__ occ,
                          const float2* __restrict__ tw,
                          float* __restrict__ yr, float* __restrict__ yi,
                          int P, int ts, int nt2) {
  using T = col_fft_tile::Tile<R, R1, R2, Q>;
  constexpr int N = Q * R;
  constexpr int kCols = col_fft_tile::kCols;
  constexpr int NB = col_fft_tile::kPerThread / R1;
  constexpr int kRR = R / R1;      // local rows between values i and i + 1
  constexpr int kStride = Q * kRR;  // plane rows between them
  extern __shared__ float2 tile_buf[];
  const int p = static_cast<int>(blockIdx.z);
  const size_t plane = static_cast<size_t>(p) * N * N;
  const int c0 = static_cast<int>(blockIdx.y) * kCols;
  const int q = Q == 1 ? 0 : static_cast<int>(blockIdx.x);
  yr += plane;
  yi += plane;
  const int ts2 = 2 * ts;
  const size_t ext2 = static_cast<size_t>(nt2) * ts2;
  const size_t colour = static_cast<size_t>(P) * ext2 * ext2;
  // The thread's tile column, the same for each of its values (kThreads is
  // a multiple of kCols), its column in planes (a, 0) and (a, 1) and the
  // colour tile column there (-1: off the plane).
  const int c = threadIdx.x % kCols;
  int pc[2], tc[2];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    pc[b] = c0 + c - b * ts;
    tc[b] = pc[b] >= 0 ? pc[b] / ts2 : -1;
  }
  // have[ab][u], bit i: term (a, b) of value (u, i) is present.  Worked
  // out first, so that no load of a term waits on a read of `occ`.
  unsigned have[4][NB];
  const int dq = kStride / ts2, dr = kStride % ts2;
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int j = (threadIdx.x + u * T::kThreads) / kCols;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      // Value i's plane row is pr + i kStride: its tile row tr (floor; -1
      // above the plane) and remainder rem, each from the last by an add.
      const int pr = q + Q * j - a * ts;
      int tr = pr >= 0 ? pr / ts2 : -((ts2 - 1 - pr) / ts2);
      int rem = pr - tr * ts2;
      unsigned m[2] = {0, 0};
#pragma unroll 8
      for (int i = 0; i < R1; ++i) {
#pragma unroll
        for (int b = 0; b < 2; ++b)
          if (tr >= 0 && tc[b] >= 0 &&
              __ldg(occ + (static_cast<size_t>(2 * a + b) * nt2 + tr) * nt2 +
                    tc[b]))
            m[b] |= 1u << i;
        tr += dq;
        rem += dr;
        if (rem >= ts2) {
          rem -= ts2;
          ++tr;
        }
      }
      have[2 * a][u] = m[0];
      have[2 * a + 1][u] = m[1];
    }
  }
  // The sums, a few values at a time.  Term (a, b) of value i + 1 lies
  // kStride plane rows below that of value i, and the checkerboard's sign
  // is the same for all of a thread's values (kStride is even).
  const size_t step = static_cast<size_t>(kStride) * ext2;
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int j = (threadIdx.x + u * T::kThreads) / kCols;
    const bool flip = (q + Q * j + c0 + c) & 1;
    const float* xr[4];
    const float* xi[4];
    unsigned m[4];
#pragma unroll
    for (int ab = 0; ab < 4; ++ab) {
      const int a = ab >> 1, b = ab & 1;
      // Off the plane (a row or column below 0) only while its bit is 0.
      const long long off =
          static_cast<long long>(ab * colour + p * ext2 * ext2) +
          static_cast<long long>(q + Q * j - a * ts) *
              static_cast<long long>(ext2) +
          pc[b];
      xr[ab] = accr + off;
      xi[ab] = acci + off;
      m[ab] = have[ab][u];
    }
#pragma unroll 4
    for (int i = 0; i < R1; ++i) {
      float2 sum = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int ab = 0; ab < 4; ++ab) {
        float2 x = make_float2(0.0f, 0.0f);
        if (m[ab] & 1u) x = make_float2(load_term(xr[ab]), load_term(xi[ab]));
        sum = ab == 0 ? x : make_float2(sum.x + x.x, sum.y + x.y);
        m[ab] >>= 1;
        xr[ab] += step;
        xi[ab] += step;
      }
      if (flip) sum = make_float2(-sum.x, -sum.y);
      tile_buf[(j * R1 + i) * kCols + c] = sum;
    }
  }
  // Value (u, i) of this thread, plane row r = q + Q (j + i kRR), is in
  // slot (j R1 + i) kCols + c.
  auto load = [&](int r, int cc) {
    const int r2 = (r - q) / Q;
    return tile_buf[((r2 % kRR) * R1 + r2 / kRR) * kCols + cc];
  };
  if constexpr (Q == 1) {
    col_fft_tile::col_fft_tile<R, R1, R2, Q>(
        tile_buf, tw, N, 0, 1.0f, load,
        [&](int k, int cc, const float2(&y)[1]) {
          tile_buf[col_fft_tile::column_slot<R>(k, cc)] = y[0];
        });
    __syncthreads();
    col_fft_tile::store_staged_transposed<R, R1, R2>(tile_buf, yr, yi, N, c0);
  } else {
    col_fft_tile::col_fft_tile<R, R1, R2, Q, col_fft_tile::Finish::kAlongK>(
        tile_buf, tw, N, q, 1.0f, load,
        [&](int k2, int cc, const float2(&y)[Q]) {
#pragma unroll
          for (int k1 = 0; k1 < Q; ++k1) {
            const size_t off = static_cast<size_t>(c0 + cc) * N + k2 + R * k1;
            __stcs(yr + off, y[k1].x);
            __stcs(yi + off, y[k1].y);
          }
        });
  }
}

// ---------------------------------------------------------------------------
// K4 -- replaces katsdpimager_tpu/ops/pallas_fft.py:_make_epi_col_kernel
// (pass B of grid_to_image_fused_parts), once for each of S W slices.
//
// For each slice s in turn: Y_s = inverse column DFT of slice s's
// transposed pass-A output, then in place
//     imgT[p, r, c] += Y.re * (cos(ph) * common) - Y.im * (sin(ph) * common)
// with the f32 formulas of pallas_fft.py: lm = (index - N/2) * pixel_size,
// n = sqrt(1 - lm_r^2 - lm_c^2), ph = 2 pi w_s (n - 1),
// common = cb * n / (taper[r] * taper[c]), cb = (-1)^(r+c).
// The factors are symmetric in (r, c), so the transposed image takes the
// same formulas.  Each finished value (row k, column c) is updated straight
// from the cluster's finish: 64-byte row segments, like K8's stores.
// w_s and the pixel size are read from a device array, so the W-slice loop
// needs no host sync.
//
// Bound by device memory: each slice's two planes read, the image read and
// written once a launch ((2 S + 2) planes: 671 MB at (S, P, N) =
// (4, 1, 4096), 0.200 ms at 3.35 TB/s, where a launch a slice moves 4 S
// planes).  A CTA takes its column tile of one plane through every slice:
// the core's load, transform and finish for each, the finish adding that
// slice's epilogue to the thread's image values.  The first slice's finish
// reads the image (prefetched into L2 as its inputs load), the last one's
// writes it with a streaming store; in between each thread keeps its
// kPerThread values (EpiKeep): on chip, in shared memory beside the tile in
// slots of its own, where that leaves the SM as many CTAs as the tile alone
// (N = 8192); elsewhere in the image itself, through L2 under an evict-last
// policy (on chip, the extra 32 KB a CTA at N = 4096 would cost a third of
// the CTAs, and that was slower on an H100 SXM: 0.661 against 0.632 ms at
// (S, P, N) = (4, 1, 4096); at (6, 4, 8192) on chip 16.30 against 16.81
// ms).  So the adds are those of S one-slice launches, in the same order:
// bitwise their image.  One slice (S = 1) runs as the one-slice kernel did.
//
// Each slice's copies of the twiddle table's and the taper's pointers, the
// tile's first column and the cluster rank pass through an empty asm: the
// twiddles and the taper every slice reads again, and their addresses, are
// then not hoisted out of the slice loop into registers held across it,
// which spilled ~1 KB a thread.  What K4 adds to K8: the image's
// read and write and the epilogue's ~70 instructions per value and slice
// (IEEE sqrtf, __fdiv_rn, the full-range sincosf), which, with the
// transform's, set its pace more than its bytes do.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" : : "l"(p));
}

// An L2 policy that evicts the lines it marks last, and a load and a store
// under it (the image values K4 keeps between slices).
__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ float load_kept(const float* p,
                                           unsigned long long policy) {
  float v;
  asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
               : "=f"(v)
               : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void store_kept(float* p, float v,
                                           unsigned long long policy) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;"
               :
               : "l"(p), "f"(v), "l"(policy)
               : "memory");
}

// K4's epilogue at image row r, column c: round-to-nearest intrinsics, so
// that no multiply-add is contracted and it rounds as the plain version
// does; IEEE sqrtf and the full-range sincosf.
__device__ __forceinline__ float epilogue(float img, float2 y, int r, int c,
                                          float taper_r, float taper_c,
                                          float two_pi_w, float ps,
                                          float half) {
  const float lm_r = __fmul_rn(__fsub_rn(static_cast<float>(r), half), ps);
  const float lm_c = __fmul_rn(__fsub_rn(static_cast<float>(c), half), ps);
  const float n_lm = sqrtf(__fsub_rn(__fsub_rn(1.0f, __fmul_rn(lm_r, lm_r)),
                                     __fmul_rn(lm_c, lm_c)));
  const float phase = __fmul_rn(two_pi_w, __fsub_rn(n_lm, 1.0f));
  const float cb = ((r + c) & 1) ? -1.0f : 1.0f;
  const float taper2 = __fmul_rn(taper_r, taper_c);
  const float common = __fdiv_rn(__fmul_rn(cb, n_lm), taper2);
  float sn, cs;
  sincosf(phase, &sn, &cs);
  return __fsub_rn(__fadd_rn(img, __fmul_rn(y.x, __fmul_rn(cs, common))),
                   __fmul_rn(y.y, __fmul_rn(sn, common)));
}

// The CTAs an SM holds of a kernel that asks `smem` bytes of shared memory
// a CTA, at most `most` (H100: 228 KB a SM, 1 KB of it reserved a CTA).
constexpr int ctas_per_sm(int smem, int most) {
  return 233472 / (smem + 1024) < most ? 233472 / (smem + 1024) : most;
}

// Where K4 keeps a thread's image values between slices: kBytes of shared
// memory a CTA beside the tile (value i of thread t at i kThreads + t) if
// kOnChip, where the SM then holds as many CTAs as with the tile alone;
// else in the image.
template <int R, int R1, int R2, int Q>
struct EpiKeep {
  using T = col_fft_tile::Tile<R, R1, R2, Q>;
  static constexpr int kBytes =
      col_fft_tile::kPerThread * T::kThreads * static_cast<int>(sizeof(float));
  static constexpr bool kOnChip =
      ctas_per_sm(T::kSmemBytes + kBytes, T::kMinBlocks) >=
      ctas_per_sm(T::kSmemBytes, T::kMinBlocks);
};

// xr/xi (S, P, N, N), scal (S, 2) [w, pixel size], img (P, N, N).
template <int R, int R1, int R2, int Q>
__global__ void __launch_bounds__(col_fft_tile::Tile<R, R1, R2, Q>::kThreads,
                                  col_fft_tile::Tile<R, R1, R2, Q>::kMinBlocks)
epi_col_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const float2* __restrict__ tw,
                   const float* __restrict__ taper,
                   const float* __restrict__ scal, float* __restrict__ img,
                   int S, int P) {
  using T = col_fft_tile::Tile<R, R1, R2, Q>;
  using Keep = EpiKeep<R, R1, R2, Q>;
  constexpr int N = Q * R;
  constexpr int L = R / Q;
  extern __shared__ float2 tile_buf[];
  float* kept = reinterpret_cast<float*>(tile_buf + R * col_fft_tile::kCols);
  const size_t plane = static_cast<size_t>(blockIdx.z) * N * N;
  const size_t slice = static_cast<size_t>(P) * N * N;
  const float half = 0.5f * static_cast<float>(N);
  const unsigned long long policy = Keep::kOnChip ? 0 : evict_last_policy();
  img += plane;
  for (int s = 0; s < S; ++s) {
    const float* sr = xr + plane + s * slice;
    const float* si = xi + plane + s * slice;
    const bool first = s == 0, last = s == S - 1;
    const float ps = scal[2 * s + 1];
    const float two_pi_w = __fmul_rn(6.28318530717958647692f, scal[2 * s]);
    const float2* tws = tw;
    const float* tps = taper;
    int c0 = static_cast<int>(blockIdx.y) * col_fft_tile::kCols;
    int q = Q == 1 ? 0 : static_cast<int>(blockIdx.x);
    asm volatile("" : "+l"(tws), "+l"(tps), "+r"(c0), "+r"(q));
    int i0 = 0;  // the thread's first value in this call of the store hook
    col_fft_tile::col_fft_tile<R, R1, R2, Q>(
        tile_buf, tws, N, q, 1.0f,
        [&](int r, int c) {
          // The CTA updates as many image rows as it reads input rows:
          // with r = q + Q r2, row q L + r2 % L + R (r2 / L).  That row's
          // value at this column is prefetched into L2 with the first
          // slice's loads, so the first finish's read of it waits on L2,
          // not on device memory.
          if (first) {
            const int r2 = r / Q;
            const size_t row = q * L + r2 % L + R * (r2 / L);
            prefetch_l2(img + row * N + c0 + c);
          }
          const size_t off = static_cast<size_t>(r) * N + c0 + c;
          return make_float2(__ldcs(sr + off), __ldcs(si + off));
        },
        [&](int k2, int c, const float2(&y)[Q]) {
          // All Q image values first, so their reads are in flight
          // together.
          float old[Q];
#pragma unroll
          for (int k1 = 0; k1 < Q; ++k1) {
            const size_t off = static_cast<size_t>(k2 + R * k1) * N + c0 + c;
            if (first)
              old[k1] = __ldcs(img + off);
            else if (Keep::kOnChip)
              old[k1] = kept[(i0 + k1) * T::kThreads + threadIdx.x];
            else
              old[k1] = load_kept(img + off, policy);
          }
          const float taper_c = __ldg(tps + c0 + c);
#pragma unroll
          for (int k1 = 0; k1 < Q; ++k1) {
            const int k = k2 + R * k1;
            const size_t off = static_cast<size_t>(k) * N + c0 + c;
            const float v = epilogue(old[k1], y[k1], k, c0 + c,
                                     __ldg(tps + k), taper_c, two_pi_w, ps,
                                     half);
            if (last)
              __stcs(img + off, v);
            else if (Keep::kOnChip)
              kept[(i0 + k1) * T::kThreads + threadIdx.x] = v;
            else
              store_kept(img + off, v, policy);
          }
          i0 += Q;
        });
  }
}

// ---------------------------------------------------------------------------
// K6 -- replaces katsdpimager_tpu/ops/pallas_fft.py:_make_pre_col_kernel
// (pass A of image_to_grid_fused_parts) and the XLA transpose after it.
//
// From the TRANSPOSED real model image imgT, per element (r, c):
//     layer = img * (cb / (taper[r] taper[c] * n)) * exp(-2 pi i w (n - 1))
// with lm = (index - N/2) * pixel_size, n = sqrt(1 - lm_r^2 - lm_c^2),
// cb = (-1)^(r+c); then the unnormalised FORWARD DFT of every column,
// stored transposed, so K7 again transforms columns.  The factors are
// symmetric in (r, c), so the transposed image takes the same formulas.
//
// Bound by device memory: one plane read, two written (201 MB at
// (1, 4096, 4096): 0.060 ms at 3.35 TB/s).  The load hook fetches only the
// image value; the prologue (~70 instructions: IEEE sqrtf, __fdiv_rn, the
// full-range sincosf) runs in the core's per-value hook once all of a
// thread's loads are in flight, so its branches never hold a load back.
// The transposed store is K3's: with clusters the finish runs along k
// (128-byte runs of an output row), without them (N = 256, 512) the
// outputs are staged in shared memory by column.
// ---------------------------------------------------------------------------

// K6's prologue at image row r, column c: round-to-nearest intrinsics, so
// that no multiply-add is contracted and it rounds as the plain version
// does; IEEE sqrtf and the full-range sincosf.
__device__ __forceinline__ float2 prologue(float img, int r, int c,
                                           float taper_r, float taper_c,
                                           float m_two_pi_w, float ps,
                                           float half) {
  const float lm_r = __fmul_rn(__fsub_rn(static_cast<float>(r), half), ps);
  const float lm_c = __fmul_rn(__fsub_rn(static_cast<float>(c), half), ps);
  const float n_lm = sqrtf(__fsub_rn(__fsub_rn(1.0f, __fmul_rn(lm_r, lm_r)),
                                     __fmul_rn(lm_c, lm_c)));
  const float phase = __fmul_rn(m_two_pi_w, __fsub_rn(n_lm, 1.0f));
  const float cb = ((r + c) & 1) ? -1.0f : 1.0f;
  const float taper2 = __fmul_rn(taper_r, taper_c);
  const float pre = __fmul_rn(img, __fdiv_rn(cb, __fmul_rn(taper2, n_lm)));
  float sn, cs;
  sincosf(phase, &sn, &cs);
  return make_float2(__fmul_rn(pre, cs), __fmul_rn(pre, sn));
}

template <int R, int R1, int R2, int Q>
__global__ void __launch_bounds__(col_fft_tile::Tile<R, R1, R2, Q>::kThreads,
                                  col_fft_tile::Tile<R, R1, R2, Q>::kMinBlocks)
pre_col_fft_kernel(const float* __restrict__ img,
                   const float2* __restrict__ tw,
                   const float* __restrict__ taper,
                   const float* __restrict__ scal, float* __restrict__ yr,
                   float* __restrict__ yi) {
  constexpr int N = Q * R;
  extern __shared__ float2 tile_buf[];
  const size_t plane = static_cast<size_t>(blockIdx.z) * N * N;
  const int c0 = static_cast<int>(blockIdx.y) * col_fft_tile::kCols;
  img += plane;
  yr += plane;
  yi += plane;
  const float ps = scal[1];
  const float half = 0.5f * static_cast<float>(N);
  const float m_two_pi_w = __fmul_rn(-6.28318530717958647692f, scal[0]);
  auto load = [&](int r, int c) {
    return make_float2(__ldcs(img + static_cast<size_t>(r) * N + c0 + c),
                       0.0f);
  };
  auto prep = [&](int r, int c, float2 v) {
    return prologue(v.x, r, c0 + c, __ldg(taper + r), __ldg(taper + c0 + c),
                    m_two_pi_w, ps, half);
  };
  if constexpr (Q == 1) {
    col_fft_tile::col_fft_tile<R, R1, R2, Q>(
        tile_buf, tw, N, 0, -1.0f, load,
        [&](int k, int c, const float2(&y)[1]) {
          tile_buf[col_fft_tile::column_slot<R>(k, c)] = y[0];
        },
        prep);
    __syncthreads();
    col_fft_tile::store_staged_transposed<R, R1, R2>(tile_buf, yr, yi, N, c0);
  } else {
    col_fft_tile::col_fft_tile<R, R1, R2, Q, col_fft_tile::Finish::kAlongK>(
        tile_buf, tw, N, static_cast<int>(blockIdx.x), -1.0f, load,
        [&](int k2, int c, const float2(&y)[Q]) {
#pragma unroll
          for (int k1 = 0; k1 < Q; ++k1) {
            const size_t off = static_cast<size_t>(c0 + c) * N + k2 + R * k1;
            __stcs(yr + off, y[k1].x);
            __stcs(yi + off, y[k1].y);
          }
        },
        prep);
  }
}

// ---------------------------------------------------------------------------
// K7 -- replaces katsdpimager_tpu/ops/pallas_fft.py:_make_cbout_col_kernel
// (pass B of image_to_grid_fused_parts).
//
// g[p, k, c] = (-1)^(k+c) sum_r x[p, r, c] exp(-2 pi i r k / N): the
// forward DFT of every column of K6's transposed output, times the output
// checkerboard, stored in place of its column, so the (P, N, N) grid
// planes come out the right way round (K5's input).
//
// Bound, like K8, by device memory: two planes read and two written
// (268 MB at (1, 4096, 4096)).  It is K8 at sgn = -1 with the checkerboard
// moved to the load: (-1)^k is the DFT of the input shifted by N/2 rows,
// so the load hook reads row (r + N/2) mod N and flips the sign of odd
// columns, and the store hook is K8's.  The half shift only negates one
// output of the first butterfly stage, so the result is bitwise the sign
// flip on store, with fewer registers (no spill at the production plan,
// against 8 bytes and, at N = 256, 352 for the flip on store).
// ---------------------------------------------------------------------------

template <int R, int R1, int R2, int Q>
__global__ void __launch_bounds__(col_fft_tile::Tile<R, R1, R2, Q>::kThreads,
                                  col_fft_tile::Tile<R, R1, R2, Q>::kMinBlocks)
cbout_col_fft_kernel(const float* __restrict__ xr,
                     const float* __restrict__ xi,
                     const float2* __restrict__ tw, float* __restrict__ yr,
                     float* __restrict__ yi) {
  constexpr int N = Q * R;
  extern __shared__ float2 tile_buf[];
  const size_t plane = static_cast<size_t>(blockIdx.z) * N * N;
  const int c0 = static_cast<int>(blockIdx.y) * col_fft_tile::kCols;
  xr += plane;
  xi += plane;
  yr += plane;
  yi += plane;
  col_fft_tile::col_fft_tile<R, R1, R2, Q>(
      tile_buf, tw, N, Q == 1 ? 0 : static_cast<int>(blockIdx.x), -1.0f,
      [&](int r, int c) {
        const size_t off =
            static_cast<size_t>((r + N / 2) & (N - 1)) * N + c0 + c;
        const float2 x = make_float2(__ldcs(xr + off), __ldcs(xi + off));
        return ((c0 + c) & 1) ? make_float2(-x.x, -x.y) : x;
      },
      [&](int k2, int c, const float2(&y)[Q]) {
#pragma unroll
        for (int k1 = 0; k1 < Q; ++k1) {
          const size_t off = static_cast<size_t>(k2 + R * k1) * N + c0 + c;
          __stcs(yr + off, y[k1].x);
          __stcs(yi + off, y[k1].y);
        }
      });
}

}  // namespace

// tw for every kernel: exp(+2 pi i k / N) for k < N (fused_fft.twiddles_full).
extern "C" int ktt_cb_col_fft(const void* xr, const void* xi, const void* tw,
                              void* yr, void* yi, int P, int N,
                              void* stream) {
  return with_plan(N, [&](auto plan) {
    using Pn = decltype(plan);
    return launch_tiles<Pn>(
        cb_col_fft_kernel<Pn::kR, Pn::kR1, Pn::kR2, Pn::kQ>,
        N / col_fft_tile::kCols, P, stream, 0, static_cast<const float*>(xr),
        static_cast<const float*>(xi), static_cast<const float2*>(tw),
        static_cast<float*>(yr), static_cast<float*>(yi));
  });
}

// accr/acci (4, P, ext2, ext2) f32 colour planes with ext2 = nt2 * 2 ts
// >= N + ts; occ (4, nt2, nt2) bytes; yr/yi the (P, N, N) output pair.
extern "C" int ktt_combine_cb_col_fft(const void* accr, const void* acci,
                                      const void* occ, const void* tw,
                                      void* yr, void* yi, int P, int N,
                                      int ts, int nt2, void* stream) {
  if (ts <= 0 || nt2 <= 0 || static_cast<long long>(nt2) * 2 * ts < N + ts)
    return cudaErrorInvalidValue;
  return with_plan(N, [&](auto plan) {
    using Pn = decltype(plan);
    return launch_tiles<Pn>(
        combine_cb_col_fft_kernel<Pn::kR, Pn::kR1, Pn::kR2, Pn::kQ>,
        N / col_fft_tile::kCols, P, stream, 0, static_cast<const float*>(accr),
        static_cast<const float*>(acci),
        static_cast<const unsigned char*>(occ),
        static_cast<const float2*>(tw), static_cast<float*>(yr),
        static_cast<float*>(yi), P, ts, nt2);
  });
}

// xr/xi (S, P, N, N) f32, scal (S, 2) f32, imgT (P, N, N) f32.
extern "C" int ktt_epi_col_fft(const void* xr, const void* xi, const void* tw,
                               const void* taper, const void* scal,
                               void* imgT, int S, int P, int N,
                               void* stream) {
  if (S <= 0) return cudaErrorInvalidValue;
  return with_plan(N, [&](auto plan) {
    using Pn = decltype(plan);
    using Keep = EpiKeep<Pn::kR, Pn::kR1, Pn::kR2, Pn::kQ>;
    const int keep = Keep::kOnChip && S > 1 ? Keep::kBytes : 0;
    return launch_tiles<Pn>(
        epi_col_fft_kernel<Pn::kR, Pn::kR1, Pn::kR2, Pn::kQ>,
        N / col_fft_tile::kCols, P, stream, keep,
        static_cast<const float*>(xr), static_cast<const float*>(xi),
        static_cast<const float2*>(tw), static_cast<const float*>(taper),
        static_cast<const float*>(scal), static_cast<float*>(imgT), S, P);
  });
}

extern "C" int ktt_pre_col_fft(const void* imgT, const void* tw,
                               const void* taper, const void* scal, void* yr,
                               void* yi, int P, int N, void* stream) {
  return with_plan(N, [&](auto plan) {
    using Pn = decltype(plan);
    return launch_tiles<Pn>(
        pre_col_fft_kernel<Pn::kR, Pn::kR1, Pn::kR2, Pn::kQ>,
        N / col_fft_tile::kCols, P, stream, 0, static_cast<const float*>(imgT),
        static_cast<const float2*>(tw), static_cast<const float*>(taper),
        static_cast<const float*>(scal), static_cast<float*>(yr),
        static_cast<float*>(yi));
  });
}

extern "C" int ktt_col_fft(const void* xr, const void* xi, const void* tw,
                           void* yr, void* yi, int B, int N, int M, int sign,
                           void* stream) {
  if (M <= 0 || (sign != 1 && sign != -1)) return cudaErrorInvalidValue;
  const int tiles = (M + col_fft_tile::kCols - 1) / col_fft_tile::kCols;
  return with_plan(N, [&](auto plan) {
    using Pn = decltype(plan);
    return launch_tiles<Pn>(
        col_fft_k8_kernel<Pn::kR, Pn::kR1, Pn::kR2, Pn::kQ>, tiles, B,
        stream, 0, static_cast<const float*>(xr), static_cast<const float*>(xi),
        static_cast<const float2*>(tw), static_cast<float*>(yr),
        static_cast<float*>(yi), N, M, static_cast<float>(sign));
  });
}

extern "C" int ktt_cbout_col_fft(const void* xr, const void* xi,
                                 const void* tw, void* yr, void* yi, int P,
                                 int N, void* stream) {
  return with_plan(N, [&](auto plan) {
    using Pn = decltype(plan);
    return launch_tiles<Pn>(
        cbout_col_fft_kernel<Pn::kR, Pn::kR1, Pn::kR2, Pn::kQ>,
        N / col_fft_tile::kCols, P, stream, 0, static_cast<const float*>(xr),
        static_cast<const float*>(xi), static_cast<const float2*>(tw),
        static_cast<float*>(yr), static_cast<float*>(yi));
  });
}
