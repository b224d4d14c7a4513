// Fused gridder kernels for Hopper (sm_90a): K1 (band accumulation into
// the colour planes) and K2 (colour-plane combine).  Plain C interface,
// loaded with ctypes by katsdpimager_tpu_torch/ops/_build.py; the Python
// wrappers and plain PyTorch versions are in ops/fused_gridder.py.
//
// Each entry point launches on the stream it is given and returns
// cudaGetLastError().  Neither kernel allocates or synchronises.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// ---------------------------------------------------------------------------
// K1 -- replaces katsdpimager_tpu/ops/pallas_gridder.py:_make_kernel
// (launched by _grid_chunks_planes).
//
// What it computes: for each run of consecutive chunks that share one tile
// anchor, the (2ts x 2ts) complex band
//     band[j, k] = sum_m conj(K_v[m, j]) * sample[m] * conj(K_u[m, k])
// summed over the run's visibilities, written once into the colour plane
// block that the run's slot names.
//
// What bounds it on this card: FP32 FMA throughput.  The dense window does
// (2ts)^2 complex MACs per visibility (16384 at ts = 64), 4.5x the K^2 that
// carry a tap at K = 60; the bytes read (40 B per visibility plus the
// 128 KB kernel table, which stays in L1/L2) are negligible beside that.
//
// Design: one CTA per anchor run (grid NC x P).  A CTA whose chunk is not
// the first of its run exits at once, so no host pass counts runs.  The
// TPU kernel carried the run's sum across sequential grid steps; here the
// CTA loops over its run's chunks itself and keeps the whole window in
// registers (output-stationary: each of 256 threads owns an R x R tile of
// the window, rows ty + 16 r, columns tx + 16 q).  Visibilities are staged
// kMB at a time in shared memory as the shifted, sample-scaled factor rows
// (the JAX kernel's one-hot selection and lane shift become an indexed
// load with a bounds test), then every thread does an R x R complex outer
// product per visibility, in FP32 FMA (no tensor cores, no TF32).  The run
// is written once, with plain stores: no atomics, so the result does not
// depend on scheduling.
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16 threads over the window
constexpr int kMB = 32;        // visibilities staged per batch

template <int TS2>
__global__ void __launch_bounds__(kThreads, 1)
grid_planes_kernel(const int* __restrict__ slot, int n,
                   const int* __restrict__ iu, const int* __restrict__ iv,
                   const int* __restrict__ su, const int* __restrict__ sv,
                   const float* __restrict__ sre,
                   const float* __restrict__ sim,
                   const float2* __restrict__ tab,
                   float* __restrict__ accr, float* __restrict__ acci,
                   int Mc, int P, int K, int nt2) {
  constexpr int R = TS2 / 16;
  const int c0 = blockIdx.x;
  const int p = blockIdx.y;
  if (c0 >= n) return;
  const int s = slot[c0];
  if (c0 > 0 && slot[c0 - 1] == s) return;  // not the first chunk of its run

  extern __shared__ float2 smem[];
  float2* As = smem;              // [kMB][TS2]: conj(K_v) * sample
  float2* Bs = smem + kMB * TS2;  // [kMB][TS2]: conj(K_u)
  __shared__ int m_iv[kMB], m_iu[kMB], m_sv[kMB], m_su[kMB];
  __shared__ float m_sr[kMB], m_si[kMB];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc_r[R][R];
  float acc_i[R][R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      acc_r[r][q] = 0.0f;
      acc_i[r][q] = 0.0f;
    }
  }

  for (int c = c0; c < n && slot[c] == s; ++c) {
    const size_t cm = static_cast<size_t>(c) * Mc;
    const size_t cp = (static_cast<size_t>(c) * P + p) * Mc;
    for (int m0 = 0; m0 < Mc; m0 += kMB) {
      __syncthreads();  // the previous batch is fully consumed
      if (threadIdx.x < kMB) {
        const int t = threadIdx.x;
        const bool live = m0 + t < Mc;
        m_iv[t] = live ? iv[cm + m0 + t] : 0;
        m_iu[t] = live ? iu[cm + m0 + t] : 0;
        m_sv[t] = live ? sv[cm + m0 + t] : 0;
        m_su[t] = live ? su[cm + m0 + t] : 0;
        m_sr[t] = live ? sre[cp + m0 + t] : 0.0f;
        m_si[t] = live ? sim[cp + m0 + t] : 0.0f;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < kMB * TS2; e += kThreads) {
        const int mb = e / TS2;
        const int j = e % TS2;
        const int dv = j - m_sv[mb];
        const int du = j - m_su[mb];
        float2 a = make_float2(0.0f, 0.0f);
        float2 b = make_float2(0.0f, 0.0f);
        if (dv >= 0 && dv < K) {
          const float2 t = tab[m_iv[mb] * K + dv];
          const float sr = m_sr[mb], si = m_si[mb];
          a.x = t.x * sr - t.y * si;
          a.y = t.x * si + t.y * sr;
        }
        if (du >= 0 && du < K) b = tab[m_iu[mb] * K + du];
        As[e] = a;
        Bs[e] = b;
      }
      __syncthreads();
#pragma unroll 2
      for (int mb = 0; mb < kMB; ++mb) {
        float2 a[R], b[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          a[r] = As[mb * TS2 + ty + 16 * r];
          b[r] = Bs[mb * TS2 + tx + 16 * r];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int q = 0; q < R; ++q) {
            acc_r[r][q] = fmaf(a[r].x, b[q].x, acc_r[r][q]);
            acc_r[r][q] = fmaf(-a[r].y, b[q].y, acc_r[r][q]);
            acc_i[r][q] = fmaf(a[r].x, b[q].y, acc_i[r][q]);
            acc_i[r][q] = fmaf(a[r].y, b[q].x, acc_i[r][q]);
          }
        }
      }
    }
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
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const size_t off = base + (ty + 16 * r) * ext2 + tx + 16 * q;
      accr[off] = acc_r[r][q];
      acci[off] = acc_i[r][q];
    }
  }
}

template <int TS2>
cudaError_t launch_grid_planes(const int* slot, int n, const int* iu,
                               const int* iv, const int* su, const int* sv,
                               const float* sre, const float* sim,
                               const float2* tab, float* accr, float* acci,
                               int NC, int Mc, int P, int K, int nt2,
                               cudaStream_t stream) {
  const int smem = 2 * kMB * TS2 * static_cast<int>(sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      grid_planes_kernel<TS2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  grid_planes_kernel<TS2><<<dim3(NC, P), kThreads, smem, stream>>>(
      slot, n, iu, iv, su, sv, sre, sim, tab, accr, acci, Mc, P, K, nt2);
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

extern "C" int ktt_grid_planes(const void* slot, int n, const void* iu,
                               const void* iv, const void* su,
                               const void* sv, const void* sre,
                               const void* sim, const void* tab, void* accr,
                               void* acci, int NC, int Mc, int P, int K,
                               int ts, int nt2, void* stream) {
  if (n <= 0 || NC <= 0 || P <= 0) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto s = static_cast<const int*>(slot);
  auto u = static_cast<const int*>(iu);
  auto v = static_cast<const int*>(iv);
  auto du = static_cast<const int*>(su);
  auto dv = static_cast<const int*>(sv);
  auto r = static_cast<const float*>(sre);
  auto i = static_cast<const float*>(sim);
  auto t = static_cast<const float2*>(tab);
  auto ar = static_cast<float*>(accr);
  auto ai = static_cast<float*>(acci);
  switch (ts) {
    case 64:
      return launch_grid_planes<128>(s, n, u, v, du, dv, r, i, t, ar, ai, NC,
                                     Mc, P, K, nt2, st);
    case 32:
      return launch_grid_planes<64>(s, n, u, v, du, dv, r, i, t, ar, ai, NC,
                                    Mc, P, K, nt2, st);
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
