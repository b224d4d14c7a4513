// Column-DFT kernels for the grid <-> image transforms on Hopper (sm_90a):
// K3 (checkerboard + inverse column DFT, transposed store) and K4 (inverse
// column DFT + imaging corrections, accumulated into the transposed dirty
// image) for grid -> image; K6 (image -> layer prologue + forward column
// DFT, transposed store) and K7 (forward column DFT + output checkerboard)
// for image -> grid; K8 (plain column DFT, natural orientation) for the
// 2-D transform building block.  Plain C interface, loaded with ctypes by
// katsdpimager_tpu_torch/ops/_build.py; the Python wrappers and plain
// PyTorch versions are in ops/fused_fft.py.
//
// Built WITHOUT -use_fast_math: the W-phase 2 pi w (n - 1) of K4 and K6
// reaches far beyond +-pi, where __sinf/__cosf lose all accuracy.
//
// K8 runs on the four-step column-FFT tile core of col_fft_tile.cuh (one
// launch, clusters of Q CTAs, radix-16/32 butterflies in registers).  K3,
// K4, K6 and K7 still use the radix-2 core below.
//
// Radix-2 core: an in-place radix-2 decimation-in-time FFT over CB
// columns held in shared memory.  Inputs are loaded in bit-reversed order,
// so log2(N) butterfly passes leave the output in natural order.
// Twiddles exp(+2 pi i k / N), k < N/2, come from a table computed in
// float64 on the host and stored as float32; the forward transforms (K6,
// K7) conjugate them (an exact sign flip).  All arithmetic is FP32 FMA.
//
// What bounds both kernels on this card: shared-memory traffic of the
// log2(N) passes (each reads and writes CB * N complex values) and the
// strided column loads, whose row segments are CB * 4 bytes; the DFT
// itself is 5 N log2 N flops per column, far below the FP32 rate.  The
// TPU kernels' Bailey four-step with 64 x 64 DFT matrices suited the MXU
// but costs about 10x the flops of a radix-2 FFT in FP32 at N = 4096, so
// it is not carried over.

#include <cuda_runtime.h>

#include <cstddef>

#include "col_fft_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemComplex = 8192;  // CB * N complex values: 64 KB

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// In-place radix-2 DIT FFT of CB columns of length N = 2^logN in `buf`
// (column j at buf[j * N], bit-reversed input order), with the twiddles
// exp(sgn 2 pi i k / N): sgn = +1 inverse, -1 forward.  Ends synchronised.
__device__ void fft_columns(float2* buf, int logN, int CB,
                            const float2* __restrict__ tw, float sgn) {
  const int N = 1 << logN;
  const int half = N >> 1;
  const int total = CB * half;
  for (int s = 0; s < logN; ++s) {
    __syncthreads();
    const int h = 1 << s;
    const int stride = half >> s;  // N / (2h): twiddle index step
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      const int col = t >> (logN - 1);
      const int bf = t & (half - 1);
      const int pos = bf & (h - 1);
      const int i0 = ((bf >> s) << (s + 1)) | pos;
      float2* x = buf + col * N;
      const float2 tp = tw[pos * stride];
      const float2 w = make_float2(tp.x, sgn * tp.y);
      const float2 u = x[i0];
      const float2 v = cmul(w, x[i0 + h]);
      x[i0] = make_float2(u.x + v.x, u.y + v.y);
      x[i0 + h] = make_float2(u.x - v.x, u.y - v.y);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int bitrev(int r, int logN) {
  return static_cast<int>(__brev(static_cast<unsigned>(r)) >> (32 - logN));
}

// Load CB columns [c0, c0 + CB) of one (N, N) plane pair into `buf` in
// bit-reversed order, times the checkerboard (-1)^(r+c) when `cb`.
__device__ void load_columns(float2* buf, const float* __restrict__ xr,
                             const float* __restrict__ xi, int logN, int CB,
                             int c0, bool cb) {
  const int N = 1 << logN;
  for (int e = threadIdx.x; e < N * CB; e += blockDim.x) {
    const int r = e / CB;
    const int j = e - r * CB;
    const int c = c0 + j;
    const size_t off = static_cast<size_t>(r) * N + c;
    float vr = xr[off], vi = xi[off];
    if (cb && ((r + c) & 1)) {
      vr = -vr;
      vi = -vi;
    }
    buf[j * N + bitrev(r, logN)] = make_float2(vr, vi);
  }
}

// Transposed store of CB transformed columns: column c0 + j of the plane
// becomes row c0 + j of the output, contiguous along k (coalesced).
__device__ void store_transposed(const float2* buf, float* __restrict__ yr,
                                 float* __restrict__ yi, size_t plane,
                                 int logN, int CB, int c0) {
  const int N = 1 << logN;
  for (int e = threadIdx.x; e < N * CB; e += blockDim.x) {
    const int j = e >> logN;
    const int k = e & (N - 1);
    const size_t off = plane + static_cast<size_t>(c0 + j) * N + k;
    const float2 v = buf[e];
    yr[off] = v.x;
    yi[off] = v.y;
  }
}

// ---------------------------------------------------------------------------
// K3 -- replaces katsdpimager_tpu/ops/pallas_fft.py:_make_cb_col_kernel
// (pass A of grid_to_image_fused_parts) and the XLA transpose after it.
//
// y[p, c, k] = sum_r (-1)^(r+c) x[p, r, c] exp(+2 pi i r k / N): the
// unnormalised inverse DFT of every column of cb * x, stored TRANSPOSED,
// so pass B again transforms columns.  One CTA per (CB columns, plane).
// The transposed store is contiguous along k: fully coalesced.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
cb_col_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float2* __restrict__ tw, float* __restrict__ yr,
                  float* __restrict__ yi, int logN, int CB) {
  extern __shared__ float2 buf[];
  const int N = 1 << logN;
  const size_t plane = static_cast<size_t>(blockIdx.y) * N * N;
  const int c0 = blockIdx.x * CB;
  load_columns(buf, xr + plane, xi + plane, logN, CB, c0, true);
  fft_columns(buf, logN, CB, tw, 1.0f);
  store_transposed(buf, yr, yi, plane, logN, CB, c0);
}

// ---------------------------------------------------------------------------
// K4 -- replaces katsdpimager_tpu/ops/pallas_fft.py:_make_epi_col_kernel
// (pass B of grid_to_image_fused_parts).
//
// Y = inverse column DFT of the transposed pass-A output, then in place
//     imgT[p, r, c] += Y.re * (cos(ph) * common) - Y.im * (sin(ph) * common)
// with the f32 formulas of pallas_fft.py: lm = (index - N/2) * pixel_size,
// n = sqrt(1 - lm_r^2 - lm_c^2), ph = 2 pi w (n - 1),
// common = cb * n / (taper[r] * taper[c]), cb = (-1)^(r+c).
// The factors are symmetric in (r, c), so the transposed image takes the
// same formulas.  The epilogue uses round-to-nearest intrinsics so that
// no multiply-add is contracted: it then rounds as the plain version does.
// w and the pixel size are read from a device array, so the W-slice loop
// needs no host sync.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
epi_col_fft_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                   const float2* __restrict__ tw,
                   const float* __restrict__ taper,
                   const float* __restrict__ scal, float* __restrict__ img,
                   int logN, int CB) {
  extern __shared__ float2 buf[];
  const int N = 1 << logN;
  const size_t plane = static_cast<size_t>(blockIdx.y) * N * N;
  const int c0 = blockIdx.x * CB;
  load_columns(buf, xr + plane, xi + plane, logN, CB, c0, false);
  fft_columns(buf, logN, CB, tw, 1.0f);
  const float w = scal[0];
  const float ps = scal[1];
  const float half = 0.5f * static_cast<float>(N);
  const float two_pi_w = __fmul_rn(6.28318530717958647692f, w);
  for (int e = threadIdx.x; e < N * CB; e += blockDim.x) {
    const int r = e / CB;
    const int j = e - r * CB;
    const int c = c0 + j;
    const float lm_r = __fmul_rn(__fsub_rn(static_cast<float>(r), half), ps);
    const float lm_c = __fmul_rn(__fsub_rn(static_cast<float>(c), half), ps);
    const float n_lm = sqrtf(__fsub_rn(__fsub_rn(1.0f, __fmul_rn(lm_r, lm_r)),
                                       __fmul_rn(lm_c, lm_c)));
    const float phase = __fmul_rn(two_pi_w, __fsub_rn(n_lm, 1.0f));
    const float cb = ((r + c) & 1) ? -1.0f : 1.0f;
    const float taper2 = __fmul_rn(taper[r], taper[c]);
    const float common = __fdiv_rn(__fmul_rn(cb, n_lm), taper2);
    float sn, cs;
    sincosf(phase, &sn, &cs);
    const float2 y = buf[j * N + r];
    const size_t off = plane + static_cast<size_t>(r) * N + c;
    img[off] = __fsub_rn(__fadd_rn(img[off], __fmul_rn(y.x, __fmul_rn(cs, common))),
                         __fmul_rn(y.y, __fmul_rn(sn, common)));
  }
}

// ---------------------------------------------------------------------------
// K6 -- replaces katsdpimager_tpu/ops/pallas_fft.py:_make_pre_col_kernel
// (pass A of image_to_grid_fused_parts) and the XLA transpose after it.
//
// From the TRANSPOSED real model image imgT, per element (r, c):
//     layer = img * (cb / (taper[r] taper[c] * n)) * exp(-2 pi i w (n - 1))
// with lm = (index - N/2) * pixel_size, n = sqrt(1 - lm_r^2 - lm_c^2),
// cb = (-1)^(r+c), computed in registers from the indices while the
// columns load; then the unnormalised FORWARD DFT of every column, stored
// transposed, so K7 again transforms columns.  The factors are symmetric
// in (r, c), so the transposed image takes the same formulas.  The
// prologue uses round-to-nearest intrinsics (no contracted multiply-add),
// so it rounds as the plain version does.  Bound like K3: the transform's
// shared-memory passes; the prologue adds no memory pass.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
pre_col_fft_kernel(const float* __restrict__ img,
                   const float2* __restrict__ tw,
                   const float* __restrict__ taper,
                   const float* __restrict__ scal, float* __restrict__ yr,
                   float* __restrict__ yi, int logN, int CB) {
  extern __shared__ float2 buf[];
  const int N = 1 << logN;
  const size_t plane = static_cast<size_t>(blockIdx.y) * N * N;
  const int c0 = blockIdx.x * CB;
  const float w = scal[0];
  const float ps = scal[1];
  const float half = 0.5f * static_cast<float>(N);
  const float m_two_pi_w = __fmul_rn(-6.28318530717958647692f, w);
  for (int e = threadIdx.x; e < N * CB; e += blockDim.x) {
    const int r = e / CB;
    const int j = e - r * CB;
    const int c = c0 + j;
    const float lm_r = __fmul_rn(__fsub_rn(static_cast<float>(r), half), ps);
    const float lm_c = __fmul_rn(__fsub_rn(static_cast<float>(c), half), ps);
    const float n_lm = sqrtf(__fsub_rn(__fsub_rn(1.0f, __fmul_rn(lm_r, lm_r)),
                                       __fmul_rn(lm_c, lm_c)));
    const float phase = __fmul_rn(m_two_pi_w, __fsub_rn(n_lm, 1.0f));
    const float cb = ((r + c) & 1) ? -1.0f : 1.0f;
    const float taper2 = __fmul_rn(taper[r], taper[c]);
    const float pre = __fmul_rn(img[plane + static_cast<size_t>(r) * N + c],
                                __fdiv_rn(cb, __fmul_rn(taper2, n_lm)));
    float sn, cs;
    sincosf(phase, &sn, &cs);
    buf[j * N + bitrev(r, logN)] =
        make_float2(__fmul_rn(pre, cs), __fmul_rn(pre, sn));
  }
  fft_columns(buf, logN, CB, tw, -1.0f);
  store_transposed(buf, yr, yi, plane, logN, CB, c0);
}

// ---------------------------------------------------------------------------
// K7 -- replaces katsdpimager_tpu/ops/pallas_fft.py:_make_cbout_col_kernel
// (pass B of image_to_grid_fused_parts).
//
// g[p, k', k] = (-1)^(k'+k) sum_c x[p, c, k] exp(-2 pi i c k' / N): the
// forward DFT of every column of K6's transposed output, times the output
// checkerboard, stored in place of its column, so the (P, N, N) grid
// planes come out the right way round (K5's input).  Bound like K3.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
cbout_col_fft_kernel(const float* __restrict__ xr,
                     const float* __restrict__ xi,
                     const float2* __restrict__ tw, float* __restrict__ yr,
                     float* __restrict__ yi, int logN, int CB) {
  extern __shared__ float2 buf[];
  const int N = 1 << logN;
  const size_t plane = static_cast<size_t>(blockIdx.y) * N * N;
  const int c0 = blockIdx.x * CB;
  load_columns(buf, xr + plane, xi + plane, logN, CB, c0, false);
  fft_columns(buf, logN, CB, tw, -1.0f);
  for (int e = threadIdx.x; e < N * CB; e += blockDim.x) {
    const int r = e / CB;
    const int j = e - r * CB;
    const int c = c0 + j;
    const size_t off = plane + static_cast<size_t>(r) * N + c;
    const float2 v = buf[j * N + r];
    const bool neg = (r + c) & 1;
    yr[off] = neg ? -v.x : v.x;
    yi[off] = neg ? -v.y : v.y;
  }
}

// ---------------------------------------------------------------------------
// K8 -- replaces katsdpimager_tpu/ops/pallas_fft.py:_make_col_kernel
// (col_fft, driven twice by fft2_pallas).
//
// y[b, k, c] = sum_r x[b, r, c] exp(sgn 2 pi i r k / N): the plain
// unnormalised DFT of every column of a (B, N, M) plane pair, sgn = -1
// forward, +1 inverse, stored in natural orientation.
//
// What bounds it on this card: device memory, one read and one write of
// both planes (268 MB at (1, 4096, 4096): 0.080 ms at 3.35 TB/s); the
// 5 N log2 N flops per column are about a percent of the FP32 rate.
//
// Design (col_fft_tile.cuh): a cluster of Q CTAs per 16-column tile and
// batch, N = Q R; each CTA reads its R rows q + Q r2 once (64-byte row
// segments), does the length-R DFT as two register-resident radix passes
// with one shared-memory exchange, and after a cluster barrier finishes a
// length-Q DFT over the cluster's shared memory, writing each output once.
// A ragged last tile loads zeros and stores nothing past M.
// ---------------------------------------------------------------------------

template <int R, int R1, int R2, int Q>
__global__ void __launch_bounds__(col_fft_tile::Tile<R, R1, R2, Q>::kThreads,
                                  col_fft_tile::Tile<R, R1, R2, Q>::kMinBlocks)
col_fft_k8_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float2* __restrict__ tw, float* __restrict__ yr,
                  float* __restrict__ yi, int N, int M, float sgn) {
  extern __shared__ float2 k8_buf[];
  const size_t plane = static_cast<size_t>(blockIdx.z) * N * M;
  col_fft_tile::col_fft_tile<R, R1, R2, Q>(
      k8_buf, xr + plane, xi + plane, tw, yr + plane, yi + plane, N, M,
      Q == 1 ? 0 : static_cast<int>(blockIdx.x),
      static_cast<int>(blockIdx.y) * col_fft_tile::kCols, sgn);
}

template <int R, int R1, int R2, int Q>
cudaError_t launch_col_fft_k8(const float* xr, const float* xi,
                              const float2* tw, float* yr, float* yi, int B,
                              int N, int M, float sgn, cudaStream_t stream) {
  using T = col_fft_tile::Tile<R, R1, R2, Q>;
  auto kernel = col_fft_k8_kernel<R, R1, R2, Q>;
  const int tiles = (M + col_fft_tile::kCols - 1) / col_fft_tile::kCols;
  if (tiles > 65535 || B > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q, tiles, B);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = Q > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, xr, xi, tw, yr, yi, N, M, sgn);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int log2_exact(int N) {
  int l = 0;
  while ((1 << l) < N) ++l;
  return (1 << l) == N ? l : -1;
}

// Columns per CTA: CB * N complex values fill 64 KB of shared memory.
int columns_per_block(int N) { return N >= kSmemComplex ? 1 : kSmemComplex / N; }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int N, int P, int* logN, int* CB,
                    int* smem) {
  *logN = log2_exact(N);
  if (*logN < 8 || *logN > 13 || P <= 0) return cudaErrorInvalidValue;
  *CB = columns_per_block(N);
  *smem = *CB * N * static_cast<int>(sizeof(float2));
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

}  // namespace

extern "C" int ktt_cb_col_fft(const void* xr, const void* xi, const void* tw,
                              void* yr, void* yi, int P, int N,
                              void* stream) {
  int logN, CB, smem;
  cudaError_t err = prepare(cb_col_fft_kernel, N, P, &logN, &CB, &smem);
  if (err != cudaSuccess) return err;
  cb_col_fft_kernel<<<dim3(N / CB, P), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float2*>(tw), static_cast<float*>(yr),
      static_cast<float*>(yi), logN, CB);
  return cudaGetLastError();
}

extern "C" int ktt_epi_col_fft(const void* xr, const void* xi, const void* tw,
                               const void* taper, const void* scal,
                               void* imgT, int P, int N, void* stream) {
  int logN, CB, smem;
  cudaError_t err = prepare(epi_col_fft_kernel, N, P, &logN, &CB, &smem);
  if (err != cudaSuccess) return err;
  epi_col_fft_kernel<<<dim3(N / CB, P), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float2*>(tw), static_cast<const float*>(taper),
      static_cast<const float*>(scal), static_cast<float*>(imgT), logN, CB);
  return cudaGetLastError();
}

extern "C" int ktt_pre_col_fft(const void* imgT, const void* tw,
                               const void* taper, const void* scal, void* yr,
                               void* yi, int P, int N, void* stream) {
  int logN, CB, smem;
  cudaError_t err = prepare(pre_col_fft_kernel, N, P, &logN, &CB, &smem);
  if (err != cudaSuccess) return err;
  pre_col_fft_kernel<<<dim3(N / CB, P), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgT), static_cast<const float2*>(tw),
      static_cast<const float*>(taper), static_cast<const float*>(scal),
      static_cast<float*>(yr), static_cast<float*>(yi), logN, CB);
  return cudaGetLastError();
}

// tw: exp(+2 pi i k / N) for k < N (the full circle; the radix-2 kernels
// take the half).
extern "C" int ktt_col_fft(const void* xr, const void* xi, const void* tw,
                           void* yr, void* yi, int B, int N, int M, int sign,
                           void* stream) {
  if (M <= 0 || B <= 0 || (sign != 1 && sign != -1))
    return cudaErrorInvalidValue;
  auto x_r = static_cast<const float*>(xr);
  auto x_i = static_cast<const float*>(xi);
  auto t = static_cast<const float2*>(tw);
  auto y_r = static_cast<float*>(yr);
  auto y_i = static_cast<float*>(yi);
  auto st = static_cast<cudaStream_t>(stream);
  const float sgn = static_cast<float>(sign);
  switch (N) {
    case 256:
      return launch_col_fft_k8<256, 16, 16, 1>(
          x_r, x_i, t, y_r, y_i, B, N, M, sgn, st);
    case 512:
      return launch_col_fft_k8<512, 32, 16, 1>(
          x_r, x_i, t, y_r, y_i, B, N, M, sgn, st);
    case 1024:
      return launch_col_fft_k8<512, 32, 16, 2>(
          x_r, x_i, t, y_r, y_i, B, N, M, sgn, st);
    case 2048:
      return launch_col_fft_k8<512, 32, 16, 4>(
          x_r, x_i, t, y_r, y_i, B, N, M, sgn, st);
    case 4096:
      return launch_col_fft_k8<512, 32, 16, 8>(
          x_r, x_i, t, y_r, y_i, B, N, M, sgn, st);
    case 8192:
      return launch_col_fft_k8<1024, 32, 32, 8>(
          x_r, x_i, t, y_r, y_i, B, N, M, sgn, st);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int ktt_cbout_col_fft(const void* xr, const void* xi,
                                 const void* tw, void* yr, void* yi, int P,
                                 int N, void* stream) {
  int logN, CB, smem;
  cudaError_t err = prepare(cbout_col_fft_kernel, N, P, &logN, &CB, &smem);
  if (err != cudaSuccess) return err;
  cbout_col_fft_kernel<<<dim3(N / CB, P), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float2*>(tw), static_cast<float*>(yr),
      static_cast<float*>(yi), logN, CB);
  return cudaGetLastError();
}
