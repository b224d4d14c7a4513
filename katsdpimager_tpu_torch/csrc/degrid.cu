// Fused degridding kernel for Hopper (sm_90a): K5 (model prediction from
// the grid planes).  Plain C interface, loaded with ctypes by
// katsdpimager_tpu_torch/ops/_build.py; the Python wrapper, its prep and
// the plain PyTorch version are in ops/fused_degrid.py.
//
// ---------------------------------------------------------------------------
// K5 -- replaces katsdpimager_tpu/ops/pallas_gridder.py:_make_degrid_kernel
// (launched by degrid_chunks_fused).
//
// What it computes: for every visibility m of every occupied chunk c and
// every polarization p,
//     pred[c, m, p] = sum_j sum_k kv[m, j] * G[p, av + j, au + k] * ku[m, k]
// with the UNCONJUGATED taps kv[m, j] = tab[iv[m], j - sv[m]] (zero
// outside [0, K)), likewise ku, and (av, au) the chunk's window anchor.
// G is read as zero outside the (N, N) planes, which is what the JAX
// path's zero re-pad to dense_pad_size gave; the re-pad and its copy are
// gone.
//
// What bounds it on this card: FP32 FMA throughput.  Only the K x K cells of
// the window under a visibility's taps are touched (K^2 complex MACs per
// visibility and polarization, 3600 at K = 60), read from shared memory;
// the window load is (2 ts)^2 * 8 bytes per chunk and polarization from
// L2/HBM (128 KB at ts = 64), small beside the MACs.
//
// Design: one CTA per occupied chunk (chunks past n are not launched).
// One polarization's 2ts x 2ts window at a time sits in shared memory as
// interleaved re/im (128 KB at ts = 64 of the 227 KB a block may use).  A
// warp takes one visibility at a time: its lanes run along k (lane l owns
// k = l, l + 32, ...), keep their ku taps in registers, and for each tap
// row j accumulate kv[j] * sum_k G[j, k] ku[k] in FP32; a shuffle
// reduction across the warp ends the visibility.  The TPU kernel's bf16
// 3-way split table (an MXU workaround), its 128-lane win_eff column
// selection and its DMA double buffering do not carry over; the window is
// read at its exact column anchor, so no column-remainder case exists.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;  // 8 warps, one visibility each at a time
constexpr int kMaxTapsPerLane = 4;  // K <= 2 ts <= 128

__global__ void __launch_bounds__(kThreads)
degrid_planes_kernel(const float* __restrict__ gr,
                     const float* __restrict__ gi,
                     const int* __restrict__ av, const int* __restrict__ au,
                     const int* __restrict__ iu, const int* __restrict__ iv,
                     const int* __restrict__ su, const int* __restrict__ sv,
                     const float2* __restrict__ tab,
                     float2* __restrict__ pred, int Mc, int P, int N, int K,
                     int TS2) {
  extern __shared__ float2 win[];  // [TS2][TS2]
  const int c = blockIdx.x;
  const int r0 = av[c];
  const int q0 = au[c];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int p = 0; p < P; ++p) {
    __syncthreads();  // the previous polarization's window is consumed
    const size_t plane = static_cast<size_t>(p) * N * N;
    for (int e = threadIdx.x; e < TS2 * TS2; e += blockDim.x) {
      const int y = e / TS2;
      const int x = e - y * TS2;
      const int gy = r0 + y;
      const int gx = q0 + x;
      float2 v = make_float2(0.0f, 0.0f);
      if (gy < N && gx < N) {
        const size_t off = plane + static_cast<size_t>(gy) * N + gx;
        v = make_float2(gr[off], gi[off]);
      }
      win[e] = v;
    }
    __syncthreads();

    for (int m = warp; m < Mc; m += nwarps) {
      const size_t cm = static_cast<size_t>(c) * Mc + m;
      const float2* tu = tab + static_cast<size_t>(iu[cm]) * K;
      const float2* tv = tab + static_cast<size_t>(iv[cm]) * K;
      const float2* rows = win + sv[cm] * TS2 + su[cm];
      float2 ku[kMaxTapsPerLane];
#pragma unroll
      for (int t = 0; t < kMaxTapsPerLane; ++t) {
        const int k = lane + 32 * t;
        ku[t] = k < K ? tu[k] : make_float2(0.0f, 0.0f);
      }
      float acc_r = 0.0f;
      float acc_i = 0.0f;
      for (int j = 0; j < K; ++j) {
        const float2* row = rows + j * TS2;
        float br = 0.0f;
        float bi = 0.0f;
#pragma unroll
        for (int t = 0; t < kMaxTapsPerLane; ++t) {
          const int k = lane + 32 * t;
          if (k < K) {
            const float2 g = row[k];
            br = fmaf(g.x, ku[t].x, br);
            br = fmaf(-g.y, ku[t].y, br);
            bi = fmaf(g.x, ku[t].y, bi);
            bi = fmaf(g.y, ku[t].x, bi);
          }
        }
        const float2 kv = tv[j];
        acc_r = fmaf(kv.x, br, acc_r);
        acc_r = fmaf(-kv.y, bi, acc_r);
        acc_i = fmaf(kv.x, bi, acc_i);
        acc_i = fmaf(kv.y, br, acc_i);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc_r += __shfl_xor_sync(0xffffffffu, acc_r, off);
        acc_i += __shfl_xor_sync(0xffffffffu, acc_i, off);
      }
      if (lane == 0) pred[cm * P + p] = make_float2(acc_r, acc_i);
    }
  }
}

}  // namespace

extern "C" int ktt_degrid_planes(const void* gr, const void* gi,
                                 const void* av, const void* au,
                                 const void* iu, const void* iv,
                                 const void* su, const void* sv,
                                 const void* tab, void* pred, int n, int Mc,
                                 int P, int N, int K, int TS2,
                                 void* stream) {
  if (n <= 0 || Mc <= 0 || P <= 0 || K <= 0 || K > 32 * kMaxTapsPerLane ||
      K > TS2)
    return cudaErrorInvalidValue;
  const int smem = TS2 * TS2 * static_cast<int>(sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      degrid_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  degrid_planes_kernel<<<n, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gr), static_cast<const float*>(gi),
      static_cast<const int*>(av), static_cast<const int*>(au),
      static_cast<const int*>(iu), static_cast<const int*>(iv),
      static_cast<const int*>(su), static_cast<const int*>(sv),
      static_cast<const float2*>(tab), static_cast<float2*>(pred), Mc, P, N,
      K, TS2);
  return cudaGetLastError();
}
