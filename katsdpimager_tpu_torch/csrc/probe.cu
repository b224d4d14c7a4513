// Numerics probes P1 (A, B, C) and P2 (E, F) on Hopper (sm_90a): does a
// dot keep f32 exact?  Plain C interface, loaded with ctypes by
// katsdpimager_tpu_torch/ops/_build.py; the Python wrappers, the plain
// PyTorch versions and the probe data are in katsdpimager_tpu_torch/probes.py.
//
// Replaces the inline Pallas probes of scripts/mosaic_num_probe.py (A, B,
// C) and scripts/mosaic_num_probe2.py (E, F).  There the question was what
// Mosaic's MXU lowering does to f32 data; here it is what each route to a
// product on this card does:
//
// - A / F: one-hot selection through bf16 tensor cores (mma.sync
//   m16n8k16, f32 accumulation) from a table split three ways into bf16
//   (hi, mid, lo); A recombines (hi + mid) + lo in registers, F stores the
//   three selected thirds raw.  Exact: each output sums one bf16 value and
//   zeros in f32.
// - B: one-hot selection by an FP32 FMA dot.  Exact.
// - C: the stacked 2 x 2 band dot [a, b]^T [c, d] in FP32 FMA (the same
//   kernel runs the four separate blocks), and once more through TF32
//   tensor cores (mma.sync m16n8k8): FP32 rounds at 2^-24, TF32 keeps 10
//   mantissa bits, about 1e-3 relative.  This is the trap that the port's
//   rule "no f32 dot in TF32" guards against.
// - E: recombine (hi + mid) + lo with no dot.  Exact.
//
// Each kernel is tiny (256 x 384 at most); what bounds it is launch
// latency.  The fragment layouts follow the PTX ISA's mma.sync tables:
// lane = 4 g + t; A rows g and g + 8; B column g; C rows g and g + 8,
// columns 2 t and 2 t + 1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint16_t kBf16One = 0x3F80;

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ float bf16_to_f32(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

__device__ __forceinline__ void mma_bf16_m16n8k16(float d[4],
                                                  const uint32_t a[4],
                                                  const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32_m16n8k8(float d[4],
                                                 const uint32_t a[4],
                                                 const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// A (kRecombine) and F: sel = onehot(idx) @ [hi | mid | lo] in bf16 tensor
// cores with f32 accumulation.  tab is (W, 3L) bf16 bits; the one-hot
// (M, W) operand is built in registers from idx.  One warp per 16 x 8
// output tile: three accumulators, one per third, over W in steps of 16.
template <bool kRecombine>
__global__ void select_bf16_kernel(const int* __restrict__ idx,
                                   const uint16_t* __restrict__ tab,
                                   float* __restrict__ out, int W, int L) {
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = blockIdx.y * 16 + g;
  const int r1 = r0 + 8;
  const int n0 = blockIdx.x * 8;
  const int i0 = idx[r0];
  const int i1 = idx[r1];
  const size_t ld = 3 * static_cast<size_t>(L);
  float d[3][4] = {};
  for (int k0 = 0; k0 < W; k0 += 16) {
    auto hot = [&](int row_idx, int k) -> uint16_t {
      return row_idx == k ? kBf16One : 0;
    };
    const int ka = k0 + 2 * t;
    const uint32_t a[4] = {pack2(hot(i0, ka), hot(i0, ka + 1)),
                           pack2(hot(i1, ka), hot(i1, ka + 1)),
                           pack2(hot(i0, ka + 8), hot(i0, ka + 9)),
                           pack2(hot(i1, ka + 8), hot(i1, ka + 9))};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const uint16_t* col = tab + q * L + n0 + g;
      const uint32_t b[2] = {pack2(col[ka * ld], col[(ka + 1) * ld]),
                             pack2(col[(ka + 8) * ld], col[(ka + 9) * ld])};
      mma_bf16_m16n8k16(d[q], a, b);
    }
  }
  const int c = n0 + 2 * t;
  if (kRecombine) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int row = h < 2 ? r0 : r1;
      out[static_cast<size_t>(row) * L + c + (h & 1)] =
          (d[0][h] + d[1][h]) + d[2][h];
    }
  } else {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int row = h < 2 ? r0 : r1;
        out[row * ld + q * L + c + (h & 1)] = d[q][h];
      }
    }
  }
}

// B: out[m, l] = sum_k onehot(idx[m])[k] * table[k, l], FP32 FMA over W.
__global__ void select_f32_kernel(const int* __restrict__ idx,
                                  const float* __restrict__ table,
                                  float* __restrict__ out, int W, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y;
  if (l >= L) return;
  const int i = idx[m];
  float acc = 0.0f;
  for (int k = 0; k < W; ++k) {
    acc = fmaf(i == k ? 1.0f : 0.0f, table[static_cast<size_t>(k) * L + l],
               acc);
  }
  out[static_cast<size_t>(m) * L + l] = acc;
}

// C, FP32: out[i, j] = sum_m x[m, i] y[m, j] (x (Mk, I), y (Mk, J)), one
// thread per output, FP32 FMA in order of m.
__global__ void dot_f32_kernel(const float* __restrict__ x,
                               const float* __restrict__ y,
                               float* __restrict__ out, int Mk, int I, int J) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y;
  if (j >= J) return;
  float acc = 0.0f;
  for (int m = 0; m < Mk; ++m) {
    acc = fmaf(x[static_cast<size_t>(m) * I + i],
               y[static_cast<size_t>(m) * J + j], acc);
  }
  out[static_cast<size_t>(i) * J + j] = acc;
}

// C, TF32: the same product through TF32 tensor cores (inputs rounded to
// TF32 with cvt.rna, f32 accumulation).  One warp per 16 x 8 output tile,
// over Mk in steps of 8.
__global__ void dot_tf32_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                float* __restrict__ out, int Mk, int I,
                                int J) {
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int i0 = blockIdx.y * 16;
  const int j0 = blockIdx.x * 8;
  float d[4] = {};
  for (int k0 = 0; k0 < Mk; k0 += 8) {
    const size_t ka = static_cast<size_t>(k0 + t);
    const size_t kb = ka + 4;
    const uint32_t a[4] = {to_tf32(x[ka * I + i0 + g]),
                           to_tf32(x[ka * I + i0 + g + 8]),
                           to_tf32(x[kb * I + i0 + g]),
                           to_tf32(x[kb * I + i0 + g + 8])};
    const uint32_t b[2] = {to_tf32(y[ka * J + j0 + g]),
                           to_tf32(y[kb * J + j0 + g])};
    mma_tf32_m16n8k8(d, a, b);
  }
  const int c = j0 + 2 * t;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int row = i0 + g + (h < 2 ? 0 : 8);
    out[static_cast<size_t>(row) * J + c + (h & 1)] = d[h];
  }
}

// E: out[w, l] = (hi + mid) + lo from the (W, 3L) bf16 table, no dot.
__global__ void recombine_kernel(const uint16_t* __restrict__ tab,
                                 float* __restrict__ out, int W, int L) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = blockIdx.y;
  if (l >= L) return;
  const uint16_t* row = tab + static_cast<size_t>(w) * 3 * L;
  out[static_cast<size_t>(w) * L + l] =
      (bf16_to_f32(row[l]) + bf16_to_f32(row[L + l])) +
      bf16_to_f32(row[2 * L + l]);
}

}  // namespace

extern "C" int ktt_probe_select_bf16(const void* idx, const void* tab,
                                     void* out, int M, int W, int L,
                                     int recombine, void* stream) {
  if (M <= 0 || W <= 0 || L <= 0 || M % 16 || W % 16 || L % 8)
    return cudaErrorInvalidValue;
  const dim3 grid(L / 8, M / 16);
  auto st = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int*>(idx);
  auto t = static_cast<const uint16_t*>(tab);
  auto o = static_cast<float*>(out);
  if (recombine)
    select_bf16_kernel<true><<<grid, 32, 0, st>>>(i, t, o, W, L);
  else
    select_bf16_kernel<false><<<grid, 32, 0, st>>>(i, t, o, W, L);
  return cudaGetLastError();
}

extern "C" int ktt_probe_select_f32(const void* idx, const void* table,
                                    void* out, int M, int W, int L,
                                    void* stream) {
  if (M <= 0 || W <= 0 || L <= 0) return cudaErrorInvalidValue;
  select_f32_kernel<<<dim3((L + 127) / 128, M), 128, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const float*>(table),
      static_cast<float*>(out), W, L);
  return cudaGetLastError();
}

extern "C" int ktt_probe_dot_f32(const void* x, const void* y, void* out,
                                 int Mk, int I, int J, void* stream) {
  if (Mk <= 0 || I <= 0 || J <= 0) return cudaErrorInvalidValue;
  dot_f32_kernel<<<dim3((J + 127) / 128, I), 128, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), Mk, I, J);
  return cudaGetLastError();
}

extern "C" int ktt_probe_dot_tf32(const void* x, const void* y, void* out,
                                  int Mk, int I, int J, void* stream) {
  if (Mk <= 0 || I <= 0 || J <= 0 || Mk % 8 || I % 16 || J % 8)
    return cudaErrorInvalidValue;
  dot_tf32_kernel<<<dim3(J / 8, I / 16), 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), Mk, I, J);
  return cudaGetLastError();
}

extern "C" int ktt_probe_recombine(const void* tab, void* out, int W, int L,
                                   void* stream) {
  if (W <= 0 || L <= 0) return cudaErrorInvalidValue;
  recombine_kernel<<<dim3((L + 127) / 128, W), 128, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tab), static_cast<float*>(out), W, L);
  return cudaGetLastError();
}
