// Column-FFT tile core for Hopper (sm_90a): the transform of every column
// DFT of the port, K8, K3, K4, K6, K7 and K23 (csrc/fft.cu), which differ
// only in how a tile's values load (the `load` hook, and the optional
// per-value `prep` hook that runs after all of a thread's loads; K23's load
// reads the shared-memory slots in which the kernel has summed each value)
// and how its finished values store (the `store` hook below).
//
// The length-N transform of every column of a (N, M) plane pair is split
// four-step as N = Q * R, with row r = q + Q r2 (q < Q, r2 < R) and output
// k = k2 + R k1 (k2 < R, k1 < Q):
//
//   y[k2 + R k1] = sum_q w_Q^(q k1) [w_N^(q k2) sum_r2 x[q + Q r2] w_R^(r2 k2)]
//
// with w_L = exp(sgn 2 pi i / L).  One CTA of a cluster of Q CTAs holds the
// R rows q + Q r2 of a tile of kCols consecutive columns (R kCols complex
// values in shared memory), does the inner length-R DFT as two Stockham
// radix passes whose butterflies live in registers (one shared-memory
// exchange between them), and scales by w_N^(q k2).  After a cluster
// barrier, CTA p reads, for its R / Q values of k2, the Q partial sums from
// the Q CTAs' shared memory (distributed shared memory) and finishes with a
// length-Q DFT in registers, so every input is read once and every output
// written once, in one launch.
//
// Every thread holds kPerThread complex values in registers.  Tiles are
// kCols = 16 columns: a row segment of a plane is 64 bytes, two whole
// 32-byte sectors, and a warp covers two rows of a tile, so global loads
// and stores are coalesced and every shared-memory access is free of bank
// conflicts (rows of 16 float2; 8-byte accesses run as two half-warps).
// A transposed store (K3, K6) spreads the cluster's finish along k instead
// (Finish::kAlongK), or, with no cluster (Q = 1), stages the outputs in
// shared memory by column (column_slot); either way it writes runs of
// consecutive k.
//
// Twiddles are exp(+2 pi i k / N) computed in float64 and rounded to
// float32, conjugated for sgn = -1: those of the radix butterflies (k a
// multiple of N / 32) from a constant-memory copy, the others from the
// table in device memory (read through the read-only cache; within a warp
// the addresses are nearly all equal).  No fast-math; all arithmetic is
// FP32.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace col_fft_tile {

namespace cg = cooperative_groups;

constexpr int kCols = 16;       // columns per tile
constexpr int kPerThread = 32;  // complex values each thread holds

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// exp(+2 pi i j / 32), j < 32: float64 values rounded to float32, the same
// numbers as the device table's at k = j N / 32.
__constant__ float2 kOmega32[32] = {
    {0x1.000000p+0f, 0x0.0p+0f}, {0x1.f6297cp-1f, 0x1.8f8b84p-3f},
    {0x1.d906bcp-1f, 0x1.87de2ap-2f}, {0x1.a9b662p-1f, 0x1.1c73b4p-1f},
    {0x1.6a09e6p-1f, 0x1.6a09e6p-1f}, {0x1.1c73b4p-1f, 0x1.a9b662p-1f},
    {0x1.87de2ap-2f, 0x1.d906bcp-1f}, {0x1.8f8b84p-3f, 0x1.f6297cp-1f},
    {0x1.1a6264p-54f, 0x1.000000p+0f}, {-0x1.8f8b84p-3f, 0x1.f6297cp-1f},
    {-0x1.87de2ap-2f, 0x1.d906bcp-1f}, {-0x1.1c73b4p-1f, 0x1.a9b662p-1f},
    {-0x1.6a09e6p-1f, 0x1.6a09e6p-1f}, {-0x1.a9b662p-1f, 0x1.1c73b4p-1f},
    {-0x1.d906bcp-1f, 0x1.87de2ap-2f}, {-0x1.f6297cp-1f, 0x1.8f8b84p-3f},
    {-0x1.000000p+0f, 0x1.1a6264p-53f}, {-0x1.f6297cp-1f, -0x1.8f8b84p-3f},
    {-0x1.d906bcp-1f, -0x1.87de2ap-2f}, {-0x1.a9b662p-1f, -0x1.1c73b4p-1f},
    {-0x1.6a09e6p-1f, -0x1.6a09e6p-1f}, {-0x1.1c73b4p-1f, -0x1.a9b662p-1f},
    {-0x1.87de2ap-2f, -0x1.d906bcp-1f}, {-0x1.8f8b84p-3f, -0x1.f6297cp-1f},
    {-0x1.a79394p-53f, -0x1.000000p+0f}, {0x1.8f8b84p-3f, -0x1.f6297cp-1f},
    {0x1.87de2ap-2f, -0x1.d906bcp-1f}, {0x1.1c73b4p-1f, -0x1.a9b662p-1f},
    {0x1.6a09e6p-1f, -0x1.6a09e6p-1f}, {0x1.a9b662p-1f, -0x1.1c73b4p-1f},
    {0x1.d906bcp-1f, -0x1.87de2ap-2f}, {0x1.f6297cp-1f, -0x1.8f8b84p-3f},
};

// exp(sgn 2 pi i k / N) from the table exp(+2 pi i k / N), k < N.
__device__ __forceinline__ float2 twiddle(const float2* __restrict__ tw,
                                          int k, float sgn) {
  const float2 t = __ldg(tw + k);
  return make_float2(t.x, sgn * t.y);
}

template <int RAD>
__device__ __forceinline__ constexpr int bit_reverse(int i) {
  int r = 0;
  for (int b = 1; b < RAD; b <<= 1) {
    r = (r << 1) | (i & 1);
    i >>= 1;
  }
  return r;
}

// In-register DFT of RAD values (RAD a power of two up to 32), natural
// order in and out: v[k] <- sum_i v[i] exp(sgn 2 pi i i k / RAD).  Radix-2
// decimation in time over a compile-time permutation; every index is a
// constant after unrolling, so v stays in registers and the twiddles are
// constant-memory operands.
template <int RAD>
__device__ __forceinline__ void dft_reg(float2 (&v)[RAD], float sgn) {
  static_assert(RAD <= 32 && (RAD & (RAD - 1)) == 0, "RAD: 2, 4, ..., 32");
#pragma unroll
  for (int i = 0; i < RAD; ++i) {
    const int r = bit_reverse<RAD>(i);
    if (r > i) {
      const float2 t = v[i];
      v[i] = v[r];
      v[r] = t;
    }
  }
#pragma unroll
  for (int h = 1; h < RAD; h <<= 1) {
#pragma unroll
    for (int j = 0; j < h; ++j) {
      const float2 o = kOmega32[j * (32 / (2 * h))];
      const float2 w = make_float2(o.x, sgn * o.y);
#pragma unroll
      for (int k = j; k < RAD; k += 2 * h) {
        const float2 t = j == 0 ? v[k + h] : cmul(w, v[k + h]);
        v[k + h] = make_float2(v[k].x - t.x, v[k].y - t.y);
        v[k] = make_float2(v[k].x + t.x, v[k].y + t.y);
      }
    }
  }
}

// The tile shape of one CTA: R rows, kCols columns, R1 * R2 = R, Q CTAs
// per cluster.  Threads = R kCols / kPerThread.
template <int R, int R1, int R2, int Q>
struct Tile {
  static_assert(R1 * R2 == R, "R = R1 R2");
  static_assert(R1 <= kPerThread && R2 <= kPerThread && Q <= kPerThread,
                "a radix above kPerThread");
  static constexpr int kThreads = R * kCols / kPerThread;
  static constexpr int kSmemBytes =
      R * kCols * static_cast<int>(sizeof(float2));
  // CTAs per SM that the launch bounds ask for: three of 256 threads (at
  // most 85 registers a thread), whose load, transform and store phases
  // overlap.
  static constexpr int kMinBlocks = kThreads >= 512 ? 1 : 768 / kThreads;
};

// A tile of R rows laid out by column in `buf`: value (k, c) at
// c R + (k ^ c).  The XOR swizzle keeps 16 columns at one k (a half-warp
// of pass 2) on 16 distinct float2 bank pairs, and 16 consecutive k of
// one column (a half-warp along k) in one contiguous 128-byte block.
template <int R>
__device__ __forceinline__ int column_slot(int k, int c) {
  return c * R + (k ^ c);
}

// How the cluster's finish (Q > 1) spreads a CTA's outputs over its
// threads.  kAlongC: a warp holds 16 columns of 2 consecutive k2, so row
// stores are 64-byte segments (K8, K4, K7); the partial sums are rows of
// `buf` (k2 kCols + c).  kAlongK: a warp holds 32 consecutive k2 of one
// column, so stores along k, as a transposed store makes them, are
// 128-byte runs (K3, K6); the partial sums are laid out by column
// (column_slot), so that a half-warp's reads of them, local or from
// another CTA, are one 128-byte block.
enum class Finish { kAlongC, kAlongK };

// The default per-value hook of col_fft_tile: the loaded value as it is.
struct NoPrep {
  __device__ __forceinline__ float2 operator()(int, int, float2 v) const {
    return v;
  }
};

// Pass 1 (radix R1, Stockham Ns = 1) from device memory: the thread's
// butterflies b = tid + u T take local rows j + i R / R1 of tile column
// c = b % kCols (j = b / kCols), that is plane rows q + Q (j + i R / R1),
// each from `load(row, c)`.  Only once all the thread's loads are in flight
// does `prep(row, c, value)` turn each loaded value into the DFT's input,
// so that work on a value (branches, calls) never stands between two
// loads.  The results go to `buf` at local rows j R1 + i.  Ends
// synchronised.
template <int R, int R1, int R2, int Q, typename Load, typename Prep>
__device__ __forceinline__ void pass1_from_global(float2* buf, int q,
                                                  float sgn, Load load,
                                                  Prep prep) {
  using T = Tile<R, R1, R2, Q>;
  constexpr int NB = kPerThread / R1;
  float2 v[NB][R1];
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int b = threadIdx.x + u * T::kThreads;
    const int c = b % kCols;
    const int j = b / kCols;
#pragma unroll
    for (int i = 0; i < R1; ++i) v[u][i] = load(q + Q * (j + i * (R / R1)), c);
  }
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int b = threadIdx.x + u * T::kThreads;
    const int c = b % kCols;
    const int j = b / kCols;
#pragma unroll
    for (int i = 0; i < R1; ++i)
      v[u][i] = prep(q + Q * (j + i * (R / R1)), c, v[u][i]);
    dft_reg<R1>(v[u], sgn);
#pragma unroll
    for (int i = 0; i < R1; ++i) buf[(j * R1 + i) * kCols + c] = v[u][i];
  }
  __syncthreads();
}

// Pass 2 (radix R2, Stockham Ns = R1, the last): local rows j + i R1 of
// `buf` (j < R1) in registers, twiddled by w_R^(j i), transformed.  The
// values v[u][i] are then the inner DFT at k2 = j + i R1 for column
// b % kCols; `emit(k2, c, value)` takes each one.  Reads, then
// synchronises, so `emit` may write `buf`.
template <int R, int R1, int R2, int Q, typename Emit>
__device__ __forceinline__ void pass2(float2* buf,
                                      const float2* __restrict__ tw, int N,
                                      float sgn, Emit emit) {
  using T = Tile<R, R1, R2, Q>;
  constexpr int NB = kPerThread / R2;
  float2 v[NB][R2];
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int b = threadIdx.x + u * T::kThreads;
    const int c = b % kCols;
    const int j = b / kCols;
#pragma unroll
    for (int i = 0; i < R2; ++i) v[u][i] = buf[(j + i * R1) * kCols + c];
  }
  __syncthreads();
  const int step = N / R;  // w_R^k = tw[k step]
#pragma unroll
  for (int u = 0; u < NB; ++u) {
    const int b = threadIdx.x + u * T::kThreads;
    const int c = b % kCols;
    const int j = b / kCols;
#pragma unroll
    for (int i = 1; i < R2; ++i)
      v[u][i] = cmul(twiddle(tw, j * i * step, sgn), v[u][i]);
    dft_reg<R2>(v[u], sgn);
#pragma unroll
    for (int i = 0; i < R2; ++i) emit(j + i * R1, c, v[u][i]);
  }
}

// The whole column DFT of one tile of kCols columns: `load(r, c)` fetches
// the value at plane row r (r < N) of tile column c (c < kCols), and
// `prep(r, c, value)` (the identity by default) makes it the input;
// `store(k2, c, y)` takes the outputs y[k1] at rows k2 + R k1 (k1 < Q) of
// tile column c, together, once for each k2 of this CTA: all k2 < R when
// Q = 1, else k2 in [q R / Q, (q + 1) R / Q).  `q` is the CTA's rank in
// its cluster of Q (0 when Q = 1).  When Q = 1 the hook may write `buf`
// (the caller synchronises the CTA before reading it).
template <int R, int R1, int R2, int Q, Finish kFinish = Finish::kAlongC,
          typename Load, typename Store, typename Prep = NoPrep>
__device__ __forceinline__ void col_fft_tile(float2* buf,
                                             const float2* __restrict__ tw,
                                             int N, int q, float sgn,
                                             Load load, Store store,
                                             Prep prep = Prep{}) {
  using T = Tile<R, R1, R2, Q>;
  pass1_from_global<R, R1, R2, Q>(buf, q, sgn, load, prep);
  if constexpr (Q == 1) {
    pass2<R, R1, R2, Q>(buf, tw, N, sgn, [&](int k2, int c, float2 y) {
      const float2 out[1] = {y};
      store(k2, c, out);
    });
  } else {
    constexpr int L = R / Q;
    constexpr bool kAlongK = kFinish == Finish::kAlongK;
    static_assert(!kAlongK || L % 32 == 0, "warps along k2");
    auto slot = [](int k2, int c) {
      return kAlongK ? column_slot<R>(k2, c) : k2 * kCols + c;
    };
    // Partial sums Z_q[k2] scaled by w_N^(q k2), back into buf.
    pass2<R, R1, R2, Q>(buf, tw, N, sgn, [&](int k2, int c, float2 z) {
      buf[slot(k2, c)] = q == 0 ? z : cmul(twiddle(tw, q * k2, sgn), z);
    });
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const float2* part[Q];
#pragma unroll
    for (int s = 0; s < Q; ++s) part[s] = cluster.map_shared_rank(buf, s);
#pragma unroll
    for (int u = 0; u < kPerThread / Q; ++u) {
      const int e = threadIdx.x + u * T::kThreads;
      const int c = kAlongK ? e / L : e % kCols;
      const int k2 = q * L + (kAlongK ? e % L : e / kCols);
      float2 z[Q];
#pragma unroll
      for (int s = 0; s < Q; ++s) z[s] = part[s][slot(k2, c)];
      dft_reg<Q>(z, sgn);
      store(k2, c, z);
    }
    cluster.sync();  // no CTA leaves while another reads its buf
  }
}

// Writes a tile staged in `buf` by column (column_slot; Q = 1, so from
// pass 2, whose warps hold 16 columns of 2 rows) transposed: column c to
// row c0 + c of the (M, N) output pair (yr, yi).  Each warp writes 32
// consecutive floats of each plane.  Call after the CTA has synchronised
// behind the staging writes.
template <int R, int R1, int R2>
__device__ __forceinline__ void store_staged_transposed(
    const float2* buf, float* __restrict__ yr, float* __restrict__ yi,
    int N, int c0) {
  using T = Tile<R, R1, R2, 1>;
#pragma unroll 4
  for (int e = threadIdx.x; e < R * kCols; e += T::kThreads) {
    const int c = e / R;
    const int k = e % R;
    const float2 v = buf[column_slot<R>(k, c)];
    const size_t off = static_cast<size_t>(c0 + c) * N + k;
    __stcs(yr + off, v.x);
    __stcs(yi + off, v.y);
  }
}

}  // namespace col_fft_tile
