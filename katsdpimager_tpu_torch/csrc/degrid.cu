// Fused degridding kernel for Hopper (sm_90a): K5 (model prediction from
// the grid planes).  Plain C interface, loaded with ctypes by
// katsdpimager_tpu_torch/ops/_build.py; the shared-memory layout and its
// choice are in degrid_layout.h; the Python wrapper, its prep and the
// plain PyTorch version are in ops/fused_degrid.py.
//
// ---------------------------------------------------------------------------
// K5 -- replaces katsdpimager_tpu/ops/pallas_gridder.py:_make_degrid_kernel
// (launched by degrid_chunks_fused).
//
// What it computes: for the first count[c] slots m of every chunk c < n
// and every polarization p,
//     pred[c, m, p] = sum_j sum_k kv[m, j] * G[p, av + sv + j, au + su + k]
//                     * ku[m, k]
// with the UNCONJUGATED taps kv[m, j] = tab[iv[m], j], ku[m, k] =
// tab[iu[m], k] (j, k < K), (av, au) the chunk's window anchor and
// (sv, su) in [0, ts - 1] the slot's shift (the tile-aligned planner's
// invariant, degrid_taps).  The other slots of chunks < n are written as
// zero.  G is read as zero outside the (N, N) planes, which is what the
// JAX path's zero re-pad to dense_pad_size gave.
//
// What bounds it on this card: K^2 complex MACs per valid visibility and
// polarization, each reading one 8-byte window value from shared memory;
// the shared-memory rate (128 B/clk/SM) allows half the FP32 FMA rate, so
// shared memory, not FMA, is the ceiling.  The window traffic from
// L2/HBM, (K + ts - 1)^2 * 8 bytes per chunk and polarization at most,
// overlaps the MACs.
//
// Design:
// - One CTA of 8 warps per chunk (grid n), two per SM where the layout
//   fits.  A chunk with no valid slot writes zeros and leaves.  Only the
//   first count slots are read, staged in shared memory with the chunk's
//   footprint box [min sv, max sv + K) x [min su, max su + K), at most
//   (K + ts - 1)^2: there is no 2ts window, and no limit on ts.
// - A sliding row window.  The slots are sorted (counting sort in shared
//   memory) into groups of D consecutive row shifts; a group's tap rows
//   lie in E = ceil((D + K - 1) / D) blocks of D rows, held in a ring of
//   R = E + 1 blocks.  While the warps work on group g, the next block
//   is loaded into registers (16-byte loads of the re and im planes from
//   a column that is a multiple of 4, or 4-byte ones where N or the
//   anchor is not a multiple of 4; cells outside the planes are zero) and
//   stored, re and im interleaved, into the slot of block g - 1 once
//   group g is done.  One __syncthreads per group.  So every visibility
//   is one work item with all its rows present, and its taps are fetched
//   once, one item ahead.  Where the rows of K taps do not fit, the tap
//   rows are taken in passes of Kj <= 64 rows, each streaming its own
//   rows; the partial sums add up in shared memory.
// - The MAC loop: a warp per visibility.  Half-warp h takes half of the
//   tap rows, its lanes b along k (lane b: k = b + 16 t, t < T =
//   ceil(K / 16); ku in registers; lanes past K read column K - 1 against
//   a zero tap, so no branch); the kv taps of two rows are one 16-byte
//   broadcast from a per-warp row in shared memory; the rows are unrolled
//   by 4.  A half-warp reads 16 consecutive 8-byte values of one row: the
//   32 banks once, no conflicts.  Per row of a half-warp, T loads, 4 T
//   FMAs for the row sum and 4 for kv: at K = 60, 240 of 256 MAC slots
//   used.  The warp's sum is reduced by shuffles once per visibility.
// The TPU kernel's bf16 3-way split table (an MXU workaround), its
// 128-lane win_eff column selection and its (P, 2ts, 2ts) DMA double
// buffer do not carry over.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <cstddef>

#include "degrid_layout.h"

namespace {

using k5::kKvHalf;
using k5::kKvRow;
using k5::kThreads;
using k5::kVec;
using k5::kWarps;

// A warp's work item: one visibility in one pass of tap rows.
template <int T>
struct Item {
  int m, y0, col;  // slot; its first row in the pass, its first column
  float2 ku[T];    // lane b: ku[b + 16 t], zero past K
  float2 kv[2];    // lane l: kv rows l and l + 32 of the pass
};

template <int T>
__global__ void __launch_bounds__(kThreads, 2)
degrid_planes_kernel(const float* __restrict__ gr,
                     const float* __restrict__ gi,
                     const int* __restrict__ av, const int* __restrict__ au,
                     const int* __restrict__ count,
                     const int* __restrict__ iu, const int* __restrict__ iv,
                     const int* __restrict__ su, const int* __restrict__ sv,
                     const float2* __restrict__ tab,
                     float2* __restrict__ pred, int Mc, int P, int N, int K,
                     int ts, int S, int D, int R, int Kj) {
  extern __shared__ float4 smem_raw[];
  float2* ring = reinterpret_cast<float2*>(smem_raw);  // [R * D][S]
  float2* kvs = ring + static_cast<size_t>(R) * D * S;  // [kWarps][68]
  float2* acc = kvs + kWarps * kKvRow;                  // [Mc][P]
  int* siu = reinterpret_cast<int*>(acc + static_cast<size_t>(Mc) * P);
  int* siv = siu + Mc;
  int* ssu = siv + Mc;
  int* ssv = ssu + Mc;
  int* order = ssv + Mc;     // slots sorted by group
  int* gstart = order + Mc;  // group starts in order, then the cursors
  int* gcur = gstart + (ts + D - 1) / D + 1;
  __shared__ int box[4];  // min sv, max sv, min su, max su

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float2* out = pred + static_cast<size_t>(c) * Mc * P;
  const int cnt = min(count[c], Mc);
  if (cnt <= 0) {
    for (int e = tid; e < Mc * P; e += kThreads)
      out[e] = make_float2(0.0f, 0.0f);
    return;
  }

  // ---- slot metadata, accumulators, and the chunk's footprint box
  if (tid == 0) {
    box[0] = 0x7fffffff;
    box[1] = -1;
    box[2] = 0x7fffffff;
    box[3] = -1;
  }
  __syncthreads();
  {
    int lo_v = 0x7fffffff, hi_v = -1, lo_u = 0x7fffffff, hi_u = -1;
    const size_t base = static_cast<size_t>(c) * Mc;
    for (int m = tid; m < cnt; m += kThreads) {
      const int u = su[base + m];
      const int v = sv[base + m];
      siu[m] = iu[base + m];
      siv[m] = iv[base + m];
      ssu[m] = u;
      ssv[m] = v;
      lo_v = min(lo_v, v);
      hi_v = max(hi_v, v);
      lo_u = min(lo_u, u);
      hi_u = max(hi_u, u);
    }
    for (int e = tid; e < cnt * P; e += kThreads)
      acc[e] = make_float2(0.0f, 0.0f);
    lo_v = __reduce_min_sync(0xffffffffu, lo_v);
    hi_v = __reduce_max_sync(0xffffffffu, hi_v);
    lo_u = __reduce_min_sync(0xffffffffu, lo_u);
    hi_u = __reduce_max_sync(0xffffffffu, hi_u);
    if (lane == 0) {
      atomicMin(&box[0], lo_v);
      atomicMax(&box[1], hi_v);
      atomicMin(&box[2], lo_u);
      atomicMax(&box[3], hi_u);
    }
  }
  __syncthreads();
  const int rlo = box[0];
  const int span = box[1] - rlo;  // row shifts lie in [rlo, rlo + span]
  const int clo = box[2] & ~3;    // columns from a multiple of 4
  // shifts < ts: at most K + ts + 2 columns, rounded up to 4: <= S
  const int ncols = min((box[3] + K - clo + 3) & ~3, S);
  const int ng = span / D + 1;    // groups of D row shifts

  // ---- counting sort of the slots by group (sv - rlo) / D
  for (int g = tid; g < ng; g += kThreads) gcur[g] = 0;
  __syncthreads();
  for (int m = tid; m < cnt; m += kThreads)
    atomicAdd(&gcur[(ssv[m] - rlo) / D], 1);
  __syncthreads();
  if (tid == 0) {
    int sum = 0;
    for (int g = 0; g < ng; ++g) {
      const int n_g = gcur[g];
      gstart[g] = gcur[g] = sum;
      sum += n_g;
    }
    gstart[ng] = sum;
  }
  __syncthreads();
  for (int m = tid; m < cnt; m += kThreads)
    order[atomicAdd(&gcur[(ssv[m] - rlo) / D], 1)] = m;

  const int RD = R * D;
  const int r0 = av[c];
  const int q0 = au[c];
  const size_t plane = static_cast<size_t>(N) * N;
  const int half = lane >> 4;
  const int b = lane & 15;
  float2* kvw = kvs + warp * kKvRow;
  const int npass = (K + Kj - 1) / Kj;

  for (int p = 0; p < P; ++p) {
    const float* pr = gr + p * plane;
    const float* pi = gi + p * plane;
    for (int h = 0; h < npass; ++h) {
      const int j0 = h * Kj;            // the pass's first tap row
      const int kh = min(Kj, K - j0);   // and its number of tap rows
      const int E = (D + kh - 1 + D - 1) / D;  // blocks a group needs
      const int nrows = span + kh;      // rows of the pass
      const int nblk = (nrows + D - 1) / D;
      // Pass row y is grid row av + rlo + j0 + y, kept in ring row
      // y mod RD; block q holds rows [qD, qD + D).  Its re and im values
      // stage in registers between load_block and store_block.
      const bool vec = (N % 4 == 0) && (q0 % 4 == 0);  // 16-byte loads align
      const int nv = ncols >> 2;  // 16-byte loads per row
      float4 vre[kVec], vim[kVec];
      auto load_block = [&](int q) {
        if (!vec || q >= nblk) return;
        const int rows = min(D, nrows - q * D);
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const int v = tid + kThreads * u;
          vre[u] = vim[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (v < rows * nv) {
            const int y = v / nv;
            const int gy = r0 + rlo + j0 + q * D + y;
            const int gx = q0 + clo + (v - y * nv) * 4;
            if (gy < N && gx < N) {  // N % 4 == 0: all four or none
              const size_t off = static_cast<size_t>(gy) * N + gx;
              vre[u] = *reinterpret_cast<const float4*>(pr + off);
              vim[u] = *reinterpret_cast<const float4*>(pi + off);
            }
          }
        }
      };
      auto store_block = [&](int q) {
        if (q >= nblk) return;
        const int rows = min(D, nrows - q * D);
        float2* dst = ring + static_cast<size_t>(q % R) * D * S;
        if (vec) {
#pragma unroll
          for (int u = 0; u < kVec; ++u) {
            const int v = tid + kThreads * u;
            if (v < rows * nv) {
              const int y = v / nv;
              float4* d =
                  reinterpret_cast<float4*>(dst + y * S + (v - y * nv) * 4);
              d[0] = make_float4(vre[u].x, vim[u].x, vre[u].y, vim[u].y);
              d[1] = make_float4(vre[u].z, vim[u].z, vre[u].w, vim[u].w);
            }
          }
        } else {
          for (int y = warp; y < rows; y += kWarps) {
            const int gy = r0 + rlo + j0 + q * D + y;
            for (int x = lane; x < ncols; x += 32) {
              const int gx = q0 + clo + x;
              float2 g2 = make_float2(0.0f, 0.0f);
              if (gy < N && gx < N) {
                const size_t off = static_cast<size_t>(gy) * N + gx;
                g2 = make_float2(pr[off], pi[off]);
              }
              dst[y * S + x] = g2;
            }
          }
        }
      };
      auto fetch = [&](Item<T>& it, int m) {
        it.m = m;
        it.y0 = ssv[m] - rlo;
        it.col = ssu[m] - clo;
        const float2* tu = tab + static_cast<size_t>(siu[m]) * K;
        const float2* tv = tab + static_cast<size_t>(siv[m]) * K + j0;
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int k = b + 16 * t;
          it.ku[t] = k < K ? tu[k] : make_float2(0.0f, 0.0f);
        }
        it.kv[0] = lane < kh ? tv[lane] : make_float2(0.0f, 0.0f);
        it.kv[1] = lane + 32 < kh ? tv[lane + 32] : make_float2(0.0f, 0.0f);
      };

      __syncthreads();  // the sort is done; the last pass's ring is consumed
      for (int q = 0; q < E; ++q) {
        load_block(q);
        store_block(q);
      }
      load_block(E);
      const int hrows = (kh + 1) >> 1;     // tap rows per half-warp
      const int jr = half * hrows;         // this half's first
      const int nr = min(hrows, kh - jr);  // and its count
      for (int g = 0; g < ng; ++g) {
        __syncthreads();  // blocks g .. g + E - 1 stored; group g - 1 done

        const int end = gstart[g + 1];
        Item<T> cur, nxt;
        int i = gstart[g] + warp;
        if (i < end) fetch(cur, order[i]);
        while (i < end) {
          const int in = i + kWarps;
          if (in < end) fetch(nxt, order[in]);
          // The kv taps: tap row j at j (half 0) or kKvHalf + j - hrows.
          __syncwarp();  // the previous item's kv rows are consumed
          {
            const int j1 = lane + 32;
            if (lane < kh)
              kvw[lane < hrows ? lane : kKvHalf + lane - hrows] = cur.kv[0];
            if (j1 < kh)
              kvw[j1 < hrows ? j1 : kKvHalf + j1 - hrows] = cur.kv[1];
          }
          __syncwarp();
          int idx = (cur.y0 + jr) % RD;
          float acc_r = 0.0f;
          float acc_i = 0.0f;
          const float2* kvh = kvw + half * kKvHalf;
          // One tap row: b = sum_k G[row, k] ku[k] over the lane's k, then
          // acc += kv * b.
          auto tap_row = [&](int ridx, float2 kv) {
            const float2* row =
                ring + static_cast<size_t>(ridx) * S + cur.col;
            float br = 0.0f;
            float bi = 0.0f;
#pragma unroll
            for (int t = 0; t < T; ++t) {
              const float2 g2 = row[min(b + 16 * t, K - 1)];
              br = fmaf(g2.x, cur.ku[t].x, br);
              br = fmaf(-g2.y, cur.ku[t].y, br);
              bi = fmaf(g2.x, cur.ku[t].y, bi);
              bi = fmaf(g2.y, cur.ku[t].x, bi);
            }
            acc_r = fmaf(kv.x, br, acc_r);
            acc_r = fmaf(-kv.y, bi, acc_r);
            acc_i = fmaf(kv.x, bi, acc_i);
            acc_i = fmaf(kv.y, br, acc_i);
          };
          int r = 0;
#pragma unroll 2
          for (; r + 1 < nr; r += 2) {  // two rows, one kv broadcast
            const float4 kv2 = *reinterpret_cast<const float4*>(kvh + r);
            int idx1 = idx + 1;
            if (idx1 == RD) idx1 = 0;
            tap_row(idx, make_float2(kv2.x, kv2.y));
            tap_row(idx1, make_float2(kv2.z, kv2.w));
            idx = idx1 + 1;
            if (idx == RD) idx = 0;
          }
          if (r < nr) tap_row(idx, kvh[r]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            acc_r += __shfl_xor_sync(0xffffffffu, acc_r, off);
            acc_i += __shfl_xor_sync(0xffffffffu, acc_i, off);
          }
          if (lane == 0) {
            float2* a = acc + cur.m * P + p;
            a->x += acc_r;
            a->y += acc_i;
          }
          i = in;
          cur = nxt;
        }
        store_block(g + E);     // into the slot of block g - 1
        load_block(g + E + 1);  // in flight through group g + 1
      }
    }
  }
  __syncthreads();  // every pass of every polarization is summed
  for (int e = tid; e < Mc * P; e += kThreads)
    out[e] = e < cnt * P ? acc[e] : make_float2(0.0f, 0.0f);
}

template <int T>
cudaError_t launch(const void* gr, const void* gi, const void* av,
                   const void* au, const void* count, const void* iu,
                   const void* iv, const void* su, const void* sv,
                   const void* tab, void* pred, int n, int Mc, int P, int N,
                   int K, int ts, const k5::Layout& l, cudaStream_t stream) {
  const int smem = static_cast<int>(l.smem);
  cudaError_t err = cudaFuncSetAttribute(
      degrid_planes_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  degrid_planes_kernel<T><<<n, kThreads, smem, stream>>>(
      static_cast<const float*>(gr), static_cast<const float*>(gi),
      static_cast<const int*>(av), static_cast<const int*>(au),
      static_cast<const int*>(count), static_cast<const int*>(iu),
      static_cast<const int*>(iv), static_cast<const int*>(su),
      static_cast<const int*>(sv), static_cast<const float2*>(tab),
      static_cast<float2*>(pred), Mc, P, N, K, ts, l.S, l.D, l.R, l.Kj);
  return cudaGetLastError();
}

}  // namespace

// K5: pred (NC, Mc, P) complex64 for chunks < n (the caller zeroes the
// rest), with the layout of k5::choose_layout; cudaErrorInvalidValue
// where none fits (K > ts + 1, K > 256, or the slot accumulators and the
// ring beyond a CUDA block's shared memory).
extern "C" int ktt_degrid_planes(const void* gr, const void* gi,
                                 const void* av, const void* au,
                                 const void* count, const void* iu,
                                 const void* iv, const void* su,
                                 const void* sv, const void* tab, void* pred,
                                 int n, int Mc, int P, int N, int K, int ts,
                                 void* stream) {
  k5::Layout l;
  if (n <= 0 || !k5::choose_layout(ts, K, Mc, P, &l))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K5_CASE(TAPS)                                                      \
  return launch<TAPS>(gr, gi, av, au, count, iu, iv, su, sv, tab, pred, n, \
                      Mc, P, N, K, ts, l, st)
  switch ((K + 15) / 16) {  // taps per lane
    case 1: K5_CASE(1);
    case 2: K5_CASE(2);
    case 3: K5_CASE(3);
    case 4: K5_CASE(4);
    case 5: K5_CASE(5);
    case 6: K5_CASE(6);
    case 7: K5_CASE(7);
    case 8: K5_CASE(8);
    case 9: case 10: case 11: case 12: K5_CASE(12);
    default: K5_CASE(16);
  }
#undef K5_CASE
}
