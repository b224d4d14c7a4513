// The imaging weight grid for Hopper (sm_90a): each channel's statistical
// weights summed into UV cells, the grid that uniform and robust weights
// divide by.  Plain C interface, loaded with ctypes by
// katsdpimager_tpu_torch/ops/_build.py; the Python wrapper and the plain
// PyTorch version are parallel/multichannel.py's weight_grid and
// weight_grid_plain.
//
// ---------------------------------------------------------------------------
// Replaces no TPU kernel: the JAX package sums the weights with an XLA
// scatter-add (katsdpimager_tpu/parallel/multichannel.py, the inline
// `.at[...].add`).  Added because PyTorch's index_put_(accumulate=True) over
// every slot of the chunk layout sent the ~6.3 M padding slots of a
// channel, all at uv (0, 0), through one thread as one run: 0.74 s a
// channel on an H100.
//
// What it computes: for every polarization p and cell (row, col) of the
// (P, N, N) grid,
//     out[p, row, col] = sum of weights[s, c, m, p]
// over the valid slots (valid[s, c, m]) whose uv lies on the cell
// (row = v + N/2, col = u + N/2), folded in slot order (slice, chunk,
// slot) from 0: the float32 sum a serial loop over the slots gives.  Every
// cell of the grid is written once, zeros included; slots outside the
// grid are dropped.
//
// What it relies on, the tile-aligned planner's invariants
// (ops/mxu_gridder.plan_chunks_tiled, held by
// tests/test_torch_weight_grid.py): each slice's occupied chunks come
// first, sorted by their tile key tv * ntu + tu (anchor = (tv ts, tu ts),
// ntu = ceil(N / ts) + 1), and hold their valid slots as a prefix; a
// valid slot's cell lies inside its chunk's window, rows
// [tv ts + kb, tv ts + kb + ts) and the same columns (kb = (K - 1) / 2,
// as fused_gridder.samples reads the density back).  A valid slot outside
// its window never comes from the planner; were one given, no CTA would
// count it.
//
// What bounds it on this card: bytes.  It reads each valid slot's uv and
// P weights once (12 B at P = 1) and the valid flags of the chunks it
// walks, a few probes of the anchors per CTA and slice, and writes the
// P N^2 grid once: at the production channel (2.1 M valid slots, 4096 px)
// ~25 MB read and 64 MB written.  Between them stand latencies: a CTA
// walks its tile's chunks one after another.
//
// Design ("owner tiles"):
// - The windows of all tiles partition the plane.  A CTA owns one tile's
//   window, or a part of it of at most 64 x 64 cells where ts > 64, for
//   all P planes, in shared memory.  CTAs over the tiles whose windows
//   meet the grid write every cell: no separate zero fill.
// - Per slice, two warps find where the CTA's tile's run of chunks starts
//   and ends on the device, each a search of 32 probes a round over the
//   slice's tile keys (padding chunks, whose first slot is not valid,
//   sort last).  No host value is read.
// - The CTA takes the runs' chunks in order, a thread a slot (Mc <= 256):
//   each thread loads its slot's valid flag, then, where valid, its uv and
//   weights, one chunk ahead of the one the warps add up, and puts its
//   local cell key (-1 outside the region) and weights in shared memory.
// - Each warp owns the region's cells whose key is its number mod 8.  A
//   stable partition of the chunk's slots by owner (ballots within each
//   warp, a scan of the 8 x 8 counts by one warp) gives each owner the
//   list of its slots in slot order; so a warp reads ~1/8 of the slots,
//   not all of them (reading all of them took the kernel 1.5x the time at
//   the production channel on an H100).
// - A warp reads its list 32 slots at a time.  Lanes on one cell find
//   each other with __match_any_sync; the lowest of them adds its peers'
//   weights to the cell in lane order.  So each cell has one writer,
//   which adds its slots in slot order: no atomics, no order that changes
//   between runs, and the result is bitwise the serial fold.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

// One slot of a chunk a thread.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The side of the largest region a CTA owns.
constexpr int kRegion = 64;
constexpr int kMaxPols = 4;

// The planner's sort key of chunk c of a slice; padding chunks sort last.
__device__ __forceinline__ long long tile_key(const int2* anchor,
                                              const unsigned char* valid,
                                              int c, int Mc, int ts,
                                              int ntu) {
  const int2 a = anchor[c];
  if (!valid[static_cast<size_t>(c) * Mc]) return LLONG_MAX;
  return static_cast<long long>(a.x / ts) * ntu + a.y / ts;
}

// The first chunk c in [0, nc) whose key is at least target (nc if none),
// by one warp: each round 32 probes cut the interval that holds it.
__device__ int first_chunk(const int2* anchor, const unsigned char* valid,
                           int nc, int Mc, long long target, int ts, int ntu,
                           int lane) {
  int lo = 0, hi = nc;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + lane * step;
    const bool ge = probe >= hi ||
                    tile_key(anchor, valid, probe, Mc, ts, ntu) >= target;
    const unsigned ball = __ballot_sync(0xffffffffu, ge);
    if (ball == 0u) {
      lo += 31 * step + 1;
    } else {
      const int j = __ffs(ball) - 1;
      if (j == 0) {
        hi = lo;
      } else {
        const int next = lo + (j - 1) * step + 1;
        hi = min(hi, lo + j * step);
        lo = next;
      }
    }
  }
  return lo;
}

// The CTA's next chunk (s, c) of the runs [first[s], end[s]); false past
// the last.
__device__ __forceinline__ bool advance(int& s, int& c, const int* first,
                                        const int* end, int S) {
  ++c;
  while (s < S && c >= end[s]) {
    ++s;
    if (s < S) c = first[s];
  }
  return s < S;
}

// A thread's slot of one chunk, as loaded.
struct Slot {
  int2 anchor;
  int2 uv;
  float w[kMaxPols];
  bool valid;
};

__device__ __forceinline__ Slot load_slot(const int2* uv, const float* weights,
                                          const int2* anchor,
                                          const unsigned char* valid,
                                          size_t chunk, int Mc, int P,
                                          int t) {
  Slot x;
  x.anchor = anchor[chunk];
  const size_t m = chunk * Mc + t;
  x.valid = t < Mc && valid[m];
  x.uv = make_int2(0, 0);
  for (int p = 0; p < kMaxPols; ++p) x.w[p] = 0.0f;
  if (x.valid) {
    x.uv = uv[m];
    for (int p = 0; p < kMaxPols; ++p)
      if (p < P) x.w[p] = weights[m * P + p];
  }
  return x;
}

// Grid (nt nsub, nt nsub): blockIdx.x the column tile and part, .y the row
// tile and part; tiles t_min .. t_min + nt - 1 in each direction.
__global__ void __launch_bounds__(kThreads)
    weight_grid_kernel(const int2* __restrict__ uv,
                       const float* __restrict__ weights,
                       const int2* __restrict__ anchor,
                       const unsigned char* __restrict__ valid,
                       float* __restrict__ out, int S, int NC, int Mc, int P,
                       int N, int ts, int kb, int t_min, int nsub, int ntu) {
  extern __shared__ float smem[];
  const int side = min(ts, kRegion);
  // The region; the runs' bounds; per chunk each slot's cell key and
  // weights, and the owners' lists: cnt[w][v] slots of warp w that owner
  // v takes, start[w][v] where they go in order[] (owner v's list from
  // start[0][v]), total[v] the length of v's list.
  float* region = smem;                                  // (P, rv, ru)
  int* first = reinterpret_cast<int*>(smem + P * side * side);  // (S,)
  int* end = first + S;                                  // (S,)
  int* skey = end + S;                                   // (kThreads,)
  int* order = skey + kThreads;                          // (kThreads,)
  int* cnt = order + kThreads;                           // (kWarps^2,)
  int* start = cnt + kWarps * kWarps;                    // (kWarps^2,)
  int* total = start + kWarps * kWarps;                  // (kWarps,)
  float* sw = reinterpret_cast<float*>(total + kWarps);  // (kThreads, P)
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  const int tu = t_min + static_cast<int>(blockIdx.x) / nsub;
  const int tv = t_min + static_cast<int>(blockIdx.y) / nsub;
  const int pu = static_cast<int>(blockIdx.x) % nsub;
  const int pv = static_cast<int>(blockIdx.y) % nsub;
  const int r0 = tv * ts + kb + pv * kRegion;  // the region's first cell
  const int c0 = tu * ts + kb + pu * kRegion;
  const int rv = min(kRegion, ts - pv * kRegion);
  const int ru = min(kRegion, ts - pu * kRegion);
  const int cells = rv * ru;
  // The region's rows and columns inside the grid.
  const int lr0 = max(0, -r0), lr1 = min(rv, N - r0);
  const int lc0 = max(0, -c0), lc1 = min(ru, N - c0);
  const int half = N / 2;
  const long long target = static_cast<long long>(tv) * ntu + tu;

  for (int i = t; i < P * cells; i += kThreads) region[i] = 0.0f;
  for (int j = warp; j < 2 * S; j += kWarps) {
    const int s = j >> 1;
    const size_t base = static_cast<size_t>(s) * NC;
    const int f = first_chunk(anchor + base, valid + base * Mc, NC, Mc,
                              target + (j & 1), ts, ntu, lane);
    if (lane == 0) ((j & 1) ? end : first)[s] = f;
  }
  __syncthreads();

  int s = 0, c = (S > 0 ? first[0] : 0) - 1;
  bool have = advance(s, c, first, end, S);
  Slot x;
  if (have)
    x = load_slot(uv, weights, anchor, valid, static_cast<size_t>(s) * NC + c,
                  Mc, P, t);
  while (have) {
    int key = -1;
    // Tiles outside the grid can share a key with one inside it.
    if (x.valid && x.anchor.x == tv * ts && x.anchor.y == tu * ts) {
      const int lr = x.uv.y + half - r0, lc = x.uv.x + half - c0;
      if (lr >= lr0 && lr < lr1 && lc >= lc0 && lc < lc1) key = lr * ru + lc;
    }
    const int o = key >= 0 ? (key & (kWarps - 1)) : kWarps;
    int below = 0, mine = 0;
    for (int v = 0; v < kWarps; ++v) {
      const unsigned b = __ballot_sync(0xffffffffu, o == v);
      if (o == v) below = __popc(b & ((1u << lane) - 1u));
      if (lane == v) mine = __popc(b);
    }
    __syncthreads();  // the warps are done with the last chunk
    skey[t] = key;
    for (int p = 0; p < P; ++p) sw[t * P + p] = x.w[p];
    if (lane < kWarps) cnt[warp * kWarps + lane] = mine;
    __syncthreads();
    if (warp == 0) {
      // Lane v < kWarps: owner v's counts by warp, their running sum, and
      // the owners' exclusive scan across lanes.
      int run[kWarps];
      int tot = 0;
      for (int w2 = 0; w2 < kWarps; ++w2) {
        run[w2] = tot;
        tot += lane < kWarps ? cnt[w2 * kWarps + lane] : 0;
      }
      int incl = tot;
      for (int d = 1; d < kWarps; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      const int base_v = incl - tot;
      if (lane < kWarps) {
        for (int w2 = 0; w2 < kWarps; ++w2)
          start[w2 * kWarps + lane] = base_v + run[w2];
        total[lane] = tot;
      }
    }
    __syncthreads();
    if (o < kWarps) order[start[warp * kWarps + o] + below] = t;
    __syncthreads();
    have = advance(s, c, first, end, S);
    if (have)
      x = load_slot(uv, weights, anchor, valid,
                    static_cast<size_t>(s) * NC + c, Mc, P, t);
    const int b0 = start[warp], len = total[warp];
    for (int m0 = 0; m0 < len; m0 += 32) {
      const int j = m0 + lane;
      const int slot = j < len ? order[b0 + j] : -1;
      const int k = slot >= 0 ? skey[slot] : -1 - lane;
      const unsigned peers = __match_any_sync(0xffffffffu, k);
      if (slot >= 0 && (peers & ((1u << lane) - 1u)) == 0u) {
        for (unsigned b = peers; b != 0u; b &= b - 1u) {
          const float* wj = sw + order[b0 + m0 + __ffs(b) - 1] * P;
          for (int p = 0; p < P; ++p) region[p * cells + k] += wj[p];
        }
      }
    }
  }
  __syncthreads();

  for (int i = t; i < P * cells; i += kThreads) {
    const int p = i / cells, rem = i - p * cells;
    const int lr = rem / ru, lc = rem - lr * ru;
    if (lr >= lr0 && lr < lr1 && lc >= lc0 && lc < lc1)
      out[(static_cast<size_t>(p) * N + r0 + lr) * N + c0 + lc] = region[i];
  }
}

int floor_div(int a, int b) {
  return a / b - (a % b != 0 && (a < 0) != (b < 0));
}

}  // namespace

// uv (S, NC, Mc, 2) int32 (u, v); weights (S, NC, Mc, P) f32; anchor
// (S, NC, 2) int32; valid (S, NC, Mc) bool; out (P, N, N) f32, every cell
// written.  Mc in [0, 256], P in [1, 4], ts in [1, 256], 0 <= kb < ts.
extern "C" int ktt_weight_grid(const void* uv, const void* weights,
                               const void* anchor, const void* valid,
                               void* out, int S, int NC, int Mc, int P, int N,
                               int ts, int kb, void* stream) {
  if (S < 0 || NC < 0 || Mc < 0 || Mc > kThreads || P <= 0 ||
      P > kMaxPols || N <= 0 || ts <= 0 || ts > 256 || kb < 0 || kb >= ts)
    return cudaErrorInvalidValue;
  const int side = ts < kRegion ? ts : kRegion;
  const size_t bytes =
      sizeof(float) * (static_cast<size_t>(P) * side * side + kThreads * P) +
      sizeof(int) * (2 * static_cast<size_t>(S) + 2 * kThreads +
                     2 * kWarps * kWarps + kWarps);
  cudaError_t err = cudaFuncSetAttribute(
      weight_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  // The tiles whose windows [t ts + kb, (t + 1) ts + kb) meet [0, N).
  const int t_min = floor_div(-kb, ts);
  const int t_max = floor_div(N - 1 - kb, ts);
  const int nsub = (ts + kRegion - 1) / kRegion;
  const unsigned blocks = static_cast<unsigned>((t_max - t_min + 1) * nsub);
  const int ntu = (N + ts - 1) / ts + 1;
  weight_grid_kernel<<<dim3(blocks, blocks), kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(uv), static_cast<const float*>(weights),
      static_cast<const int2*>(anchor),
      static_cast<const unsigned char*>(valid), static_cast<float*>(out), S,
      NC, Mc, P, N, ts, kb, t_min, nsub, ntu);
  return cudaGetLastError();
}
