// K5's shared-memory layout (csrc/degrid.cu): its constants, the bytes of
// a layout and the choice of layout for (ts, K, Mc, P).  Plain C++ with no
// CUDA, so that a host compiler can build it alone: degrid.cu includes it,
// and the CPU tests build it with g++ to check the layout that the kernel
// runs with against a model of its sliding window.
#ifndef KTT_DEGRID_LAYOUT_H
#define KTT_DEGRID_LAYOUT_H

#include <cstddef>
#include <initializer_list>

namespace k5 {

constexpr int kThreads = 256;  // 8 warps
constexpr int kVec = 2;  // 16-byte loads per thread and plane per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 256;     // K: at most 16 taps per lane along k
constexpr int kMaxPassRows = 64;  // Kj: two kv taps per lane to stage
constexpr int kKvHalf = 34;  // half-warp 1's kv rows: 16-byte aligned, on
constexpr int kKvRow = 68;   // other banks than half-warp 0's
// Dynamic shared memory of one CUDA block (227 KB), and the most with
// which two fit on one SM (228 KB less 1 KB reserved per block).
constexpr size_t kMaxSmem = 232448;
constexpr size_t kTwoPerSm = 115712;

// A layout: the ring's row stride S in complex values (the widest chunk
// footprint from a column that is a multiple of 4, K + ts + 2, rounded up
// to 4), the rows D of a block (the row shifts of one group), the ring's
// blocks R (one more than a group's rows reach), the tap rows Kj of a
// pass, and the dynamic shared memory in bytes.
struct Layout {
  int S, D, R, Kj;
  size_t smem;
};

// Shared memory in bytes for a layout: the ring of R blocks of D rows of S
// complex values, per-warp kv rows, slot accumulators, then the slot
// metadata (iu, iv, su, sv, the sorted order) and the group starts and
// cursors.
inline size_t smem_bytes(int Mc, int P, int ts, int S, int D, int R) {
  const int groups = (ts + D - 1) / D + 1;
  return 8 * (static_cast<size_t>(R) * D * S + kWarps * kKvRow +
              static_cast<size_t>(Mc) * P) +
         4 * (5 * static_cast<size_t>(Mc) + 2 * groups);
}

// The layout K5 runs with, false where none fits.  Preferred: blocks of 16
// or 8 rows (few groups, so few barriers), two CUDA blocks per SM, then
// the fewest passes; a block's 16-byte loads must fit the threads' staging
// registers (kVec per thread and plane).
inline bool choose_layout(int ts, int K, int Mc, int P, Layout* out) {
  if (K <= 0 || K > ts + 1 || K > kMaxTaps || Mc <= 0 || P <= 0)
    return false;
  const int S = (K + ts + 5) / 4 * 4;
  const int max_rows = kVec * kThreads / ((K + ts + 5) / 4);
  const int top = K < kMaxPassRows ? K : kMaxPassRows;
  int passes[5] = {top};
  int np = 1;
  for (int kj : {48, 32, 16, 8})
    if (kj < top) passes[np++] = kj;
  const int rows[2][3] = {{16, 8, 0}, {4, 2, 1}};
  for (const auto& choices : rows)
    for (size_t budget : {kTwoPerSm, kMaxSmem})
      for (int i = 0; i < np; ++i)
        for (int D : choices) {
          if (D == 0 || D > max_rows) continue;
          const int R = (D + passes[i] - 1 + D - 1) / D + 1;
          const size_t smem = smem_bytes(Mc, P, ts, S, D, R);
          if (smem <= budget) {
            *out = Layout{S, D, R, passes[i], smem};
            return true;
          }
        }
  return false;
}

}  // namespace k5

// The layout for (ts, K, Mc, P): out = {S, D, R, Kj, smem}; returns 0, or
// 1 where no layout fits.
extern "C" int ktt_degrid_layout(int ts, int K, int Mc, int P, int* out) {
  k5::Layout l;
  if (!k5::choose_layout(ts, K, Mc, P, &l)) return 1;
  out[0] = l.S;
  out[1] = l.D;
  out[2] = l.R;
  out[3] = l.Kj;
  out[4] = static_cast<int>(l.smem);
  return 0;
}

#endif  // KTT_DEGRID_LAYOUT_H
