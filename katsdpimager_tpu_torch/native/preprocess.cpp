// Native visibility preprocessing core: Mueller conversion, weight
// propagation, quantization, sort and merge-compression.
//
// Host-side counterpart of katsdpimager_tpu/preprocess.py for the
// file-streaming data plane (the on-device JAX path is the design target;
// this exists where the reference uses preprocess.cpp: keeping multi-core
// CPU ingest fast enough to feed the accelerator).  C ABI for ctypes; no
// pybind11 dependency.
//
// Semantics (matching the Python/JAX implementation, which itself mirrors
// the reference's behaviour):
//  - a visibility with any zero input weight is discarded;
//  - the Mueller matrix maps Q input products to P outputs; weights are
//    propagated as variances with 0*inf = 0 handling;
//  - w < 0 is flipped with conjugation;
//  - uv is quantized to (cell, subpixel) at `oversample` subcells, w to
//    (w_slice, w_plane) with a half-width first slice;
//  - records out of gridding range are dropped;
//  - identically-quantized records are merged (vis and weights summed in
//    input order, matching a stable sort by key);
//  - output is sorted by (w_slice, v, u, sub_v, sub_u, w_plane).
//
// Pipeline (all stages OpenMP-parallel, measured on this 4-core host):
//  1. transform: Mueller/quantize into a 64-byte Record array (reused
//     arena, no zero-initialisation — value-initialising 0.5 GB cost more
//     than the transform itself);
//  2. gather: block-counted parallel compaction of (key, index) pairs,
//     computing OR/AND key masks on the fly;
//  3. sort: LSD radix sort on the packed key, 8-bit digits, skipping
//     digits the OR/AND masks prove constant (keys are packed with
//     geometry-tight field widths so most high digits skip);
//  4. merge: run boundaries are counted per block (prefix-summed into
//     output offsets), then each block merges its runs directly into the
//     caller's struct-of-arrays output — no scratch copy, no serial
//     compaction pass.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif
#ifdef __linux__
#include <sys/mman.h>
#endif

namespace {

struct ChannelConfig {
    double cell_size;   // metres
    double max_w;       // metres
    int32_t oversample;
    int32_t w_slices;
    int32_t w_planes;
    int32_t pixels;
    int32_t kernel_width;
};

constexpr int MAX_P = 4;

// Power-of-two record stride, sized to the output polarization count:
// Stokes-I records are half a cache line (halves the transform's write
// traffic and the merge's gather traffic), full-pol records exactly one
// line — either way a sorted-order (random) gather never straddles.
template <int NP>
struct alignas(NP == 1 ? 32 : 64) RecordT {
    int16_t uv[2];
    int16_t sub_uv[2];
    int16_t w_plane;
    float weights[NP];
    std::complex<float> vis[NP];
};
static_assert(sizeof(RecordT<1>) == 32, "P=1 record must be half a line");
static_assert(sizeof(RecordT<4>) == 64, "P=4 record must be one line");

inline void subpixel_coord(float x, int32_t oversample, int16_t &pixel,
                           int16_t &subpixel) {
    int32_t xs = int32_t(std::floor(double(x) * oversample));
    int32_t p = xs / oversample;
    int32_t s = xs % oversample;
    if (s < 0) {
        p--;
        s += oversample;
    }
    pixel = int16_t(p);
    subpixel = int16_t(s);
}

inline int ceil_log2(int64_t v) {
    int b = 0;
    while ((int64_t(1) << b) < v) b++;
    return b;
}

// Geometry-tight key packing: (w_slice, v, u, sub_v, sub_u, w_plane) with
// per-field bit widths from the config, so the radix sort's digit-skip
// sees every unused high bit as constant.  Same lexicographic order as
// fixed-width packing (fields are packed in the same order, disjoint
// bits).  Worst case 7+17+17+7+7+10 = 65 bits would overflow, but the
// footprint check bounds biased u/v to [0, pixels], i.e. bits_uv =
// ceil_log2(pixels + 1) <= 16 for the supported pixels <= 32768, giving
// <= 63 bits.
struct KeyPacker {
    int bits_uv, bits_s, bits_wp, ws_shift;

    explicit KeyPacker(const ChannelConfig &cfg)
        : bits_uv(ceil_log2(int64_t(cfg.pixels) + 1)),
          bits_s(ceil_log2(cfg.oversample)),
          bits_wp(ceil_log2(cfg.w_planes)),
          ws_shift(2 * bits_uv + 2 * bits_s + bits_wp) {}

    uint64_t pack(int32_t bu, int32_t bv, int16_t su, int16_t sv,
                  int16_t wp, int16_t ws) const {
        uint64_t key = uint64_t(uint16_t(ws));
        key = (key << bits_uv) | uint32_t(bv);
        key = (key << bits_uv) | uint32_t(bu);
        key = (key << bits_s) | uint16_t(sv);
        key = (key << bits_s) | uint16_t(su);
        key = (key << bits_wp) | uint16_t(wp);
        return key;
    }

    int16_t w_slice(uint64_t key) const {
        return int16_t(key >> ws_shift);
    }
};

// Stage timing, printed to stderr when KTPU_NATIVE_PROFILE=1.
struct StageTimer {
    using clock = std::chrono::steady_clock;
    bool enabled;
    clock::time_point last;
    StageTimer() : enabled([] {
        const char *e = std::getenv("KTPU_NATIVE_PROFILE");
        return e && e[0] == '1';
    }()), last(clock::now()) {}
    void mark(const char *name) {
        if (!enabled) return;
        auto now = clock::now();
        std::fprintf(stderr, "[ktpu-native] %-10s %7.1f ms\n", name,
                     std::chrono::duration<double, std::milli>(now - last)
                         .count());
        last = now;
    }
};

// Reusable buffers: calls are serialised by g_mutex (the pipeline is
// internally parallel, so concurrent channel calls would only thrash the
// cores), and the buffers persist across calls so the ~0.7 GB working set
// is allocated and page-faulted once per process, not once per channel.
struct Arena {
    template <typename T>
    struct Buf {
        T *p = nullptr;
        size_t cap = 0;
        T *ensure(size_t n) {
            if (n > cap) {
                std::free(p);
                // aligned_alloc honours alignas(64) Records (malloc's
                // 16-byte alignment would fault SIMD whole-record copies).
                const size_t bytes = (n * sizeof(T) + 63) & ~size_t(63);
                p = static_cast<T *>(std::aligned_alloc(64, bytes));
                cap = p ? n : 0;
#ifdef __linux__
                // Transparent hugepages cut TLB misses on the random
                // record gathers in the merge stage.
                if (p) madvise(p, bytes, MADV_HUGEPAGE);
#endif
            }
            return p;
        }
    };
    Buf<uint8_t> record_bytes;   // RecordT<NP> array, cast per call
    Buf<uint64_t> keys_in;   // keys by input index (transform output)
    Buf<uint8_t> keep;
    Buf<uint64_t> keys[2];   // radix ping-pong
    Buf<int32_t> idx[2];
};

Arena g_arena;
std::mutex g_mutex;

int num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

// Parallel LSD radix sort of (keys, idx) by key, DIGIT_BITS-wide digits,
// stable.  Digits constant across all keys (per key_or/key_and) are
// skipped — with geometry-tight key packing a 4k-grid key uses ~40 bits,
// so only 4 of the 6 digits run.  Returns which ping-pong buffer (0/1)
// holds the sorted result.
constexpr int DIGIT_BITS = 11;
constexpr int NUM_DIGITS = (64 + DIGIT_BITS - 1) / DIGIT_BITS;
constexpr size_t NUM_BUCKETS = size_t(1) << DIGIT_BITS;
constexpr uint64_t DIGIT_MASK = NUM_BUCKETS - 1;

int radix_sort(Arena &a, size_t n, uint64_t key_or, uint64_t key_and) {
    const int T = num_threads();
    int src = 0;
    std::vector<size_t> hist(size_t(T) * NUM_BUCKETS);
    for (int d = 0; d < NUM_DIGITS; d++) {
        const int sh = DIGIT_BITS * d;
        if (((key_or >> sh) & DIGIT_MASK) == ((key_and >> sh) & DIGIT_MASK))
            continue;  // constant digit
        const uint64_t *ks = a.keys[src].p;
        const int32_t *is = a.idx[src].p;
        uint64_t *kd = a.keys[1 - src].p;
        int32_t *id = a.idx[1 - src].p;
        std::fill(hist.begin(), hist.end(), 0);
#pragma omp parallel num_threads(T)
        {
#ifdef _OPENMP
            const int t = omp_get_thread_num();
#else
            const int t = 0;
#endif
            const size_t lo = n * t / T, hi = n * (t + 1) / T;
            size_t *h = hist.data() + size_t(t) * NUM_BUCKETS;
            for (size_t i = lo; i < hi; i++)
                h[(ks[i] >> sh) & DIGIT_MASK]++;
#pragma omp barrier
#pragma omp single
            {
                // bucket-major exclusive prefix: offset of (bucket b,
                // thread t) = all smaller buckets + same bucket in
                // earlier threads.
                size_t sum = 0;
                for (size_t b = 0; b < NUM_BUCKETS; b++)
                    for (int tt = 0; tt < T; tt++) {
                        size_t &c = hist[size_t(tt) * NUM_BUCKETS + b];
                        size_t v = c;
                        c = sum;
                        sum += v;
                    }
            }
            for (size_t i = lo; i < hi; i++) {
                const size_t o = h[(ks[i] >> sh) & DIGIT_MASK]++;
                kd[o] = ks[i];
                id[o] = is[i];
            }
        }
        src = 1 - src;
    }
    return src;
}

}  // namespace

namespace {

// The pipeline body, templated on the record stride (NP >= num_p).
template <int NP>
int64_t preprocess_impl(
    int64_t n, int32_t num_q, int32_t num_p,
    const float *uvw, const float *weights_in, const float *vis_in,
    const float *mueller, int32_t per_vis_mueller,
    const ChannelConfig *cfg,
    int16_t *out_uv, int16_t *out_sub_uv, int16_t *out_w_plane,
    float *out_weights, float *out_vis, int64_t *out_slice_counts)
{
    using Record = RecordT<NP>;
    const auto *vis_c = reinterpret_cast<const std::complex<float> *>(vis_in);
    const auto *mueller_c = reinterpret_cast<const std::complex<float> *>(mueller);

    const float uv_scale = float(1.0 / cfg->cell_size);
    const float w_scale =
        float((cfg->w_slices - 0.5) * cfg->w_planes / cfg->max_w);
    const int32_t max_slice_plane = cfg->w_slices * cfg->w_planes - 1;
    const KeyPacker packer(*cfg);
    const int32_t half = cfg->pixels / 2;
    const int32_t kw_half = (cfg->kernel_width - 1) / 2;

    StageTimer timer;
    Record *records = reinterpret_cast<Record *>(
        g_arena.record_bytes.ensure(size_t(n) * sizeof(Record)));
    uint64_t *keys_in = g_arena.keys_in.ensure(n);
    uint8_t *keep = g_arena.keep.ensure(n);
    for (auto &b : g_arena.keys) b.ensure(n);
    for (auto &b : g_arena.idx) b.ensure(n);
    if (!records || !keys_in || !keep || !g_arena.keys[1].p ||
        !g_arena.idx[1].p)
        return -1;
    timer.mark("alloc");

#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; i++) {
        keep[i] = 0;
        Record &r = records[i];
        const float *w_row = weights_in + i * num_q;
        bool flagged = false;
        for (int32_t q = 0; q < num_q; q++)
            if (w_row[q] == 0.0f) flagged = true;
        if (flagged) continue;

        const std::complex<float> *v_row = vis_c + i * num_q;
        const std::complex<float> *M = per_vis_mueller
            ? mueller_c + i * num_p * num_q : mueller_c;

        std::complex<float> xvis[NP];
        float xw[NP];
        for (int32_t p = 0; p < num_p; p++) {
            std::complex<float> acc(0.0f, 0.0f);
            float var = 0.0f;
            for (int32_t q = 0; q < num_q; q++) {
                const std::complex<float> m = M[p * num_q + q];
                acc += m * v_row[q];
                const float m2 = std::norm(m);
                if (m2 > 0.0f) var += m2 / std::fabs(w_row[q]);
            }
            xvis[p] = acc;
            xw[p] = 1.0f / var;
        }

        float u = uvw[i * 3 + 0];
        float v = uvw[i * 3 + 1];
        float w = uvw[i * 3 + 2];
        if (w < 0.0f) {
            u = -u;
            v = -v;
            w = -w;
            for (int32_t p = 0; p < num_p; p++) xvis[p] = std::conj(xvis[p]);
        }

        bool any_weight = false;
        for (int32_t p = 0; p < num_p; p++) {
            float weight = xw[p];
            std::complex<float> wv = xvis[p] * weight;
            if (!std::isfinite(wv.real()) || !std::isfinite(wv.imag())) {
                wv = 0.0f;
                weight = 0.0f;
            }
            r.vis[p] = wv;
            r.weights[p] = weight;
            if (weight > 0.0f) any_weight = true;
        }
        if (!any_weight) continue;

        subpixel_coord(u * uv_scale, cfg->oversample, r.uv[0], r.sub_uv[0]);
        subpixel_coord(v * uv_scale, cfg->oversample, r.uv[1], r.sub_uv[1]);
        float wq = std::trunc(w * w_scale + cfg->w_planes * 0.5f);
        int32_t slice_plane = std::min(int32_t(wq), max_slice_plane);
        if (slice_plane < 0) slice_plane = 0;
        r.w_plane = int16_t(slice_plane % cfg->w_planes);
        const int16_t w_slice = int16_t(slice_plane / cfg->w_planes);

        // Footprint must fit the grid.
        const int32_t bu = r.uv[0] + half - kw_half;
        const int32_t bv = r.uv[1] + half - kw_half;
        if (bu < 0 || bv < 0 || bu + cfg->kernel_width > cfg->pixels ||
            bv + cfg->kernel_width > cfg->pixels)
            continue;

        keys_in[i] = packer.pack(r.uv[0] + half, r.uv[1] + half,
                                 r.sub_uv[0], r.sub_uv[1], r.w_plane,
                                 w_slice);
        keep[i] = 1;
    }
    timer.mark("transform");

    // Parallel compaction of kept (key, index) pairs, with OR/AND key
    // masks for the radix digit-skip.
    const int T = num_threads();
    std::vector<size_t> block_count(T + 1, 0);
    uint64_t key_or = 0, key_and = ~uint64_t(0);
#pragma omp parallel num_threads(T) reduction(|:key_or) reduction(&:key_and)
    {
#ifdef _OPENMP
        const int t = omp_get_thread_num();
#else
        const int t = 0;
#endif
        const int64_t lo = n * t / T, hi = n * (t + 1) / T;
        size_t c = 0;
        for (int64_t i = lo; i < hi; i++) c += keep[i];
        block_count[t + 1] = c;
#pragma omp barrier
#pragma omp single
        {
            for (int tt = 0; tt < T; tt++)
                block_count[tt + 1] += block_count[tt];
        }
        size_t o = block_count[t];
        uint64_t *kd = g_arena.keys[0].p;
        int32_t *id = g_arena.idx[0].p;
        for (int64_t i = lo; i < hi; i++)
            if (keep[i]) {
                key_or |= keys_in[i];
                key_and &= keys_in[i];
                kd[o] = keys_in[i];
                id[o] = int32_t(i);
                o++;
            }
    }
    const size_t total = block_count[T];
    if (total == 0) {
        std::memset(out_slice_counts, 0, sizeof(int64_t) * cfg->w_slices);
        return 0;
    }
    timer.mark("gather");

    const int which = radix_sort(g_arena, total, key_or, key_and);
    const uint64_t *skeys = g_arena.keys[which].p;
    const int32_t *sidx = g_arena.idx[which].p;
    timer.mark("sort");

    // Merge runs of identical keys straight into the caller's output:
    // count runs per block (blocks aligned to run starts), prefix-sum into
    // output offsets, then merge-write each block independently.
    std::vector<size_t> part(T + 1, total);
    part[0] = 0;
    for (int t = 1; t < T; t++) {
        size_t pos = total * t / T;
        while (pos < total && pos > 0 && skeys[pos] == skeys[pos - 1]) pos++;
        part[t] = pos;
    }
    std::vector<size_t> runs(T + 1, 0);
    std::vector<std::vector<int64_t>> slice_counts(
        T, std::vector<int64_t>(cfg->w_slices, 0));
    auto *out_vis_c = reinterpret_cast<std::complex<float> *>(out_vis);
#pragma omp parallel num_threads(T)
    {
#ifdef _OPENMP
        const int t = omp_get_thread_num();
#else
        const int t = 0;
#endif
        size_t c = 0;
        for (size_t i = part[t]; i < part[t + 1]; i++)
            c += (i == part[t]) || (skeys[i] != skeys[i - 1]);
        runs[t + 1] = c;
#pragma omp barrier
#pragma omp single
        {
            for (int tt = 0; tt < T; tt++) runs[tt + 1] += runs[tt];
        }
        int64_t o = int64_t(runs[t]);
        int64_t *sc = slice_counts[t].data();
        const size_t pf_end = part[t + 1];
        for (size_t i = part[t]; i < part[t + 1];) {
            // The gathers below hit records in sorted (random) order;
            // prefetch a handful of iterations ahead to hide the misses.
            if (i + 8 < pf_end) __builtin_prefetch(&records[sidx[i + 8]]);
            const uint64_t key = skeys[i];
            Record acc = records[sidx[i]];
            size_t j = i + 1;
            while (j < part[t + 1] && skeys[j] == key) {
                const Record &other = records[sidx[j]];
                for (int32_t p = 0; p < num_p; p++) {
                    acc.vis[p] += other.vis[p];
                    acc.weights[p] += other.weights[p];
                }
                j++;
            }
            out_uv[o * 2 + 0] = acc.uv[0];
            out_uv[o * 2 + 1] = acc.uv[1];
            out_sub_uv[o * 2 + 0] = acc.sub_uv[0];
            out_sub_uv[o * 2 + 1] = acc.sub_uv[1];
            out_w_plane[o] = acc.w_plane;
            for (int32_t p = 0; p < num_p; p++) {
                out_weights[o * num_p + p] = acc.weights[p];
                out_vis_c[o * num_p + p] = acc.vis[p];
            }
            sc[packer.w_slice(key)]++;
            o++;
            i = j;
        }
    }
    std::memset(out_slice_counts, 0, sizeof(int64_t) * cfg->w_slices);
    for (int t = 0; t < T; t++)
        for (int32_t s = 0; s < cfg->w_slices; s++)
            out_slice_counts[s] += slice_counts[t][s];
    timer.mark("merge");
    return int64_t(runs[T]);
}

}  // namespace

extern "C" {

// Returns the number of merged output records (<= n), or -1 on error.
// Outputs are written per the struct-of-arrays layout; out_slice_counts has
// w_slices entries with per-slice record counts.
int64_t ktpu_preprocess_channel(
    int64_t n, int32_t num_q, int32_t num_p,
    const float *uvw,              // (n, 3)
    const float *weights_in,       // (n, Q)
    const float *vis_in,           // (n, Q) complex interleaved
    const float *mueller,          // (P, Q) complex interleaved, or (n, P, Q)
    int32_t per_vis_mueller,
    const ChannelConfig *cfg,
    int16_t *out_uv,               // (n, 2)
    int16_t *out_sub_uv,           // (n, 2)
    int16_t *out_w_plane,          // (n,)
    float *out_weights,            // (n, P)
    float *out_vis,                // (n, P) complex interleaved
    int64_t *out_slice_counts)     // (w_slices,)
{
    if (num_p > MAX_P || num_p < 1) return -1;
    std::lock_guard<std::mutex> guard(g_mutex);
    if (num_p == 1)
        return preprocess_impl<1>(n, num_q, num_p, uvw, weights_in, vis_in,
                                  mueller, per_vis_mueller, cfg, out_uv,
                                  out_sub_uv, out_w_plane, out_weights,
                                  out_vis, out_slice_counts);
    return preprocess_impl<MAX_P>(n, num_q, num_p, uvw, weights_in, vis_in,
                                  mueller, per_vis_mueller, cfg, out_uv,
                                  out_sub_uv, out_w_plane, out_weights,
                                  out_vis, out_slice_counts);
}

int32_t ktpu_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

// Tile-aligned chunk planning + coordinate scatter for one (channel,
// w-slice): the native counterpart of ops/mxu_gridder.py's
// plan_chunks_tiled_coords + the batch packer's coordinate scatter
// (cube_frontend.pack_wave_arrays).  Semantics are bitwise-identical:
// stable ordering by tile key (tv * ntu + tu) with ties in input order,
// runs split into chunks of <= mc slots, anchors at (tv*ts, tu*ts).
//
// One-pass placement: tile keys span only (pixels/ts + 1)^2 values, so a
// stable parallel COUNTING sort (per-thread per-tile histograms,
// bucket-major prefix) yields every row's (chunk, slot) directly — no
// (key, index) sort, no separate scatter pass.
//
// Writes the (nc_cap, mc) struct-of-arrays outputs (which the caller
// pre-zeroes) plus per-ROW chunk/slot mappings for streaming payload
// placement.  Returns the number of chunks needed; when that exceeds
// nc_cap NOTHING is written (the caller grows the layout and repacks).
// Returns -1 on error.
int64_t ktpu_pack_slice_coords(
    int64_t n,
    const int16_t *uv,        // (n, 2) centred cell coords
    const int16_t *sub_uv,    // (n, 2)
    const int16_t *w_plane,   // (n,)
    int32_t pixels, int32_t kernel_width, int32_t ts, int32_t mc,
    int64_t nc_cap,
    int32_t *out_uv,          // (nc_cap, mc, 2)
    int32_t *out_sub,         // (nc_cap, mc, 2)
    int32_t *out_wp,          // (nc_cap, mc)
    int32_t *out_anchor,      // (nc_cap, 2)
    uint8_t *out_valid,       // (nc_cap, mc)
    int32_t *row_chunk,       // (n,)
    int32_t *row_slot)        // (n,)
{
    if (n <= 0 || ts <= 0 || mc <= 0) return n == 0 ? 0 : -1;
    std::lock_guard<std::mutex> guard(g_mutex);
    const int32_t uv_bias = (kernel_width - 1) / 2 - pixels / 2;
    const int32_t ntu = (pixels + ts - 1) / ts + 1;
    const size_t nk = size_t(ntu) * ntu;

    // Reuse the idx ping-pong buffer as key storage (int32 keys).
    int32_t *keys = g_arena.idx[0].ensure(n);
    if (!keys) return -1;
    const int T = num_threads();
    std::vector<size_t> hist(size_t(T) * nk, 0);

#pragma omp parallel num_threads(T)
    {
#ifdef _OPENMP
        const int t = omp_get_thread_num();
#else
        const int t = 0;
#endif
        const int64_t lo = n * t / T, hi = n * (t + 1) / T;
        size_t *h = hist.data() + size_t(t) * nk;
        for (int64_t i = lo; i < hi; i++) {
            // biased coords are non-negative (footprint-checked upstream)
            const int32_t tu = (int32_t(uv[2 * i + 0]) - uv_bias) / ts;
            const int32_t tv = (int32_t(uv[2 * i + 1]) - uv_bias) / ts;
            const int32_t key = tv * ntu + tu;
            keys[i] = key;
            h[key]++;
        }
    }

    // Chunk numbering across tiles + per-(tile, thread) start offsets.
    std::vector<int64_t> chunk_base(nk + 1, 0);
    int64_t chunks = 0;
    for (size_t k = 0; k < nk; k++) {
        chunk_base[k] = chunks;
        size_t total = 0;
        for (int t = 0; t < T; t++) {
            size_t &c = hist[size_t(t) * nk + k];
            size_t v = c;
            c = total;      // intra-tile start offset for thread t
            total += v;
        }
        chunks += int64_t((total + mc - 1) / mc);
    }
    chunk_base[nk] = chunks;
    if (chunks > nc_cap) return chunks;   // caller grows the layout

#pragma omp parallel num_threads(T)
    {
#ifdef _OPENMP
        const int t = omp_get_thread_num();
#else
        const int t = 0;
#endif
        const int64_t lo = n * t / T, hi = n * (t + 1) / T;
        size_t *h = hist.data() + size_t(t) * nk;
        for (int64_t i = lo; i < hi; i++) {
            const int32_t key = keys[i];
            const size_t pos = h[key]++;
            const int64_t c = chunk_base[key] + int64_t(pos / mc);
            const int64_t sl = int64_t(pos % mc);
            const int64_t o = c * mc + sl;
            out_uv[o * 2 + 0] = uv[2 * i + 0];
            out_uv[o * 2 + 1] = uv[2 * i + 1];
            out_sub[o * 2 + 0] = sub_uv[2 * i + 0];
            out_sub[o * 2 + 1] = sub_uv[2 * i + 1];
            out_wp[o] = w_plane[i];
            out_valid[o] = 1;
            if (sl == 0) {
                out_anchor[c * 2 + 0] = (key / ntu) * ts;
                out_anchor[c * 2 + 1] = (key % ntu) * ts;
            }
            row_chunk[i] = int32_t(c);
            row_slot[i] = int32_t(sl);
        }
    }
    return chunks;
}

// Payload placement for one (channel, w-slice) block: scatter weights and
// visibilities to the (chunk, slot) positions computed by
// ktpu_pack_slice_coords.  Each row has a unique destination, so the
// parallel scatter is race-free.
void ktpu_place_payload(
    int64_t m, int32_t num_p, int32_t mc,
    const int32_t *row_chunk, const int32_t *row_slot,
    const float *weights,     // (m, P)
    const float *vis,         // (m, P) complex interleaved
    float *out_wts,           // (NC, Mc, P)
    float *out_vis)           // (NC, Mc, P) complex interleaved
{
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; i++) {
        const int64_t o = int64_t(row_chunk[i]) * mc + row_slot[i];
        for (int32_t p = 0; p < num_p; p++) {
            out_wts[o * num_p + p] = weights[i * num_p + p];
            out_vis[(o * num_p + p) * 2 + 0] = vis[(i * num_p + p) * 2 + 0];
            out_vis[(o * num_p + p) * 2 + 1] = vis[(i * num_p + p) * 2 + 1];
        }
    }
}

}  // extern "C"
