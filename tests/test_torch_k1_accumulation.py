"""K1's accumulation on the tensor cores, on the CPU: a model of their
truncating FP32 sums, fitted to the card, and K1's schedule under it.

The model (after Fasi, Higham, Mikaitis & Pranesh, "Numerical behavior of
NVIDIA tensor cores", PeerJ Comput. Sci. 2021): one TF32 ``wgmma`` k8
step forms its 8 products exactly, aligns them and the FP32 accumulator
to the largest exponent among them, keeps each to ``GUARD_BITS`` bits
past that one's 24-bit significand (the lower bits are dropped: towards
zero), adds them exactly and truncates the sum to FP32.  Fitted to probe
C's four readings on an H100 ("NVIDIA H100 80GB HBM3, 700.00 W": the
3xTF32 dot of the probe data, 256 long, in four accumulation
schedules): among 0-3 guard bits, groups of 4 or 8 products a step and a
truncated or rounded result, 2 guard bits, one group of 8 and a
truncated result match all four to within 1% (1.94e-6, 7.69e-7,
3.14e-7, 1.79e-7 of the peak against 1.94e-6, 7.7e-7, 3.14e-7,
1.79e-7); the next best fit is off by 10%.

Under the model, K1's schedule before (``csrc/gridder.cu`` until the
two-level totals: one accumulator per value taking all six 3xTF32
products of each k-step of 8 visibilities, promoted into the plane every
32 k-steps) misses 1e-6 of the peak of a float64 run on runs of 32
k-steps and more, as it did on the card (3.1-3.9e-6); the schedule that
replaced it (``wgmma.cuh``: afresh every ``PROMOTE_STEPS`` k-steps, then
IEEE adds into two levels of FP32 totals) holds it.
``tests/test_torch_gpu.py`` holds the kernel itself to 1e-6 on the card.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from katsdpimager_tpu.ops import pallas_gridder
from katsdpimager_tpu_torch import probes
from katsdpimager_tpu_torch.ops import fused_gridder, mxu_gridder
from katsdpimager_tpu_torch.ops.fused_gridder import tf32_rna
from tests.test_torch_gridder_tc import run_inputs

torch.set_num_threads(2)

#: Bits the tensor cores keep past the largest addend's 24-bit
#: significand when they align a k8 step's addends (the fit above).
GUARD_BITS = 2

#: Probe C's readings on the H100 above, by (accumulators,
#: k-steps between promotions; 0: promoted once, at the end).
PROBE_C_CARD = {(1, 0): 1.94e-6, (3, 0): 7.7e-7, (1, 4): 3.14e-7,
                (3, 4): 1.79e-7}


def f32(x):
    """float64 ``x`` rounded to float32 (IEEE, to nearest), as float64."""
    return x.astype(np.float32).astype(np.float64)


def tf32(x):
    """``tf32_rna`` of float32 ``x`` (numpy), as float64."""
    return tf32_rna(torch.from_numpy(np.ascontiguousarray(
        x, np.float32))).numpy().astype(np.float64)


def split(x):
    """K1's split of float32 ``x``: (hi, lo), each TF32, as float64."""
    hi = tf32(x)
    return hi, tf32(np.asarray(x, np.float32) - hi.astype(np.float32))


def truncate_f32(s):
    """float64 ``s`` truncated towards zero to 24 significant bits."""
    m, e = np.frexp(s)
    return np.ldexp(np.trunc(np.ldexp(m, 24)), e - 24)


def tc_step(acc, prods):
    """One TF32 ``wgmma`` k8 step of the model: ``acc`` (...) the FP32
    accumulator (0 for a step with ``scale_d = 0``) and ``prods`` (..., 8)
    the step's exact products (float64); returns the new accumulator."""
    x = np.concatenate([acc[..., None], prods], -1)
    _, e = np.frexp(x)
    emax = np.where(x == 0, -100000, e).max(-1, keepdims=True)
    q = np.ldexp(1.0, np.maximum(emax, -1000) - 24 - GUARD_BITS)
    return truncate_f32((np.trunc(x / q) * q).sum(-1))


def outer(a, b):
    """(8, I) and (8, J) pieces -> (I, J, 8) products."""
    return a.T[:, None, :] * b.T[None, :, :]


def probe_c_error(accumulators: int, promote_every: int) -> float:
    """Probe C (``[a, b]^T [c, d]`` over the probe data, 32 k-steps of 8)
    under the model: the three 3xTF32 terms of k-step ks go to
    accumulator ``t % accumulators``, summed ``(acc0 + acc1) + acc2`` and
    added into f32 totals every ``promote_every`` k-steps (0: once at the
    end); its error over the peak of the float64 product."""
    d = probes.probe_data()
    x = np.concatenate([d["a"], d["b"]], 1)
    y = np.concatenate([d["c"], d["d"]], 1)
    exact = x.astype(np.float64).T @ y.astype(np.float64)
    xh, xl = split(x)
    yh, yl = split(y)
    terms = ((xl, yh), (xh, yl), (xh, yh))
    steps = x.shape[0] // 8
    acc = np.zeros((accumulators,) + exact.shape)
    total = np.zeros(exact.shape)
    for ks in range(steps):
        rows = slice(8 * ks, 8 * ks + 8)
        for t, (a, b) in enumerate(terms):
            q = t % accumulators
            acc[q] = tc_step(acc[q], outer(a[rows], b[rows]))
        if ks + 1 == steps or (promote_every and (ks + 1) % promote_every
                               == 0):
            s = acc[0]
            for q in range(1, accumulators):
                s = f32(s + acc[q])
            total = f32(total + s)
            acc[:] = 0
    return float(np.abs(total - exact).max() / np.abs(exact).max())


@pytest.mark.parametrize("schedule", list(PROBE_C_CARD),
                         ids=["1 acc, unpromoted", "3 acc, unpromoted",
                              "1 acc, every 4", "3 acc, every 4"])
def test_model_reproduces_probe_c_on_the_card(schedule):
    """The fitted model gives each of probe C's four card readings to
    within 10% (the fit is within 1%; a model off by more than 2x would
    not be used)."""
    got = probe_c_error(*schedule)
    assert 0.9 <= got / PROBE_C_CARD[schedule] <= 1.1, got


def test_model_puts_probe_c_on_k1s_schedule_inside_its_gate():
    """Probe C as K1 now accumulates (one accumulator, promoted every
    ``PROMOTE_STEPS`` k-steps) under the model: inside the probe's 1e-6
    gate, which K1's schedule before (one accumulator, 96 adds) missed."""
    assert probe_c_error(1, fused_gridder.PROMOTE_STEPS) <= 5e-7
    assert probe_c_error(1, 0) > 1e-6


def test_promote_steps_match_the_cuda_source():
    """``fused_gridder.PROMOTE_STEPS``, ``BATCH`` and ``SEGMENT`` are the
    kernel's ``kPromoteSteps``, ``kKB`` (one stretch of 8-slot k-steps)
    and ``kSegment``."""
    steps = int(cuda_constant("kPromoteSteps", "wgmma.cuh"))
    assert steps == fused_gridder.PROMOTE_STEPS
    assert cuda_constant("kKB", "gridder.cu") == "8 * kPromoteSteps"
    assert fused_gridder.BATCH == 8 * steps
    assert SEGMENT == fused_gridder.SEGMENT > 1


# ---------------------------------------------------------------------------
# K1's schedule under the model


def run_batches(slot, n, count, batch):
    """Each anchor run's batches of ``batch`` slots as K1 walks them:
    lists of (chunk, first slot), empty chunks skipped, keyed by the run's
    first chunk."""
    out = {}
    for c in range(n):
        if c == 0 or int(slot[c]) != int(slot[c - 1]):
            c0 = c
            out[c0] = []
        out[c0] += [(c, m0) for m0 in range(0, int(count[c]), batch)]
    return out


def cuda_constant(name, path):
    """The value of ``constexpr int name = ...;`` in ``csrc/path``."""
    with open(os.path.join(os.path.dirname(fused_gridder.__file__), "..",
                           "csrc", path)) as f:
        return re.search(rf"constexpr int {name} = ([^;]+);",
                         f.read()).group(1)


#: Stretches whose sums a segment's total takes before the run's total
#: does (``kSegment`` in ``csrc/wgmma.cuh``).
SEGMENT = int(cuda_constant("kSegment", "wgmma.cuh"))


def run_sums(args, nt2, *, ts, batch=fused_gridder.BATCH, promote_every=1,
             interleaved=False):
    """The tensor cores' sums of each anchor run under the model, walking
    it in batches of ``batch`` slots: per k-step of 8, re takes the 3xTF32
    terms (lo hi, hi lo, hi hi) of Ar Br, then of -Ai Bi, and im those of
    Ar Bi, then of Ai Br (``interleaved``: term by term, the two products
    alternating); the accumulators start afresh every ``promote_every``
    batches of the run.  Yields, for each run and polarization, ``(c0, p,
    colour, tv2, tu2, sums)``: the run's first chunk, its block, and the
    accumulators (2, 2ts, 2ts) each time they are promoted (float64
    arrays of f32 values)."""
    slot, n, count, iu, iv, su, sv, sre, sim, table = args
    W2 = 2 * ts
    K = table.shape[1]
    P = sre.shape[1]
    tab = table.numpy()
    tabs = fused_gridder.split_table(table).numpy().astype(np.float64)
    iu, iv, su, sv = (a.numpy() for a in (iu, iv, su, sv))
    sre, sim = sre.numpy(), sim.numpy()
    j = np.arange(W2)
    seqs = (((1, "r", "r"), (-1, "i", "i")),    # re
            ((1, "r", "i"), (1, "i", "r")))     # im
    for c0, batches in run_batches(slot, n, count, batch).items():
        colour, rem = divmod(int(slot[c0]), nt2 * nt2)
        tv2, tu2 = divmod(rem, nt2)
        for p in range(P):
            acc = np.zeros((2, W2, W2))
            sums = []
            for b, (c, b0) in enumerate(batches):
                if b % promote_every == 0:
                    acc[:] = 0
                for m0 in range(b0, b0 + batch, 8):     # k-steps
                    m = np.arange(m0, m0 + 8)
                    live = (m < int(count[c]))[:, None]
                    m = np.minimum(m, iu.shape[1] - 1)
                    dv = j[None] - sv[c, m][:, None]
                    du = j[None] - su[c, m][:, None]
                    okv = live & (dv >= 0) & (dv < K)
                    oku = live & (du >= 0) & (du < K)
                    t = np.where(okv, tab[iv[c, m][:, None],
                                          dv.clip(0, K - 1)], 0)
                    sr = sre[c, p, m][:, None]
                    si = sim[c, p, m][:, None]
                    A = {"r": split(t.real * sr - t.imag * si),  # f32
                         "i": split(t.real * si + t.imag * sr)}
                    bt = np.where(oku[..., None], tabs[iu[c, m][:, None],
                                                       du.clip(0, K - 1)], 0)
                    B = {"r": (bt[..., 0], bt[..., 1]),
                         "i": (bt[..., 2], bt[..., 3])}
                    for part, seq in enumerate(seqs):
                        steps = [(sign, A[a][pa], B[bb][pb])
                                 for sign, a, bb in seq
                                 for pa, pb in ((1, 0), (0, 1), (0, 0))]
                        if interleaved:
                            steps = [steps[i] for i in (0, 3, 1, 4, 2, 5)]
                        for sign, a, bb in steps:
                            acc[part] = tc_step(acc[part],
                                                sign * outer(a, bb))
                if (b + 1) % promote_every == 0 or b + 1 == len(batches):
                    sums.append(acc.copy())
            yield c0, p, colour, tv2, tu2, sums


def emulated_k1(args, nt2, *, ts, batch=fused_gridder.BATCH,
                promote_every=1, interleaved=False):
    """K1's planes under the model (float64 arrays of f32 values, blocks
    no run writes zero): each run's sums (:func:`run_sums`) go by IEEE
    adds into a segment's total, and that into the run's every
    :data:`SEGMENT` stretches and at the run's end, in registers, or
    (``interleaved``: the schedule before, batches of 8 promoted into the
    plane every 32) into the run's at once; stored at the end of the run.
    The defaults are the kernel's sums with the run's totals kept in
    registers, the schedule before the totals moved into the planes."""
    P = args[7].shape[1]
    W2 = 2 * ts
    shape = (2, 2, P, nt2 * W2, nt2 * W2)
    planes = [np.zeros(shape), np.zeros(shape)]
    for c0, p, colour, tv2, tu2, sums in run_sums(
            args, nt2, ts=ts, batch=batch, promote_every=promote_every,
            interleaved=interleaved):
        tot = np.zeros((2, W2, W2))
        seg = np.zeros((2, W2, W2))
        stretches = 0
        for acc in sums:
            if interleaved:
                tot = f32(tot + acc)
                continue
            seg = f32(seg + acc)
            stretches += 1
            if stretches == SEGMENT:
                tot = f32(tot + seg)
                seg[:] = 0
                stretches = 0
        tot = f32(tot + seg)
        for q in range(2):
            plane = planes[q].reshape(2, 2, P, nt2, W2, nt2, W2)
            plane[colour // 2, colour % 2, p, tv2, :, tu2, :] = tot[q]
    return planes


#: The flags the producer writes beside a staged batch (``csrc/gridder.cu``,
#: ``StageInfo``): the item's first and last batch, an item with no batch.
FIRST, LAST, EMPTY = 1, 2, 4


def consumed_k1(args, nt2, *, ts, ctas, seed):
    """K1's planes as its consumers build them (``consume`` and
    ``add_totals`` in ``csrc/gridder.cu``), under the model, in float32
    planes that start as NaN: the schedule's model deals the items
    (pass, anchor run) to ``lanes * ctas`` workers (``k1_schedule``), each
    item's batches arrive as the producer stages them (the first and last
    flagged; an item with no batch one empty stage), and the workers run
    interleaved in a random order (``seed``).  A consumer clears its
    segment at an item's first stage, promotes each batch's sums (its
    tile of :func:`run_sums`) into the segment, and adds the segment into
    the run's totals in the plane every :data:`SEGMENT` batches and at the
    item's last stage: the first add stores ``0 + segment``, later ones
    load, add and store."""
    from tests.test_torch_k1_schedule import k1_layout, k1_schedule

    slot, n, count = args[:3]
    P = args[7].shape[1]
    W2 = 2 * ts
    lay = k1_layout(ts)
    nbc = lay["wp"] // lay["bn"]
    sums = {(c0, p): (colour, tv2, tu2, s)
            for c0, p, colour, tv2, tu2, s in run_sums(args, nt2, ts=ts)}
    shape = (2, 2, P, nt2 * W2, nt2 * W2)
    planes = [np.full(shape, np.nan, np.float32) for _ in range(2)]

    def worker(items):
        for q, c0, nb in items:
            p, t = divmod(q, lay["tiles"])
            r0, k0 = 64 * (t // nbc), lay["bn"] * (t % nbc)
            rows = slice(r0, min(r0 + 64, W2))
            cols = slice(k0, min(k0 + lay["bn"], W2))
            colour, tv2, tu2, accs = sums[c0, p]
            assert len(accs) == nb
            blocks = [pl[colour // 2, colour % 2, p,
                         tv2 * W2 + rows.start:tv2 * W2 + rows.stop,
                         tu2 * W2 + cols.start:tu2 * W2 + cols.stop]
                      for pl in planes]
            stages = [(FIRST if i == 0 else 0) | (LAST if i == nb - 1 else 0)
                      for i in range(nb)] or [FIRST | LAST | EMPTY]

            def add_totals(seg, stored):
                for q2 in range(2):
                    base = blocks[q2].astype(np.float64) if stored else 0.0
                    blocks[q2][:] = base + seg[q2]      # rounds to f32

            for flags, acc in zip(stages, accs or [None]):
                if flags & FIRST:
                    seg = np.zeros((2,) + blocks[0].shape)
                    stretches, stored = 0, False
                if not flags & EMPTY:
                    seg = f32(seg + acc[:, rows, cols])
                    stretches += 1
                    if stretches == SEGMENT:
                        add_totals(seg, stored)
                        seg[:] = 0
                        stored, stretches = True, 0
                if flags & LAST:
                    add_totals(seg, stored)
                yield

    sched = k1_schedule(slot, n, count, P=P, ts=ts, ctas=ctas)
    running = [worker(items) for items in sched]
    rng = np.random.default_rng(seed)
    while running:
        w = running[rng.integers(len(running))]
        if next(w, StopIteration) is StopIteration:
            running.remove(w)
    return planes


def run_blocks(args, nt2, *, ts):
    """Where the anchor runs' blocks lie in the planes (bool)."""
    slot, n = args[:2]
    P = args[7].shape[1]
    W2 = 2 * ts
    mask = np.zeros((2, 2, P, nt2, W2, nt2, W2), bool)
    for c in range(n):
        colour, rem = divmod(int(slot[c]), nt2 * nt2)
        tv2, tu2 = divmod(rem, nt2)
        mask[colour // 2, colour % 2, :, tv2, :, tu2, :] = True
    return mask.reshape(2, 2, P, nt2 * W2, nt2 * W2)


def assert_consumed_is_the_register_schedule(args, nt2, *, ts, ctas, seed):
    """:func:`consumed_k1` writes each run's block and nothing else, each
    value bitwise the register schedule's (:func:`emulated_k1`)."""
    regs = emulated_k1(args, nt2, ts=ts)
    planes = consumed_k1(args, nt2, ts=ts, ctas=ctas, seed=seed)
    mask = run_blocks(args, nt2, ts=ts)
    for a, b in zip(regs, planes):
        assert np.array_equal(~np.isnan(b), mask)
        assert np.array_equal(a[mask], b[mask].astype(np.float64))
    assert np.abs(regs[0]).max() > 0
    return planes


def float64_planes(args, nt2, *, ts):
    slot, n, count, iu, iv, su, sv, sre, sim, table = args
    shape = (2, 2, sre.shape[1], nt2 * 2 * ts, nt2 * 2 * ts)
    r64, i64 = (torch.zeros(shape, dtype=torch.float64) for _ in range(2))
    fused_gridder.grid_planes_plain(
        slot, n, count, iu, iv, su, sv, sre.double(), sim.double(),
        table.to(torch.complex128), r64, i64, ts=ts)
    return r64.numpy(), i64.numpy()


def error_over_peak(planes, ref) -> float:
    peak = max(np.abs(ref[0]).max(), np.abs(ref[1]).max())
    return max(np.abs(planes[0] - ref[0]).max(),
               np.abs(planes[1] - ref[1]).max()) / peak


def full_runs(ksteps, nruns=2):
    """Runs of ``ksteps`` full k-steps of 8 slots each: whole chunks of
    256 slots (32 k-steps) and a last one of the rest."""
    chunks = [256] * (ksteps // 32) + ([8 * (ksteps % 32)]
                                       if ksteps % 32 else [])
    return [len(chunks)] * nruns, chunks * nruns


def test_model_step_truncates_towards_zero():
    """A model step never rounds up: on positive addends it gives at most
    their exact sum and loses at most 8 quanta of 2^-26 of the largest
    (the dropped bits) and one FP32 ulp of the sum; on exact multiples of
    the quantum it is the FP32 truncation of the sum."""
    rng = np.random.default_rng(4)
    acc = f32(rng.uniform(0, 4, size=10000))
    prods = f32(np.ldexp(rng.uniform(0.5, 1, size=(10000, 8)),
                         rng.integers(-30, 3, size=(10000, 8))))
    got = tc_step(acc, prods)
    exact = acc + prods.sum(-1)
    largest = np.maximum(acc, prods.max(-1))
    assert (got <= exact).all()
    assert (exact - got <= 8 * 2.0 ** -26 * 2 * largest
            + np.ldexp(1.0, np.frexp(exact)[1] - 24)).all()
    assert (got < exact).any()
    whole = f32(np.round(rng.uniform(1, 2 ** 20, size=(100, 9))))
    assert np.array_equal(tc_step(whole[:, 0], whole[:, 1:]),
                          truncate_f32(whole.sum(-1)))


#: (ts, K, k-steps of 8 a run): long runs, where the schedule before (one
#: accumulator, 6 adds a k-step, promoted every 32) lost 3-4e-6 on the
#: card, and a run of 4096 k-steps, where plain FP32 adds into the totals
#: (2048 stretches) lost 1.4-1.7e-6.
LONG = [(32, 30, 32), (32, 30, 128), (64, 60, 32)]


@pytest.mark.parametrize("ts,K,ksteps", LONG)
def test_parent_schedule_misses_float64_on_long_runs(ts, K, ksteps):
    args, nt2 = run_inputs(*full_runs(ksteps), ts=ts, K=K, seed=ksteps)
    ref = float64_planes(args, nt2, ts=ts)
    old = emulated_k1(args, nt2, ts=ts, batch=8, promote_every=32,
                      interleaved=True)
    assert error_over_peak(old, ref) > 1e-6


@pytest.mark.parametrize("ts,K,ksteps",
                         [(32, 30, 1), (32, 30, 8)] + LONG + [(64, 60, 8)])
def test_new_schedule_holds_float64(ts, K, ksteps):
    """K1's schedule under the model within 1e-6 of the peak of a float64
    run on runs of 1-128 k-steps; the plain f32 version too."""
    args, nt2 = run_inputs(*full_runs(ksteps), ts=ts, K=K, seed=ksteps)
    ref = float64_planes(args, nt2, ts=ts)
    new = emulated_k1(args, nt2, ts=ts)
    assert error_over_peak(new, ref) <= 1e-6
    shape = (2, 2, 1, nt2 * 2 * ts, nt2 * 2 * ts)
    pr, pi = (torch.zeros(shape) for _ in range(2))
    fused_gridder.grid_planes_plain(*args, pr, pi, ts=ts)
    assert error_over_peak((pr.double().numpy(), pi.double().numpy()),
                           ref) <= 1e-6


#: Runs whose totals take one add and several: a run of 32 k-steps and of
#: 128 (1 and 4 segments of SEGMENT batches of 16 visibilities).
PLANE_CASES = [(32, 30, 32), (32, 30, 128), (64, 60, 32)]


@pytest.mark.parametrize("ts,K,ksteps", PLANE_CASES)
def test_plane_totals_match_the_register_totals(ts, K, ksteps):
    """The run's totals in its block of the plane, as the consumers add
    them (:func:`consumed_k1`: items dealt to 3 CTAs' workers by the
    schedule's model, at ts 64 each run two tiles on two workers, the
    workers interleaved at random), give planes bitwise equal to totals
    kept in registers (the kernel's schedule before): every run's block
    written, nothing else, by the same IEEE adds in the same order."""
    args, nt2 = run_inputs(*full_runs(ksteps, nruns=3), ts=ts, K=K,
                           seed=ksteps + 1)
    assert_consumed_is_the_register_schedule(args, nt2, ts=ts, ctas=3,
                                             seed=ksteps)


def boundary_runs():
    """Runs at K1's promotion boundaries: the middle run of three holds
    ``PROMOTE_STEPS`` - 1, ``PROMOTE_STEPS`` and ``PROMOTE_STEPS`` + 1
    k-steps of 8 (the last one partial), in one chunk or over several
    with an empty one inside, or one segment's batches and one more,
    between runs of 13 and 7 slots."""
    c = fused_gridder.PROMOTE_STEPS
    cases = {}
    for k in (c - 1, c, c + 1):
        if k < 1:
            continue
        cases[f"{k} in 1 chunk"] = ([1, 1, 1], [13, 8 * k - 3, 7])
        cases[f"{k} over {k + 1} chunks, one empty"] = (
            [1, k + 1, 1], [13, 0] + [8] * (k - 1) + [5, 7])
    # a segment of SEGMENT batches, and one batch more
    full = SEGMENT * fused_gridder.BATCH
    cases[f"{full // 8} in {full // 256} chunks"] = (
        [1, full // 256, 1], [13] + [256] * (full // 256) + [7])
    cases[f"{full // 8 + 1} in {full // 256 + 1} chunks"] = (
        [1, full // 256 + 1, 1], [13] + [256] * (full // 256) + [5, 7])
    return cases


BOUNDARY = boundary_runs()


@pytest.mark.parametrize("case", ["64 in 2 chunks", "65 in 3 chunks"])
def test_plane_totals_at_a_segment_boundary(case):
    """A run of exactly one segment of batches (its last batch adds the
    segment into the plane's totals and then the cleared segment once
    more, as the register schedule did) and one batch more, beside a run
    of two empty chunks (an item with no batch: its block holds zeros),
    as the consumers build them: bitwise equal to the register
    schedule."""
    runs, counts = BOUNDARY[case]
    args, nt2 = run_inputs(runs + [2], counts + [0, 0], ts=32, K=30,
                           seed=len(counts))
    planes = assert_consumed_is_the_register_schedule(
        args, nt2, ts=32, ctas=2, seed=len(counts))
    colour, rem = divmod(int(args[0][sum(runs)]), nt2 * nt2)  # the empty
    tv2, tu2 = divmod(rem, nt2)
    for plane in planes:
        assert (plane[colour // 2, colour % 2, 0, 64 * tv2:64 * tv2 + 64,
                      64 * tu2:64 * tu2 + 64] == 0).all()


@pytest.mark.parametrize("case", list(BOUNDARY))
def test_new_schedule_at_the_promotion_boundary(case):
    """Runs of ``PROMOTE_STEPS`` - 1, ``PROMOTE_STEPS`` and
    ``PROMOTE_STEPS`` + 1 k-steps under the model: K1 walks the middle
    run in batches of ``BATCH`` slots that never span a chunk (the empty
    chunk skipped), one stretch each; every run's block is written and
    nothing else, within 1e-6 of the peak of a float64 run."""
    runs, counts = BOUNDARY[case]
    ts, K = 32, 30
    args, nt2 = run_inputs(runs, counts, ts=ts, K=K, seed=len(counts))
    slot, n, count = args[:3]
    middle = run_batches(slot, n, count, fused_gridder.BATCH)[runs[0]]
    live = [min(fused_gridder.BATCH, int(count[c]) - m0) for c, m0 in middle]
    assert sum(-(-k // 8) for k in live) == int(case.split()[0])
    assert len(middle) == sum(-(-int(k) // fused_gridder.BATCH)
                              for k in counts[runs[0]:runs[0] + runs[1]])
    assert min(live) > 0
    ref = float64_planes(args, nt2, ts=ts)
    new = emulated_k1(args, nt2, ts=ts)
    written = fused_gridder.occupancy(slot, n, nt2).repeat_interleave(
        2 * ts, -2).repeat_interleave(2 * ts, -1)[:, :, None].numpy()
    assert int(written.sum()) == len(runs) * (2 * ts) ** 2
    for plane in new:
        assert not plane[~written].any()
    assert error_over_peak(new, ref) <= 1e-6


def test_plain_k1_holds_the_jax_gridder_on_long_runs():
    """The plain f32 K1 (the kernel's reference) against the JAX Pallas
    gridder (interpret mode) on a plan whose anchor runs span many
    chunks (3000 visibilities within a few tiles, chunks of 64): within
    2e-5 of the largest written value, and both within 1e-6 of the peak
    of the plain K1 run in float64."""
    pixels, K, ts, mc, n = 256, 16, 32, 64, 3000
    rng = np.random.default_rng(21)
    kernel = (rng.normal(size=(4, 8, K))
              + 1j * rng.normal(size=(4, 8, K))).astype(np.complex64)
    uv = np.clip(rng.normal(scale=6.0, size=(n, 2)), -20, 20).astype(
        np.int16)
    sub = rng.integers(0, 8, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, 4, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, 1))
           + 1j * rng.normal(size=(n, 1))).astype(np.complex64)
    wg = rng.uniform(0.5, 2.0, size=(1, pixels, pixels)).astype(np.float32)
    plan = mxu_gridder.plan_chunks_tiled(
        uv, sub, wp, vis, np.ones_like(vis, np.float32), pixels=pixels,
        kernel_width=K, ts=ts, mc=mc)
    arrays = (plan.uv, plan.sub_uv, plan.w_plane, plan.vis, plan.anchor,
              plan.valid)
    nc = int(plan.valid.any(axis=1).sum())
    accr, acci, occ = pallas_gridder._grid_chunks_planes(
        jnp.asarray(kernel), jnp.asarray(wg), *(jnp.asarray(a)
                                                for a in arrays),
        None, None, pixels=pixels, ts=ts, num_pols=1, interpret=True)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    kt, wgt = torch.from_numpy(kernel), torch.from_numpy(wg)
    kr, ki, kocc = fused_gridder.grid_chunks_planes(
        kt, wgt, *t, None, nc, pixels=pixels, ts=ts)
    np.testing.assert_array_equal(kocc.numpy(), np.asarray(occ))
    slot = fused_gridder.chunk_slots(t[4], nc, ts=ts,
                                     nt2=mxu_gridder.colour_tiles(pixels,
                                                                  ts))
    runs = run_batches(slot, nc, fused_gridder.valid_counts(t[5]), 8)
    assert max(len(b) for b in runs.values()) > 32      # long runs
    # the float64 run of the plain K1 on the same inputs
    iu, iv, su, sv = fused_gridder.tap_indices(kt, t[0], t[1], t[2], t[4],
                                               pixels=pixels, ts=ts)
    sre, sim = fused_gridder.samples(t[3], t[5], wgt, None, t[4], su, sv,
                                     kernel_width=K, ts=ts)
    nt2 = mxu_gridder.colour_tiles(pixels, ts)
    shape = (2, 2, 1, nt2 * 2 * ts, nt2 * 2 * ts)
    r64, i64 = (torch.zeros(shape, dtype=torch.float64) for _ in range(2))
    fused_gridder.grid_planes_plain(
        slot, nc, fused_gridder.valid_counts(t[5]), iu, iv, su, sv,
        sre.double(), sim.double(),
        fused_gridder.conj_table(kt).to(torch.complex128), r64, i64, ts=ts)
    written = np.repeat(np.repeat(np.asarray(occ), 2 * ts, -2), 2 * ts,
                        -1)[:, :, None]
    ref = [np.where(written, x.numpy(), 0) for x in (r64, i64)]
    jax_planes = [np.where(written, np.asarray(x), 0) for x in (accr, acci)]
    port = [np.where(written, x.numpy(), 0) for x in (kr, ki)]
    scale = max(np.abs(jax_planes[0]).max(), np.abs(jax_planes[1]).max())
    for got, want in zip(port, jax_planes):
        assert np.abs(got - want).max() <= 2e-5 * scale
    assert error_over_peak(jax_planes, ref) <= 1e-6
    assert error_over_peak(port, ref) <= 1e-6
