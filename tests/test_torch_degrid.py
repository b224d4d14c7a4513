"""The port's image -> grid transform (K6 + K7 plain versions, and the
plain formula) and fused degridder (K5 plain version,
``degrid_slice``) against the JAX fused Pallas kernels
(interpret mode) and the numpy scatter degrid oracle.

Tolerances: 1e-5 of peak throughout.  Measured here: K6 + K7 within
3.2e-7 of the grid's peak (f32 DFT rounding at N = 256); K5 within 1.5e-7
of the largest prediction against JAX and 5e-7 against the oracle (f32
sums of K^2 = 256 taps in another order).
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from katsdpimager_tpu.ops import fourier as jax_fourier
from katsdpimager_tpu.ops import gridder
from katsdpimager_tpu.ops import mxu_gridder as jax_mxu
from katsdpimager_tpu.ops import pallas_fft, pallas_gridder
from katsdpimager_tpu_torch.ops import (fourier, fused_degrid, fused_fft,
                                        fused_gridder, mxu_gridder)
from katsdpimager_tpu_torch.parallel import cube

torch.set_num_threads(2)

N = 256
W, PS = 123.0, 1.0 / (N * 16)
K, TS, O, WP, MC = 16, 32, 8, 4, 64


def image_case(P):
    rng = np.random.default_rng(200 + P)
    img = rng.normal(size=(P, N, N)).astype(np.float32)
    k1d = (0.5 + rng.uniform(0.2, 1.0, size=N)).astype(np.float32)
    return img, k1d


def transposed(img):
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(img, 1, 2)))


@pytest.fixture(scope="module")
def jax_grids():
    """JAX ``image_to_grid_fused_parts`` (Pallas, interpret mode) per
    polarization count."""
    memo = {}

    def get(P):
        if P not in memo:
            img, k1d = image_case(P)
            gr, gi = pallas_fft.image_to_grid_fused_parts(
                jnp.asarray(np.swapaxes(img, 1, 2)), jnp.asarray(k1d), W, PS,
                pixels=N)
            memo[P] = ((img, k1d), np.asarray(gr), np.asarray(gi))
        return memo[P]

    return get


def assert_grid_close(got, ref_r, ref_i):
    peak = max(np.abs(ref_r).max(), np.abs(ref_i).max())
    np.testing.assert_allclose(got[0].numpy(), ref_r, atol=1e-5 * peak)
    np.testing.assert_allclose(got[1].numpy(), ref_i, atol=1e-5 * peak)


@pytest.mark.parametrize("P", [1, 2])
def test_k6_k7_plain_match_jax(jax_grids, P):
    """K6 then K7 (plain versions) on the transposed image, element for
    element against the JAX fused pair: the orientation is the JAX one."""
    (img, k1d), gr, gi = jax_grids(P)
    got = fused_fft.image_to_grid_fused_parts(
        transposed(img), torch.from_numpy(k1d), W, PS)
    assert_grid_close(got, gr, gi)


@pytest.mark.parametrize("P", [1, 2])
def test_image_to_grid_parts_matches_jax(jax_grids, P):
    """The routing entry (CPU: the plain formula) against the JAX routing
    entry on its fused Pallas path."""
    (img, k1d), gr, gi = jax_grids(P)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KTPU_FFT", "pallas")
        assert jax_fourier._use_pallas_fft(N, np.float32)
        jr, ji = jax_fourier.image_to_grid_parts_impl(
            jnp.asarray(img), jnp.asarray(k1d), W, PS, pixels=N)
    np.testing.assert_array_equal(np.asarray(jr), gr)
    np.testing.assert_array_equal(np.asarray(ji), gi)
    got = fourier.image_to_grid_parts(torch.from_numpy(img),
                                      torch.from_numpy(k1d), W, PS)
    assert_grid_close(got, gr, gi)


def test_plain_k7_is_cb_times_col_fft():
    """The plain K7 is the JAX column DFT (sign -1) times the
    checkerboard, untransposed."""
    img, _ = image_case(1)
    xr, xi = img, img[:, ::-1].copy()
    yr, yi = pallas_fft.col_fft(jnp.asarray(xr), jnp.asarray(xi), -1)
    cb = np.where((np.arange(N)[:, None] + np.arange(N)[None, :]) % 2,
                  -1.0, 1.0).astype(np.float32)
    tr, ti = fused_fft.cbout_col_fft_plain(torch.from_numpy(xr),
                                           torch.from_numpy(xi))
    assert_grid_close((tr, ti), np.asarray(yr) * cb, np.asarray(yi) * cb)


def test_image_to_grid_inverts_grid_to_image():
    """image -> grid -> image is ``img * N^2 / taper^4``: the transforms
    are unnormalised, ``n`` cancels, and both directions divide by the
    taper (the kernel's transform is convolved in on both paths)."""
    img, k1d = image_case(1)
    g = fourier.image_to_grid(torch.from_numpy(img).double(),
                              torch.from_numpy(k1d).double(), W, PS)
    back = fourier.grid_to_image(g, torch.zeros((1, N, N),
                                                dtype=torch.float64),
                                 torch.from_numpy(k1d).double(), W, PS)
    t2 = np.outer(k1d.astype(np.float64), k1d.astype(np.float64))
    np.testing.assert_allclose(back.numpy() / N ** 2 * t2 * t2, img,
                               atol=1e-9)


# ---------------------------------------------------------------------------
# K5


def degrid_case(seed, P, n=600):
    """uv drawn across the whole grid (every kernel footprint inside it,
    the scatter oracle's domain), so tile-edge shifts all occur."""
    rng = np.random.default_rng(seed)
    kernel = (rng.normal(size=(WP, O, K))
              + 1j * rng.normal(size=(WP, O, K))).astype(np.complex64)
    uv_bias = (K - 1) // 2 - N // 2
    uv = (rng.integers(0, N - K + 1, size=(n, 2)) + uv_bias).astype(np.int16)
    sub = rng.integers(0, O, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, WP, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, P))
           + 1j * rng.normal(size=(n, P))).astype(np.complex64)
    wt = rng.uniform(0.5, 2.0, size=(n, P)).astype(np.float32)
    grid = (rng.normal(size=(P, N, N))
            + 1j * rng.normal(size=(P, N, N))).astype(np.complex64)
    plan = mxu_gridder.plan_chunks_tiled(uv, sub, wp, vis, wt, pixels=N,
                                         kernel_width=K, ts=TS, mc=MC)
    return dict(kernel=kernel, uv=uv, sub=sub, wp=wp, vis=vis, wt=wt,
                grid=grid, plan=plan,
                nc=int(plan.valid.any(axis=1).sum()))


def plan_arrays(plan):
    return (plan.uv, plan.sub_uv, plan.w_plane, plan.weights, plan.vis,
            plan.anchor, plan.valid)


def port_degrid(case, n_chunks="count"):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in plan_arrays(case["plan"])]
    g = case["grid"]
    grid = (torch.from_numpy(np.ascontiguousarray(g.real)),
            torch.from_numpy(np.ascontiguousarray(g.imag)))
    nc = case["nc"] if n_chunks == "count" else n_chunks
    return fused_degrid.degrid_slice(
        grid, torch.from_numpy(case["kernel"]), *t, nc, pixels=N, ts=TS)


@pytest.fixture(scope="module")
def jax_degrid():
    """JAX ``degrid_chunks_impl(assembly="pallas", tile_aligned=True)``
    (interpret mode) per polarization count."""
    memo = {}

    def get(P):
        if P not in memo:
            case = degrid_case(300 + P, P)
            g = case["grid"]
            out = jax_mxu.degrid_chunks_impl(
                (jnp.asarray(g.real), jnp.asarray(g.imag)),
                jnp.asarray(case["kernel"]),
                *(jnp.asarray(a) for a in plan_arrays(case["plan"])),
                jnp.asarray(case["nc"], jnp.int32), pixels=N, rv=TS, ru=TS,
                assembly="pallas", tile_aligned=True)
            memo[P] = (case, np.asarray(out))
        return memo[P]

    return get


@pytest.mark.parametrize("P", [1, 2])
def test_degrid_matches_jax_fused(jax_degrid, P):
    case, ref = jax_degrid(P)
    got = port_degrid(case).numpy()
    scale = np.abs(case["plan"].vis - ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale)


@pytest.mark.parametrize("P", [1, 2])
def test_degrid_matches_scatter_oracle(jax_degrid, P):
    case, _ = jax_degrid(P)
    plan = case["plan"]
    got = port_degrid(case).numpy()[plan.row_chunk, plan.row_slot]
    oracle = gridder.degrid_vis_reference(
        case["grid"], case["kernel"], case["uv"], case["sub"], case["wp"],
        case["wt"], case["vis"])
    scale = np.abs(case["vis"] - oracle).max()
    np.testing.assert_allclose(got, oracle, atol=1e-5 * scale)


def test_plain_k5_matches_jax_kernel_output(jax_degrid):
    """The plain K5 alone, masked and weighted as the caller does, is the
    JAX prediction; chunks past ``n`` and slots past a chunk's valid
    count predict exactly zero."""
    case, ref = jax_degrid(1)
    plan = case["plan"]
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in
         (plan.uv, plan.sub_uv, plan.w_plane, plan.anchor, plan.valid)]
    g = case["grid"]
    kernel = torch.from_numpy(case["kernel"])
    av, au, iu, iv, su, sv = fused_degrid.degrid_taps(kernel, *t[:4],
                                                      pixels=N, ts=TS)
    pred = fused_degrid.degrid_planes(
        torch.from_numpy(np.ascontiguousarray(g.real)),
        torch.from_numpy(np.ascontiguousarray(g.imag)), av, au,
        fused_gridder.valid_counts(t[4]), iu, iv, su, sv,
        fused_degrid.degrid_table(kernel), case["nc"], ts=TS)
    assert not pred[case["nc"]:].any()
    assert not pred.numpy()[~plan.valid].any()
    got = plan.vis - plan.weights * (pred.numpy() * plan.valid[..., None])
    scale = np.abs(plan.vis - ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale)


def test_padding_chunks_pass_through():
    """``n_chunks = 0`` predicts nothing: every visibility comes back
    unchanged; counting the chunks on the device gives the host count's
    result."""
    case = degrid_case(11, 1, n=300)
    vis = torch.from_numpy(case["plan"].vis)
    assert torch.equal(port_degrid(case, n_chunks=0), vis)
    assert torch.equal(port_degrid(case, n_chunks=None), port_degrid(case))


def test_shifts_and_anchors_in_range():
    """Shifts clamp to [0, ts - 1] (inside the JAX kernel's [0, 2ts - K])
    and anchors to [0, ext - 2ts]."""
    case = degrid_case(12, 1, n=500)
    plan = case["plan"]
    av, au, iu, iv, su, sv = fused_degrid.degrid_taps(
        torch.from_numpy(case["kernel"]),
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in
          (plan.uv, plan.sub_uv, plan.w_plane, plan.anchor)),
        pixels=N, ts=TS)
    ext = mxu_gridder.dense_pad_size(N, TS)
    for s in (su, sv):
        assert int(s.min()) >= 0 and int(s.max()) <= TS - 1 <= 2 * TS - K
    for a in (av, au):
        assert int(a.min()) >= 0 and int(a.max()) <= ext - 2 * TS
    assert int(iu.max()) < WP * O and int(iv.max()) < WP * O


@pytest.mark.parametrize("rv,ru,width", [(32, 16, 16), (32, 32, 40)])
def test_unported_layouts_raise(rv, ru, width):
    """Where the JAX package falls back to an XLA assembly, the port
    raises: the cube's degridding stage for ``rv != ru``, the slice's
    entry point for a kernel wider than ``ts + 1``."""
    if rv != ru:
        cfg = cube.CubeConfig(
            pixels=N, num_pols=1, kernel_width=width, oversample=O,
            w_planes=WP, w_slices=1, chunks_per_slice=1, chunk_size=1,
            rv=rv, ru=ru)
        with pytest.raises(NotImplementedError):
            cube._degrid_slices(cfg, *[None] * 13)
        return
    case = degrid_case(13, 1, n=50)
    case["kernel"] = np.zeros((WP, O, width), np.complex64)
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in plan_arrays(case["plan"])]
    g = torch.zeros((1, N, N))
    with pytest.raises(NotImplementedError):
        fused_degrid.degrid_slice(
            (g, g), torch.from_numpy(case["kernel"]), *t, pixels=N, ts=rv)


@pytest.mark.parametrize("P", [1, 2])
def test_plain_k5_count_matches_jax_degrid_chunks_fused(jax_degrid, P):
    """The plain K5 with each chunk's valid count against the JAX
    ``degrid_chunks_fused`` (Pallas, interpret mode) on the valid slots,
    within 1e-5 of the largest prediction; every other slot exactly
    zero."""
    case, _ = jax_degrid(P)
    plan, g, kernel = case["plan"], case["grid"], case["kernel"]
    ref = np.asarray(pallas_gridder.degrid_chunks_fused(
        (jnp.asarray(g.real), jnp.asarray(g.imag)), jnp.asarray(kernel),
        jnp.asarray(plan.uv), jnp.asarray(plan.sub_uv),
        jnp.asarray(plan.w_plane), jnp.asarray(plan.anchor), case["nc"],
        pixels=N, ts=TS, interpret=True))
    t = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in dict(
        uv=plan.uv, sub=plan.sub_uv, wp=plan.w_plane, anc=plan.anchor,
        valid=plan.valid).items()}
    av, au, iu, iv, su, sv = fused_degrid.degrid_taps(
        torch.from_numpy(kernel), t["uv"], t["sub"], t["wp"], t["anc"],
        pixels=N, ts=TS)
    count = fused_gridder.valid_counts(t["valid"])
    got = fused_degrid.degrid_planes_plain(
        torch.from_numpy(np.ascontiguousarray(g.real)),
        torch.from_numpy(np.ascontiguousarray(g.imag)), av, au, count, iu,
        iv, su, sv, fused_degrid.degrid_table(torch.from_numpy(kernel)),
        case["nc"], ts=TS).numpy()
    valid = plan.valid
    assert valid[:case["nc"]].sum() == len(case["uv"])
    scale = np.abs(ref[valid]).max()
    np.testing.assert_allclose(got[valid], ref[valid], atol=1e-5 * scale)
    assert not got[~valid].any()


def _direct_k5_inputs(seed, *, ts, K, P, counts, Mc=64, WO=16, pixels=160):
    """Direct K5 inputs: anchors on tiles up to the grid's edge (windows
    that cross it), shifts anywhere in [0, ts - 1], random taps."""
    rng = np.random.default_rng(seed)
    NC = len(counts)
    hi = mxu_gridder.dense_pad_size(pixels, ts) - 2 * ts
    av, au = (rng.integers(0, hi // ts + 1, size=NC).astype(np.int32) * ts
              for _ in range(2))
    iu, iv = (rng.integers(0, WO, size=(NC, Mc)).astype(np.int32)
              for _ in range(2))
    su, sv = (rng.integers(0, ts, size=(NC, Mc)).astype(np.int32)
              for _ in range(2))
    table = (rng.normal(size=(WO, K))
             + 1j * rng.normal(size=(WO, K))).astype(np.complex64)
    gr, gi = (rng.normal(size=(P, pixels, pixels)).astype(np.float32)
              for _ in range(2))
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (gr, gi, av, au, np.asarray(counts, np.int32), iu, iv, su, sv,
             table)]


@pytest.mark.parametrize("ts,K,P", [(32, 16, 2), (24, 25, 1)])
def test_k5_slots_past_count_are_zero(ts, K, P):
    """The plain K5 predicts the first ``count[c]`` slots of each chunk
    below ``n`` exactly as with every slot counted, and zero for the rest
    and for every chunk past ``n``."""
    counts = [64, 0, 1, 31, 63, 7, 64, 5]
    gr, gi, av, au, count, iu, iv, su, sv, table = _direct_k5_inputs(
        ts + K, ts=ts, K=K, P=P, counts=counts)
    n = 6
    got = fused_degrid.degrid_planes(gr, gi, av, au, count, iu, iv, su, sv,
                                     table, n, ts=ts)
    full = fused_degrid.degrid_planes_plain(
        gr, gi, av, au, torch.full_like(count, 64), iu, iv, su, sv, table,
        len(counts), ts=ts)
    live = torch.arange(64)[None, :] < count[:, None]
    live[n:] = False
    scale = full[live].abs().max().item()
    assert (got[live] - full[live]).abs().max().item() <= 1e-6 * scale
    assert not got[~live].any()
    assert full[~live].abs().max() > 0


def _tiled_pairs():
    """Every (ts, K) that ``tile_size`` gives for the kernel widths the
    tile-aligned planner takes (K <= ts), up to K = 256."""
    return sorted({(mxu_gridder.tile_size(n, k), k)
                   for n in range(16, 1100, 4) for k in range(1, 257)})


@pytest.mark.parametrize("pixels,K", [(256, 16), (512, 7), (320, 40),
                                      (1024, 64), (384, 96)])
def test_valid_shifts_lie_in_first_tile(pixels, K):
    """On planner output (uv anywhere a footprint fits the grid), every
    valid slot's shift lies in [0, ts - 1], so the clamp in
    :func:`fused_degrid.degrid_taps` leaves it as it is and a chunk's taps
    reach at most K + ts - 1 rows and columns from its anchor, inside the
    padded grid."""
    ts = mxu_gridder.tile_size(pixels, K)
    rng = np.random.default_rng(pixels + K)
    n = 4000
    uv_bias = (K - 1) // 2 - pixels // 2
    uv = (rng.integers(0, pixels - K + 1, size=(n, 2)) + uv_bias)
    uv[:4] = np.array([[0, 0], [pixels - K, 0], [0, pixels - K],
                       [pixels - K, pixels - K]]) + uv_bias
    uv = uv.astype(np.int16)
    sub = rng.integers(0, 8, size=(n, 2)).astype(np.int16)
    wp = np.zeros(n, np.int16)
    vis = np.ones((n, 1), np.complex64)
    plan = mxu_gridder.plan_chunks_tiled(uv, sub, wp, vis,
                                         np.ones((n, 1), np.float32),
                                         pixels=pixels, kernel_width=K,
                                         ts=ts, mc=MC)
    raw = (plan.uv.astype(np.int64) - uv_bias
           - plan.anchor[:, None, ::-1].astype(np.int64))
    valid = plan.valid
    assert valid.sum() == n
    assert raw[valid].min() >= 0 and raw[valid].max() <= ts - 1
    av, au, iu, iv, su, sv = fused_degrid.degrid_taps(
        torch.zeros((1, 8, K), dtype=torch.complex64),
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in
          (plan.uv, plan.sub_uv, plan.w_plane, plan.anchor)),
        pixels=pixels, ts=ts)
    assert np.array_equal(su.numpy()[valid], raw[..., 0][valid])
    assert np.array_equal(sv.numpy()[valid], raw[..., 1][valid])
    occupied = valid.any(axis=1)
    assert np.array_equal(av.numpy()[occupied], plan.anchor[occupied, 0])
    assert np.array_equal(au.numpy()[occupied], plan.anchor[occupied, 1])
    ext = mxu_gridder.dense_pad_size(pixels, ts)
    assert int(av.max()) + ts - 1 + K <= ext
    assert int(au.max()) + ts - 1 + K <= ext


#: K5's constants (``csrc/degrid_layout.h``) that its window model needs:
#: a block's 16-byte loads per plane (2 per thread of 256), and the offset
#: of half-warp 1's kv taps and the length of a warp's kv row.
K5_BLOCK_LOADS, K5_KV_HALF, K5_KV_ROW = 512, 34, 68
#: The dynamic shared memory of one CUDA block on an H100 (227 KB).
K5_MAX_SMEM = 232448


@pytest.fixture(scope="module")
def k5_layout(tmp_path_factory):
    """K5's layout choice, ``ktt_degrid_layout`` from
    ``csrc/degrid_layout.h`` (the code the CUDA launcher runs), built with
    g++: ``(ts, K, Mc, P)`` to a dict, ``ValueError`` where none fits."""
    src = os.path.join(os.path.dirname(fused_degrid.__file__), os.pardir,
                       "csrc", "degrid_layout.h")
    lib = str(tmp_path_factory.mktemp("k5") / "libk5layout.so")
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-x",
                    "c++", src, "-o", lib], check=True, capture_output=True)
    fn = ctypes.CDLL(lib).ktt_degrid_layout
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int

    def layout(ts, K, Mc, P):
        out = (ctypes.c_int * 5)()
        if fn(ts, K, Mc, P, out):
            raise ValueError(f"no K5 layout for ts={ts}, K={K}, Mc={Mc}, "
                             f"P={P}")
        return dict(zip(("stride", "rows", "ring", "pass_rows", "smem"),
                        out))

    return layout


def _window_model(sv, su, ts, K, P, layout):
    """numpy model of ``csrc/degrid.cu``'s sliding window for one chunk
    whose valid slots have shifts ``sv``/``su``: the footprint box, the
    groups of row shifts, the passes of tap rows, the blocks staged into
    the ring and, per (slot, polarization, tap row), how often the lanes
    sum it.  Asserts that every row a slot reads was stored before the
    group's barrier into the ring slot it is read from, that no block
    overwrites one a group still needs, that a block's 16-byte loads fit
    the threads' registers, and every buffer index in range."""
    S, D, R, Kj = (layout[k] for k in ("stride", "rows", "ring",
                                       "pass_rows"))
    assert S % 4 == 0 and S >= K + ts + 2
    rlo, span = int(sv.min()), int(sv.max() - sv.min())
    clo = int(su.min()) & ~3
    ncols = min((int(su.max()) + K - clo + 3) & ~3, S)
    assert ncols == (int(su.max()) + K - clo + 3) & ~3
    assert D * (ncols // 4) <= K5_BLOCK_LOADS
    taps = np.minimum(np.arange(16 * -(-K // 16)), K - 1)  # lanes b + 16 t
    cols = su[:, None] - clo + taps
    assert cols.min() >= 0 and cols.max() < ncols <= S
    ng = span // D + 1
    group = (sv - rlo) // D
    assert group.max() < ng <= -(-ts // D)
    covered = np.zeros((len(sv), P, K), np.int64)
    for j0 in range(0, K, Kj):
        kh = min(Kj, K - j0)
        E = -(-(D + kh - 1) // D)
        assert R >= E + 1
        nblk = -(-(span + kh) // D)
        holds = np.full(R, -1)         # the block each ring slot holds
        snap = np.empty((ng, R), np.int64)
        landed = np.empty(ng, np.int64)

        def issue(q, g):
            if q < nblk:
                assert holds[q % R] < g        # group g needs blocks >= g
                holds[q % R] = q

        for q in range(E):
            issue(q, 0)
        for g in range(ng):
            landed[g] = E + g                  # wait_group 0, the barrier
            snap[g] = holds                    # what group g reads from
            issue(g + E, g)
        # half-warp h: tap rows [h hrows, h hrows + nr); its kv taps at
        # h * K5_KV_HALF + r in the warp's kv row, read in pairs from even r
        hrows = (kh + 1) // 2
        jj = np.concatenate([h * hrows + np.arange(max(min(
            hrows, kh - h * hrows), 0)) for h in (0, 1)])
        slot = np.where(jj < hrows, jj, K5_KV_HALF + jj - hrows)
        assert slot.max() < K5_KV_ROW and hrows <= 32
        y = (sv - rlo)[:, None] + jj                    # pass rows read
        blk = y // D
        assert (blk < landed[group][:, None]).all() and (blk < nblk).all()
        assert (snap[group[:, None], blk % R] == blk).all()
        assert ((y % (R * D)) // D == blk % R).all()
        for p in range(P):
            np.add.at(covered[:, p], (np.arange(len(sv))[:, None], j0 + jj),
                      1)
    return covered


def test_k5_window_schedule_covers_each_tap_row_once(k5_layout):
    """For every (ts, K) that ``tile_size`` gives, at Mc = 256 and P in
    (1, 4): the layout fits a CUDA block's shared memory, and the sliding
    window sums every (valid slot, polarization, tap row) exactly once,
    each from rows that have landed, for chunks of 1 slot, of slots at
    both shift extremes, and of random shifts."""
    rng = np.random.default_rng(7)
    pairs = _tiled_pairs()
    assert (64, 60) in pairs and (96, 96) in pairs and (8, 3) in pairs
    for ts, K in pairs:
        for P in (1, 4):
            layout = k5_layout(ts, K, 256, P)
            assert K + ts + 2 <= layout["stride"] < K + ts + 6
            assert layout["smem"] <= K5_MAX_SMEM
        P = 2 if ts % 7 == 0 else 1
        layout = k5_layout(ts, K, 256, P)
        chunks = [np.zeros((2, 1), np.int64),
                  np.array([[0, ts - 1, 0, ts - 1], [ts - 1, 0, 0, ts - 1]]),
                  rng.integers(0, ts, size=(2, 37))]
        for sv, su in chunks:
            cov = _window_model(sv, su, ts, K, P, layout)
            assert (cov == 1).all(), (ts, K)


@pytest.mark.parametrize("ts,K", [(16, 18), (64, 257), (1024, 1000)])
def test_k5_layout_raises_where_it_cannot_run(k5_layout, ts, K):
    """K > ts + 1 and K > 256 have no layout."""
    with pytest.raises(ValueError):
        k5_layout(ts, K, 256, 1)


def test_k5_layout_raises_beyond_shared_memory(k5_layout):
    """Where the slot accumulators alone pass a CUDA block's shared memory
    (Mc * P * 8 bytes > 227 KB) there is no layout; at P = 100 one fits,
    with fewer rows per block and per pass."""
    with pytest.raises(ValueError):
        k5_layout(64, 60, 256, 128)
    fits = k5_layout(64, 60, 256, 100)
    assert fits["rows"] < 16 and fits["pass_rows"] < 60
    assert fits["smem"] <= K5_MAX_SMEM
