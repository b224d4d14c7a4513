"""The port's fused gridder (K1 + K2, plain versions on the CPU) against
the JAX fused Pallas gridder (interpret mode) and the scatter oracle.

Each JAX reference runs once per module (interpret mode is slow)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from katsdpimager_tpu.ops import gridder
from katsdpimager_tpu.ops import mxu_gridder as jax_mxu
from katsdpimager_tpu.ops import pallas_gridder
from katsdpimager_tpu_torch.ops import fused_gridder, mxu_gridder

torch.set_num_threads(2)

PIXELS, K, TS, MC = 256, 16, 64, 128


def make_case(seed, *, num_pols=1, n=1000, w_planes=4, oversample=8):
    rng = np.random.default_rng(seed)
    kernel = (rng.normal(size=(w_planes, oversample, K))
              + 1j * rng.normal(size=(w_planes, oversample, K))
              ).astype(np.complex64)
    lim = PIXELS // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    sub = rng.integers(0, oversample, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, w_planes, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, num_pols))
           + 1j * rng.normal(size=(n, num_pols))).astype(np.complex64)
    wg = rng.uniform(0.5, 2.0, size=(num_pols, PIXELS, PIXELS)
                     ).astype(np.float32)
    plan = mxu_gridder.plan_chunks_tiled(
        uv, sub, wp, vis, np.ones_like(vis, np.float32), pixels=PIXELS,
        kernel_width=K, ts=TS, mc=MC)
    return dict(kernel=kernel, uv=uv, sub=sub, wp=wp, vis=vis, wg=wg,
                plan=plan)


def plan_arrays(case):
    p = case["plan"]
    return (p.uv, p.sub_uv, p.w_plane, p.vis, p.anchor, p.valid)


def port_grid(case, *, density=True, n_chunks=None, **kw):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in plan_arrays(case)]
    wg = torch.from_numpy(case["wg"]) if density else None
    return mxu_gridder.grid_chunks_parts(
        torch.from_numpy(case["kernel"]), wg, *t, None, n_chunks,
        pixels=PIXELS, ts=TS, **kw)


#: (num_pols, density grid, n_chunks given): every value of each axis
CASES = {
    "p1-density-n": (1, True, True),
    "p1-natural-none": (1, False, False),
    "p4-density-none": (4, True, False),
    "p4-natural-n": (4, False, True),
}


@pytest.fixture(scope="module")
def jax_grids():
    """JAX ``grid_chunks_parts_impl(..., assembly="pallas")`` per case,
    computed at first use."""
    memo = {}

    def get(name):
        if name not in memo:
            P, density, given = CASES[name]
            case = make_case(11 + list(CASES).index(name), num_pols=P,
                             n=1000 if P == 1 else 500)
            nc = int(case["plan"].valid.any(axis=1).sum()) if given else None
            gr, gi = jax_mxu.grid_chunks_parts_impl(
                jnp.asarray(case["kernel"]),
                jnp.asarray(case["wg"]) if density else None,
                *(jnp.asarray(a) for a in plan_arrays(case)), None,
                None if nc is None else jnp.asarray(nc, jnp.int32),
                pixels=PIXELS, ts=TS, assembly="pallas")
            memo[name] = (case, nc, np.asarray(gr), np.asarray(gi))
        return memo[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_fused(jax_grids, name):
    case, nc, gr, gi = jax_grids(name)
    _, density, _ = CASES[name]
    tr, ti = port_grid(case, density=density, n_chunks=nc)
    scale = max(np.abs(gr).max(), np.abs(gi).max())
    np.testing.assert_allclose(tr.numpy(), gr, atol=2e-5 * scale)
    np.testing.assert_allclose(ti.numpy(), gi, atol=2e-5 * scale)


def test_matches_scatter_oracle():
    case = make_case(77, n=800)
    tr, ti = port_grid(case)
    oracle = gridder.grid_vis_reference(
        np.zeros((1, PIXELS, PIXELS), np.complex64), case["kernel"],
        case["wg"], case["uv"], case["sub"], case["wp"], case["vis"])
    got = tr.numpy() + 1j * ti.numpy()
    np.testing.assert_allclose(got, oracle,
                               atol=2e-4 * np.max(np.abs(oracle)))


def test_plain_combine_bitwise_on_jax_planes():
    """The plain K2 fed the JAX kernel's own colour planes reproduces
    ``combine_planes_fused`` bit for bit (same add order, select)."""
    case = make_case(31, n=900)
    args = [jnp.asarray(a) for a in plan_arrays(case)]
    accr, acci, occ = pallas_gridder._grid_chunks_planes(
        jnp.asarray(case["kernel"]), jnp.asarray(case["wg"]), *args, None,
        None, pixels=PIXELS, ts=TS, num_pols=1, interpret=True)
    gr, gi = pallas_gridder.combine_planes_fused(accr, acci, occ,
                                                 pixels=PIXELS, ts=TS)
    tr, ti = fused_gridder.combine_planes_plain(
        torch.from_numpy(np.array(accr)), torch.from_numpy(np.array(acci)),
        torch.from_numpy(np.array(occ)), pixels=PIXELS, ts=TS)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(gr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(gi))


def test_nan_poisoned_planes_do_not_leak():
    """Colour-plane blocks no chunk writes are masked by a select: NaN
    there never reaches the grid."""
    case = make_case(5, n=600)
    kern = torch.from_numpy(case["kernel"])
    uv, sub, wp, vis, anc, val = (torch.from_numpy(np.ascontiguousarray(a))
                                  for a in plan_arrays(case))
    n = int(val.any(dim=-1).sum())
    nt2 = mxu_gridder.colour_tiles(PIXELS, TS)
    iu, iv, su, sv = fused_gridder.tap_indices(kern, uv, sub, wp, anc,
                                               pixels=PIXELS, ts=TS)
    sre, sim = fused_gridder.samples(vis, val, None, None, anc, su, sv,
                                     kernel_width=K, ts=TS)
    slot = fused_gridder.chunk_slots(anc, n, ts=TS, nt2=nt2)
    ext2 = nt2 * 2 * TS
    accr = torch.full((2, 2, 1, ext2, ext2), float("nan"))
    acci = torch.full_like(accr, float("nan"))
    fused_gridder.grid_planes(slot, n, fused_gridder.valid_counts(val),
                              iu, iv, su, sv, sre, sim,
                              fused_gridder.conj_table(kern), accr, acci,
                              ts=TS)
    occ = fused_gridder.occupancy(slot, n, nt2)
    assert not bool(occ.all())          # some blocks really stay unwritten
    gr, gi = fused_gridder.combine_planes(accr, acci, occ, pixels=PIXELS,
                                          ts=TS)
    assert torch.isfinite(gr).all() and torch.isfinite(gi).all()
    ref = port_grid(case, density=False)
    assert torch.equal(gr, ref[0]) and torch.equal(gi, ref[1])


@pytest.mark.parametrize("empty", ["n_chunks=0", "no visibilities"])
def test_empty_plan_is_zero(empty):
    case = make_case(3, n=0 if empty == "no visibilities" else 50)
    gr, gi = port_grid(case, n_chunks=0 if empty == "n_chunks=0" else None)
    assert gr.shape == (1, PIXELS, PIXELS)
    assert not gr.any() and not gi.any()


def test_pol_split_matches_joint():
    """The polarization-group split (accumulators over the cap) equals
    the joint call: each polarization's sums are independent."""
    case = make_case(23, num_pols=4, n=500)
    joint = port_grid(case)
    split = port_grid(case, max_acc_gb=0.01)
    for a, b in zip(joint, split):
        assert torch.equal(a, b)


def test_wide_kernel_raises():
    case = make_case(1, n=10)
    wide = np.zeros((4, 8, TS + 2), np.complex64)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in plan_arrays(case)]
    with pytest.raises(NotImplementedError):
        mxu_gridder.grid_chunks_parts(torch.from_numpy(wide), None, *t,
                                      pixels=PIXELS, ts=TS)
