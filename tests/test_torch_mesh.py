"""The port's ``("chan", "vis")`` mesh over ``torch.distributed`` on the
CPU: ranks are processes (``parallel.launch.run_ranks``, gloo) running
functions of the port, never of this module (a child imports no test
module and no JAX).

- the mesh layout (rank ``r`` is chan group ``r // V``, vis shard
  ``r % V``) and its collectives on 4 ranks;
- the sharded step (``make_imaging_step`` over ``local_batch``) at (chan,
  vis) = (2, 1), (1, 2) and (2, 2) against the port's 1-rank step:
  bitwise for the chan split (no collective), within 1e-5 of the dirty
  peak inside the anti-aliased field for a vis split (each rank's grid
  is a partial sum, so the f32 grid sums round in another order); and
  against the JAX ``make_imaging_step`` on a JAX mesh of the same shape
  (XLA assemblies), within 1e-4 of the dirty peak inside the field;
- a cube wave at vis 2 against the 1-rank wave and the JAX
  ``make_wave_image`` at ``vis_shards=2``: the same CLEAN component
  positions inside the field, residuals within 1e-4 of the dirty peak;
- a rank that fails fails the launch, and the cube's capacity agreement
  grows every rank's layout when one rank alone overflows.

The batch is noise plus 5 point sources (10-100x the dirty RMS), as a
field with sources is imaged; the dirty peak is the sources'.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from katsdpimager_tpu.parallel import cube as jax_cube
from katsdpimager_tpu.parallel import make_mesh as jax_make_mesh
from katsdpimager_tpu.parallel import multichannel as jax_mc
from katsdpimager_tpu_torch import convert
from katsdpimager_tpu_torch.parallel import cube, launch, mesh, multichannel

torch.set_num_threads(2)

SMALL = dict(pixels=256, num_pols=1, kernel_width=16, oversample=8,
             w_planes=8, w_slices=2, chunks_per_slice=64, chunk_size=128,
             rv=32, ru=32)
STEP = multichannel.MultiChannelConfig(**SMALL, weight_type="uniform")
WAVE = cube.CubeConfig(**SMALL, majors=2, minor=300, patch=17, psf_core=32,
                       loop_gain=0.1, weight_type="uniform")
SHARDS = "katsdpimager_tpu_torch.parallel.launch:image_shards"
#: (chan, vis) meshes of the sharded step
MESHES = [(2, 1), (1, 2), (2, 2)]


@pytest.fixture(scope="module")
def batch():
    """Two channels of noise and 5 point sources, on the host."""
    tb = multichannel.make_example_batch(
        multichannel.MultiChannelConfig(**SMALL, weight_type="natural"), 2,
        seed=5, device="cpu")
    tb, _, _ = cube.with_point_sources(WAVE, tb, seed=1)
    return tb


def one_channel(tb):
    return multichannel.ChannelBatch(*(x[:1] for x in tb))


@pytest.fixture(scope="module")
def sharded(batch):
    """Each mesh's per-rank results: the steps on 2 ranks (vis 1 and 2)
    and the wave at vis 2 in one launch, the (2, 2) step on 4 ranks."""
    two = launch.run_ranks(
        2, SHARDS, [dict(kind="step", cfg=STEP, batch=batch, vis_shards=1),
                    dict(kind="step", cfg=STEP, batch=batch, vis_shards=2),
                    dict(kind="wave", cfg=WAVE, batch=one_channel(batch),
                         vis_shards=2)], device="cpu")
    four = launch.run_ranks(
        4, SHARDS, [dict(kind="step", cfg=STEP, batch=batch, vis_shards=2)],
        device="cpu")
    return {(2, 1): [r[0] for r in two], (1, 2): [r[1] for r in two],
            (2, 2): [r[0] for r in four], "wave": [r[2] for r in two]}


def gathered(results, channels):
    """The step's (C, P, N, N) dirty images from a mesh's ranks, each
    channel from its chan group's vis rank 0; and the vis ranks' copies
    equal."""
    out = [None] * channels
    for r in results:
        res = r["outputs"][0]
        cl = res.shape[0]
        for i in range(cl):
            c = r["chan_index"] * cl + i
            if out[c] is None:
                out[c] = res[i]
            else:
                np.testing.assert_array_equal(out[c], res[i])
    return np.stack(out)


def field(tb):
    t = tb.taper1d[0].double().numpy()
    t2 = np.outer(t, t)
    return t2 >= 0.002 * t2.max()


@pytest.fixture(scope="module")
def one_rank(batch):
    """The port's step and wave without a process group (the 1 x 1
    mesh)."""
    m = mesh.make_mesh(1, device="cpu")
    step = multichannel.make_imaging_step(m, STEP)(batch)[0].numpy()
    wave = cube.wave_image(WAVE, one_channel(batch))
    return step, wave


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_step_matches_one_rank(batch, sharded, one_rank, shape):
    chan, vis = shape
    got = gathered(sharded[shape], 2)
    ref = one_rank[0]
    if vis == 1:
        np.testing.assert_array_equal(got, ref)
        assert all(r["psum_calls"] == 0 for r in sharded[shape])
    else:
        inside = field(batch)
        peak = np.abs(ref).max()
        assert np.abs(got - ref)[..., inside].max() <= 1e-5 * peak
        # The weight grid and every taken slice, re and im, per channel.
        assert all(r["psum_calls"] > 0 for r in sharded[shape])
    assert np.isfinite(got).all()


@pytest.mark.parametrize("shape", MESHES + ["wave"])
def test_all_reduce_seconds_are_the_mesh_psum_spans(sharded, shape):
    """Each rank's seconds in its all-reduces come from its ``mesh.psum``
    spans: none where it made no all-reduce (the chan split), some
    wherever it made one."""
    for r in sharded[shape]:
        assert (r["psum_s"] > 0) == (r["psum_calls"] > 0)
        assert r["psum_s"] < 60


@pytest.fixture(scope="module")
def jax_steps(batch):
    """The JAX sharded step's dirty images on a JAX mesh of each shape
    (the first chan x vis of the 8 virtual CPU devices)."""
    jb = jax_mc.ChannelBatch(**{k: v for k, v in
                                convert.batch_to_numpy(batch).items()
                                if k != "n_chunks"})
    cfg = jax_mc.MultiChannelConfig(**SMALL, weight_type="uniform")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("KTPU_FFT", raising=False)
        mp.delenv("KTPU_GRID_ASSEMBLY", raising=False)
        for chan, vis in MESHES:
            m = jax_make_mesh(jax.devices()[:chan * vis], vis_shards=vis)
            out[(chan, vis)] = np.asarray(
                jax_mc.make_imaging_step(m, cfg)(jb)[0])
    return out


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_step_matches_jax(batch, sharded, jax_steps, shape):
    got = gathered(sharded[shape], 2)
    ref = jax_steps[shape]
    inside = field(batch)
    assert np.abs(got - ref)[..., inside].max() <= 1e-4 * np.abs(ref).max()


def assert_wave_close(got, ref, inside, dirty_peak):
    """Residuals within 1e-4 of the dirty peak inside the field; the same
    CLEAN component positions there."""
    res, mod = np.asarray(got.residual), np.asarray(got.model)
    ref_res, ref_mod = np.asarray(ref.residual), np.asarray(ref.model)
    assert np.abs(res - ref_res)[..., inside].max() <= 1e-4 * dirty_peak
    np.testing.assert_array_equal((mod != 0)[..., inside],
                                  (ref_mod != 0)[..., inside])
    assert int((mod != 0)[..., inside].sum()) > 0


def test_wave_at_vis_2_matches_one_rank_and_jax(batch, sharded, one_rank):
    tb = one_channel(batch)
    ranks = sharded["wave"]
    got = [cube.WaveResult(*r["outputs"]) for r in ranks]
    # Both vis ranks hold the same images and ran the same CLEAN.
    for a, b in zip(got[0], got[1]):
        np.testing.assert_array_equal(a, b)
    assert all(r["psum_calls"] > 0 for r in ranks)
    ref = one_rank[1]
    inside = field(tb)
    args, nc = cube._channel(tb, 0)
    kern, tap, ps, midw, uv, sub, wp, anc, val, _, vis = args
    dirty = cube._grid_slices(WAVE, kern, None, uv, sub, wp, anc, val, vis,
                              tap, ps, midw, nc)
    dirty_peak = float((dirty / ref.psf_peak[0][:, None, None]).abs().max())
    assert_wave_close(got[0], ref, inside, dirty_peak)

    jb = jax_mc.ChannelBatch(**{k: v for k, v in
                                convert.batch_to_numpy(tb).items()
                                if k != "n_chunks"})
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("KTPU_FFT", raising=False)
        mp.delenv("KTPU_GRID_ASSEMBLY", raising=False)
        m = jax_make_mesh(jax.devices()[:2], vis_shards=2)
        jref = jax_cube.make_wave_image(
            m, jax_cube.CubeConfig(**dataclasses.asdict(WAVE)))(jb)
    assert_wave_close(got[0], jax_cube.WaveResult(
        *(np.asarray(x) for x in jref)), inside, dirty_peak)


def test_mesh_layout_and_collectives():
    """On 4 ranks at V = 1, 2, 4: rank r is chan group r // V and vis
    shard r % V (the JAX device layout); psum and pmax_ints act within
    the vis group, all_max_int, broadcast and gather_to_rank0 over every
    rank."""
    reports = launch.run_ranks(
        4, "katsdpimager_tpu_torch.parallel.launch:mesh_report", [1, 2, 4])
    for r, per_v in enumerate(reports):
        for V, rep in zip((1, 2, 4), per_v):
            group = range(r - r % V, r - r % V + V)
            assert (rep["chan_index"], rep["vis_index"]) == (r // V, r % V)
            assert (rep["chan_size"], rep["vis_size"]) == (4 // V, V)
            assert rep["psum"] == [float(sum(group)), float(V)]
            assert rep["pmax"] == [max(group), -min(group)]
            assert rep["all_max"] == 3
            assert rep["broadcast"] == "from 0"
            assert rep["gathered"] == ([0, 1, 2, 3] if r == 0 else None)


def test_one_rank_mesh_and_its_limits():
    """Without a process group: the 1 x 1 mesh, psum and pmax the
    identity; vis_shards that do not divide the ranks raise, there and
    (failing the launch on every rank, no hang) under a process group."""
    m = mesh.make_mesh(1, device="cpu")
    assert m.shape == {"chan": 1, "vis": 1} and m.rank == 0
    x = torch.ones(3)
    assert mesh.psum(x, m) is x
    assert mesh.pmax_ints([2, 5], m) == [2, 5]
    with pytest.raises(ValueError, match="divisible"):
        mesh.make_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="not divisible by vis_shards=3"):
        launch.run_ranks(
            2, "katsdpimager_tpu_torch.parallel.launch:mesh_report", [3])


@pytest.mark.parametrize("cuda,cards,env,num_processes,want", [
    (False, 0, {"LOCAL_WORLD_SIZE": "1"}, None, "gloo"),
    (True, 2, {"LOCAL_WORLD_SIZE": "2", "WORLD_SIZE": "8"}, None, "nccl"),
    (True, 1, {"LOCAL_WORLD_SIZE": "2"}, None, "gloo"),
    (True, 1, {}, 2, "gloo"),
    (True, 4, {"WORLD_SIZE": "4"}, None, "nccl"),
])
def test_default_backend_follows_ranks_and_cards(monkeypatch, cuda, cards,
                                                 env, num_processes, want):
    """``default_backend``: nccl only where CUDA exists and this host's
    ranks (``LOCAL_WORLD_SIZE``, else ``num_processes``, else
    ``WORLD_SIZE``) have a card each; gloo where they share the cards or
    there is no CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for name in ("LOCAL_WORLD_SIZE", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert mesh.default_backend(num_processes) == want


def test_local_batch_blocks():
    """``local_batch``: a rank's channel block and its contiguous block of
    every slice's chunks, with the occupied chunks inside it counted."""
    tb = multichannel.make_example_batch(
        multichannel.MultiChannelConfig(**SMALL, weight_type="natural"), 2,
        seed=3, device="cpu")
    shape = mesh.Mesh(3, 4, 1, 2, 1, 2, None, torch.device("cpu"))
    local = multichannel.local_batch(shape, tb)
    ncl = SMALL["chunks_per_slice"] // 2
    torch.testing.assert_close(local.uv, tb.uv[1:2, :, ncl:], rtol=0,
                               atol=0)
    want = (tb.n_chunks[1:2] - ncl).clamp(0, ncl)
    assert torch.equal(local.n_chunks, want)
    assert torch.equal(local.n_chunks,
                       local.valid.any(-1).sum(-1).to(torch.int64))


def test_capacity_grows_on_every_rank_when_one_overflows():
    """One rank's packing overflows below 1000 chunks per slice, the
    other's never: both end at the same grown capacity (128 doubled to
    1024), and only the first reports its own overflow."""
    got = launch.run_ranks(
        2, "katsdpimager_tpu_torch.parallel.launch:overflow_drill",
        [1000, 0], 128)
    assert [g["capacity"] for g in got] == [1024, 1024]
    assert [g["packed"] for g in got] == [1024, 1024]
    assert [g["overflowed"] for g in got] == [True, False]


#: Hostnames by global rank: 2 hosts of 4 ranks, ids contiguous within a
#: host or interleaved between them.
TWO_HOSTS = {"contiguous": ["a"] * 4 + ["b"] * 4,
             "interleaved": ["a", "b"] * 4}


@pytest.mark.parametrize("hosts", sorted(TWO_HOSTS))
def test_host_layout_two_hosts_of_four_cards(hosts):
    """2 hosts x 4 cards: nccl on every rank, and each rank's local rank
    its index among its own host's ranks, however the ids interleave."""
    names = TWO_HOSTS[hosts]
    for r in range(8):
        want = names[:r].count(names[r])
        assert mesh.host_layout(names, [4] * 8, r) == (want, 4, "nccl", 2)


@pytest.mark.parametrize("cards,want", [(1, "gloo"), (0, "gloo"),
                                        (2, "nccl")])
def test_host_layout_one_host(cards, want):
    """1 host with 2 ranks: gloo where they share 1 card or there is no
    CUDA (0 cards), nccl with a card each."""
    for r in range(2):
        assert mesh.host_layout(["h", "h"], [cards] * 2, r) == (r, 2, want,
                                                               1)


def test_host_layout_one_host_short_of_cards():
    """Every rank takes gloo where one host of two has more ranks than
    cards, and where one host has no CUDA."""
    names = ["a", "a", "b", "b"]
    assert {mesh.host_layout(names, [2, 2, 1, 1], r).backend
            for r in range(4)} == {"gloo"}
    assert {mesh.host_layout(names, [2, 2, 0, 0], r).backend
            for r in range(4)} == {"gloo"}


class _Store:
    """A rendezvous store holding every other rank's published host."""

    def __init__(self, names, cards):
        self.data = {f"ktpu_host/{r}": f'["{h}", {cards}]'.encode()
                     for r, h in enumerate(names)}

    def set(self, key, value):
        self.data[key] = value.encode()

    def get(self, key):
        return self.data[key]


def _fake_join(monkeypatch, names, cards):
    """Stand-ins for the store, the group and the cards; returns what
    they were called with."""
    calls = {}
    monkeypatch.setattr(mesh, "_layout", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.__setitem__("device", d))

    def store(host, port, world, is_master, timeout):
        calls["store"] = (host, port, world, is_master)
        return _Store(names, cards)

    def init(backend, **kwargs):
        calls["group"] = dict(kwargs, backend=backend)

    monkeypatch.setattr(mesh.dist, "TCPStore", store)
    monkeypatch.setattr(mesh.dist, "init_process_group", init)
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    return calls


@pytest.mark.parametrize("form", ["coordinator", "env"])
@pytest.mark.parametrize("hosts", sorted(TWO_HOSTS))
def test_join_over_two_hosts_takes_nccl_and_the_local_card(monkeypatch,
                                                           form, hosts):
    """2 hosts x 4 cards joined with ``--coordinator`` arguments, or with
    only ``RANK``/``WORLD_SIZE`` set (no ``torchrun`` variables): every
    rank forms the group over nccl through the rendezvous store and
    drives the card of its index on its own host."""
    names = TWO_HOSTS[hosts]
    for r in range(8):
        calls = _fake_join(monkeypatch, names, 4)
        monkeypatch.setattr(mesh.socket, "gethostname", lambda: names[r])
        if form == "coordinator":
            mesh.initialize_distributed("head:29500", 8, r)
        else:
            monkeypatch.setenv("MASTER_ADDR", "head")
            monkeypatch.setenv("MASTER_PORT", "29500")
            monkeypatch.setenv("RANK", str(r))
            monkeypatch.setenv("WORLD_SIZE", "8")
            mesh.initialize_distributed()
        local = names[:r].count(names[r])
        assert calls["store"] == ("head", 29500, 8, r == 0)
        assert calls["group"]["backend"] == "nccl"
        assert (calls["group"]["rank"], calls["group"]["world_size"]) == (
            r, 8)
        assert calls["device"] == torch.device("cuda", local)
        assert mesh.local_layout() == (local, 4, "nccl", 2)


def test_join_under_torchrun_reads_its_variables(monkeypatch):
    """``torchrun``'s ``LOCAL_*`` variables: the group forms from its
    environment (no store of this module's), on the card of
    ``LOCAL_RANK``, with :func:`default_backend`'s choice."""
    calls = _fake_join(monkeypatch, [], 2)
    for name, value in dict(RANK="5", WORLD_SIZE="8", LOCAL_RANK="1",
                            LOCAL_WORLD_SIZE="2",
                            GROUP_WORLD_SIZE="4").items():
        monkeypatch.setenv(name, value)
    mesh.initialize_distributed()
    assert "store" not in calls
    assert calls["group"]["backend"] == "nccl"
    assert calls["group"]["init_method"] == "env://"
    assert calls["device"] == torch.device("cuda", 1)
    assert mesh.local_layout() == (1, 2, "nccl", 4)


def test_coordinator_rendezvous_on_two_ranks():
    """A real 2-rank rendezvous on the CPU with ``--coordinator``
    arguments and no ``torchrun`` variables: the store path finds one
    host of 2 ranks and gloo (no CUDA), and the collectives work."""
    reports = launch.run_ranks(
        2, "katsdpimager_tpu_torch.parallel.launch:mesh_report", [1, 2],
        coordinator=True, backend=None)
    for r, per_v in enumerate(reports):
        for V, rep in zip((1, 2), per_v):
            assert rep["layout"] == (r, 2, "gloo", 1)
            assert rep["device"] == "cpu"
            assert (rep["rank"], rep["world"]) == (r, 2)
            assert rep["psum"] == ([float(r), 1.0] if V == 1
                                   else [1.0, 2.0])
            assert rep["gathered"] == ([0, 1] if r == 0 else None)
