"""The port's batch pipeline (``python -m katsdpimager_tpu_torch.pipeline``,
``device="cpu"``) against the JAX package's ``imager-tpu-pipeline`` on
the same simulated 2-channel observation, per channel and ``--cube``.

Cases: natural weights; robust weights with ``--subtract`` (the 1.5 Jy
off-centre source) and ``--primary-beam meerkat``; the cube with the PSF
patch sized per wave (auto) and fixed.  The JAX tests run on 8 virtual
devices, where a JAX cube wave holds 8 channels and the auto patch is
sized over all of them; the port's waves hold one channel.  So the auto
cases run the JAX cube on a one-device mesh (one channel per wave), and
the fixed-patch case on the default mesh: there the wave size changes
nothing.

Tolerances: restored images within 1e-4 of the JAX image's peak inside
the anti-aliased field (taper^2 >= 0.2% of its peak), with the same NaN
pixels (the primary-beam cutoff); ``state.json``'s integers (minor
cycles, compressed visibilities, PSF patch, status) equal and its floats
(noise, peak, totals, the weights' noise, the beam) within 1e-4
relative; ``metadata.json`` equal apart from ``StartTime``.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax

from katsdpimager_tpu import cube_frontend as jax_cube_frontend
from katsdpimager_tpu import pipeline as jax_pipeline
from katsdpimager_tpu import simulate as jax_simulate
from katsdpimager_tpu.parallel import make_mesh
from katsdpimager_tpu_torch import cube_frontend, io, pipeline, report
from katsdpimager_tpu_torch import native
from katsdpimager_tpu_torch.ops import fused_gridder, wkernel

torch.set_num_threads(2)
N = 256
#: The brightest off-centre default source (1.5 Jy at 0.15 deg).
SUBTRACTED = "52.625 -35.1167 1.5 0 0 0\n"


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """A 2-channel simulated observation (16 antennas, 16 dumps, in a
    narrow band so every source stays in the field) and a sky model of
    one of its sources."""
    root = tmp_path_factory.mktemp("pipeline")
    path = root / "sim.h5"
    freqs = 856e6 + 214e6 * (np.arange(2) + 0.5) / 8
    jax_simulate.make_sim_dataset(str(path), num_antennas=16, num_times=16,
                                  num_channels=2, max_radius=800.0,
                                  frequencies=freqs)
    lsm = root / "lsm.txt"
    lsm.write_text(SUBTRACTED)
    return root, str(path), str(lsm)


def argv_of(sim, out, extra):
    _, path, lsm = sim
    return [path, str(out), "--pixels", str(N), "--kernel-width", "12",
            "--minor", "100", "--major", "2", "--loop-gain", "0.25",
            "--no-thumbnails", "--no-tmp-file", "--log-level", "WARNING",
            *[lsm if a == "LSM" else a for a in extra]]


#: name -> (extra arguments, JAX cube on one device per wave)
CASES = {
    "channel natural": ([], False),
    "channel robust subtract beam": (
        ["--weight-type", "robust", "--subtract", "LSM", "--primary-beam",
         "meerkat"], False),
    "cube natural auto patch": (["--cube"], True),
    "cube robust subtract beam auto patch": (
        ["--cube", "--weight-type", "robust", "--robustness", "0.5",
         "--subtract", "LSM", "--primary-beam", "meerkat"], True),
    "cube uniform subtract fixed patch": (
        ["--cube", "--cube-psf-patch", "33", "--weight-type", "uniform",
         "--subtract", "LSM"], False),
}


@pytest.fixture(scope="module")
def runs(sim):
    """Each case's JAX and port output directories, run once."""
    done = {}

    def get(name):
        if name not in done:
            extra, one_device = CASES[name]
            root = sim[0] / name.replace(" ", "_")
            with pytest.MonkeyPatch.context() as mp:
                if one_device:
                    mp.setattr(jax_cube_frontend, "make_mesh",
                               lambda vis_shards=1: make_mesh(
                                   jax.devices()[:1], vis_shards))
                assert jax_pipeline.main(argv_of(sim, root / "jax",
                                                 extra)) == 0
            assert pipeline.main(argv_of(sim, root / "port", extra),
                                 device="cpu") == 0
            done[name] = (root / "jax", root / "port")
        return done[name]

    return get


def field():
    taper = wkernel.taper(N, 7.0, 8, wkernel.default_beta(7.0))
    t2 = np.outer(taper, taper)
    return t2 >= 0.002 * t2.max()


def state(d):
    return json.loads((d / "state.json").read_text())


@pytest.mark.parametrize("case", list(CASES))
def test_images_match_jax(runs, case):
    want_dir, got_dir = runs(case)
    inside = field()
    for ch in range(2):
        name = f"image_{ch:05d}_clean.fits"
        want = np.asarray(io.read_fits(str(want_dir / name))[1])[0]
        got = np.asarray(io.read_fits(str(got_dir / name))[1])[0]
        assert got.shape == want.shape == (1, N, N)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        both = inside & ~np.isnan(want[0])
        peak = np.abs(want[0][both]).max()
        assert peak > 0.5
        err = np.abs(got[0] - want[0])[both].max()
        assert err <= 1e-4 * peak, (ch, err / peak)


INTS = ("minor", "major", "compressed_vis", "psf_patch_size")
FLOATS = ("noise", "peak", "normalized_noise", "frequency")


@pytest.mark.parametrize("case", list(CASES))
def test_state_matches_jax(runs, case):
    want, got = (state(d) for d in runs(case))
    assert sorted(got) == sorted(want)
    for ch in range(2):
        assert got[f"status/{ch}"] == want[f"status/{ch}"] == "complete"
        g, w = got[f"stats/{ch}"], want[f"stats/{ch}"]
        assert sorted(g) == sorted(w)
        for key in INTS:
            assert g[key] == w[key], key
        for key in ("image_parameters", "grid_parameters",
                    "clean_parameters"):
            assert g[key] == w[key], key
        for key in FLOATS:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                       err_msg=key)
        assert (g["weights_noise"] is None) == (w["weights_noise"] is None)
        if w["weights_noise"] is not None:
            np.testing.assert_allclose(g["weights_noise"],
                                       w["weights_noise"], rtol=1e-4)
        assert sorted(g["totals"]) == sorted(w["totals"])
        for pol in w["totals"]:
            np.testing.assert_allclose(g["totals"][pol], w["totals"][pol],
                                       rtol=1e-4)
        for key in ("major", "minor", "theta"):
            np.testing.assert_allclose(g["restoring_beam"][key],
                                       w["restoring_beam"][key], rtol=1e-4,
                                       atol=1e-6)
    assert got["observation"] == want["observation"]


@pytest.mark.parametrize("case", ["channel natural",
                                  "cube natural auto patch"])
def test_metadata_matches_jax(runs, case):
    want, got = (json.loads((d / "metadata.json").read_text())
                 for d in runs(case))
    assert got.pop("StartTime") and want.pop("StartTime")
    assert got == want


def test_subtraction_removes_the_source(runs):
    """The subtracted source is gone from the cube's restored image and
    the beam-corrected centre source is there (``tests/test_cube.py``'s
    check), while the run without ``--subtract`` keeps it."""
    import math

    src = jax_simulate.DEFAULT_SOURCES[1]
    ra0, dec0 = jax_simulate.DEFAULT_PHASE_CENTRE
    l, m, _ = jax_simulate.lmn(np.array([src.ra]), np.array([src.dec]),
                               ra0, dec0)
    for case, present in (("cube robust subtract beam auto patch", False),
                          ("cube natural auto patch", True)):
        _, got_dir = runs(case)
        hdr, image = io.read_fits(str(got_dir / "image_00000_clean.fits"))
        image = np.asarray(image)[0, 0]
        ps = math.radians(abs(hdr["CDELT2"]))
        # FITS x is mirrored relative to l (RA---SIN, CDELT1 < 0)
        px = int(round(N // 2 - l[0] / ps))
        py = int(round(N // 2 + m[0] / ps))
        at_src = np.nanmax(image[py - 2:py + 3, px - 2:px + 3])
        assert (at_src > 1.0) if present else (at_src < 0.3), (case, at_src)
        assert image[N // 2, N // 2] > 0.85


@pytest.mark.parametrize("cube", [False, True])
def test_resume_skips_done(sim, tmp_path, caplog, cube):
    """A second run into the same directory images nothing: every channel
    (and, with --cube, every wave) is already done."""
    out = tmp_path / "out"
    extra = ["--cube"] if cube else []
    assert pipeline.main(argv_of(sim, out, extra), device="cpu") == 0
    fits = [out / f"image_{ch:05d}_clean.fits" for ch in range(2)]
    mtimes = [os.path.getmtime(f) for f in fits]
    before = state(out)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert pipeline.main(argv_of(sim, out, extra + [
            "--log-level", "INFO"]), device="cpu") == 0
    skipped = [r.getMessage() for r in caplog.records
               if r.getMessage().startswith("Skipping")]
    if cube:
        assert skipped == ["Skipping wave [0]: already done",
                           "Skipping wave [1]: already done"]
    else:
        assert skipped == ["Skipping channel 0: already done",
                           "Skipping channel 1: already done"]
    assert [os.path.getmtime(f) for f in fits] == mtimes
    after = state(out)
    for ch in range(2):
        assert after[f"stats/{ch}"] == before[f"stats/{ch}"]


def test_chunk_capacity_grows_on_overflow(sim, runs, tmp_path, monkeypatch,
                                          caplog):
    """A layout of one chunk per slice overflows: the first wave grows it
    on the main thread, and the images are those of the planned layout."""
    orig = cube_frontend._plan_layout

    def tiny_layout(reader, num_channels, template):
        template = orig(reader, num_channels, template)
        template["chunks_per_slice"] = 1
        return template

    monkeypatch.setattr(cube_frontend, "_plan_layout", tiny_layout)
    out = tmp_path / "grow"
    with caplog.at_level(logging.INFO):
        assert pipeline.main(argv_of(sim, out, ["--cube", "--log-level",
                                                "INFO"]), device="cpu") == 0
    grown = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Growing chunk capacity")]
    assert grown
    _, planned = runs("cube natural auto patch")
    for ch in range(2):
        name = f"image_{ch:05d}_clean.fits"
        np.testing.assert_array_equal(
            np.asarray(io.read_fits(str(out / name))[1]),
            np.asarray(io.read_fits(str(planned / name))[1]))
    assert state(out)["stats/1"]["minor"] == state(planned)["stats/1"]["minor"]


def test_cube_from_hdf5_spill_matches_memory(sim, runs, tmp_path):
    """With the default ``--tmp-file`` the preprocessed visibilities
    spill to HDF5 and the planning pass reads their coordinates only
    (``VisibilityReaderHDF5.slice_coords``): the images equal those of
    the in-memory run."""
    out = tmp_path / "spill"
    argv = [a for a in argv_of(sim, out, ["--cube"]) if a != "--no-tmp-file"]
    assert pipeline.main(argv, device="cpu") == 0
    _, memory = runs("cube natural auto patch")
    for ch in range(2):
        name = f"image_{ch:05d}_clean.fits"
        np.testing.assert_array_equal(
            np.asarray(io.read_fits(str(out / name))[1]),
            np.asarray(io.read_fits(str(memory / name))[1]))


def test_packer_counts_match_the_mask(sim, monkeypatch):
    """The native packer and the numpy planner fill the wave arrays
    bitwise alike, and the occupied-chunk counts they return (the
    batch's host ``n_chunks``) are those of the validity mask."""
    from katsdpimager_tpu_torch import (arguments, frontend, loader,
                                        parameters, polarization)
    from katsdpimager_tpu_torch.parallel import cube

    args = pipeline.get_parser().parse_args(
        argv_of(sim, "unused", ["--cube"]),
        namespace=arguments.SmartNamespace())
    dataset = loader.load(args.input_file, [], 0, 2)
    try:
        params = [frontend.ChannelParameters(
            args, dataset, 0, dataset.array_parameters(),
            parameters.FixedImageParameters(tuple(args.stokes)),
            parameters.FixedGridParameters(
                args.aa_width, args.grid_oversample,
                args.kernel_image_oversample,
                dataset.array_parameters().longest_baseline,
                args.kernel_width, True, None))]
        image_ps = [p.image_p for p in params]
        grid_ps = [p.grid_p for p in params]
        collector = frontend.preprocess_visibilities(
            dataset, args, 0, 1, image_ps, grid_ps,
            (polarization.polarization_matrix(
                args.stokes, dataset.polarizations()), None), "cpu")
        reader = collector.reader()
        cfg = cube.CubeConfig(
            pixels=N, num_pols=1, kernel_width=12, oversample=8,
            w_planes=grid_ps[0].w_planes, w_slices=grid_ps[0].w_slices,
            chunks_per_slice=128, chunk_size=256, rv=64, ru=64)
        packed = []
        for use_native in (True, False):
            monkeypatch.setattr(native, "available", lambda: use_native)
            packed.append([np.array(a) for a in cube_frontend.pack_wave_arrays(
                cfg, reader, image_ps, grid_ps, [0], 0)])
    finally:
        dataset.close()
    for a, b in zip(*packed):
        np.testing.assert_array_equal(a, b)
    val, n_chunks = packed[0][8], packed[0][11]
    np.testing.assert_array_equal(n_chunks, val.any(axis=-1).sum(axis=-1))
    assert n_chunks.sum() > 0
    batch = cube_frontend.batch_from_arrays(tuple(packed[0]), "cpu")
    assert batch.n_chunks.device.type == "cpu"
    np.testing.assert_array_equal(batch.n_chunks.numpy(), n_chunks)


def test_thumbnails_and_report(sim, tmp_path, monkeypatch, caplog):
    """With thumbnails, each channel's PNG is written and the QA report
    embeds it; a thumbnail that fails to render is logged and the run
    goes on."""
    pytest.importorskip("matplotlib")
    out = tmp_path / "thumbs"
    argv = [a for a in argv_of(sim, out, []) if a != "--no-thumbnails"]
    assert pipeline.main(argv + ["-C", "1"], device="cpu") == 0
    assert (out / "image_00000_clean.png").exists()
    html = tmp_path / "report.html"
    assert report.main([str(out / "state.json"), str(html)]) == 0
    assert "image_00000_clean.png" in html.read_text()

    def broken(image, filename):
        raise RuntimeError("no renderer")

    monkeypatch.setattr(pipeline, "_thumbnail", broken)
    with caplog.at_level(logging.WARNING):
        assert pipeline.main(argv + ["-c", "1"], device="cpu") == 0
    assert state(out)["status/1"] == "complete"
    assert any("Thumbnail rendering failed" in r.getMessage()
               for r in caplog.records)


@pytest.mark.parametrize("extra,match", [
    (["--cube", "--vis-shards", "2"], "does not divide the 1 process"),
    (["--cube", "--vis-shards", "0"], "does not divide the 1 process"),
])
def test_unported_options_raise(sim, tmp_path, extra, match):
    """``--vis-shards`` must divide the number of processes: one here,
    with no process group."""
    with pytest.raises(ValueError, match=match):
        pipeline.main(argv_of(sim, tmp_path / "x", extra), device="cpu")


def test_check_args_takes_double_and_dividing_vis_shards():
    """The cube's argument check takes ``--precision double`` and any
    ``--vis-shards`` that divides the number of processes, and raises on
    one that does not."""
    from katsdpimager_tpu_torch import arguments

    def args_of(extra):
        return pipeline.get_parser().parse_args(
            ["in", "out", "--cube"] + extra,
            namespace=arguments.SmartNamespace())

    cube_frontend._check_args(args_of(["--precision", "double"]))
    for world, vis in ((4, 2), (4, 4), (2, 1), (6, 3)):
        cube_frontend._check_args(args_of(["--vis-shards", str(vis)]), world)
    for world, vis in ((3, 2), (4, 3), (1, 2)):
        with pytest.raises(ValueError, match="does not divide"):
            cube_frontend._check_args(args_of(["--vis-shards", str(vis)]),
                                      world)


def test_cube_double_runs_like_jax(sim, runs, tmp_path):
    """``--cube --precision double`` completes every channel, writes
    float64 images (BITPIX -64) and stays within the float32 gate (1e-4
    of the peak inside the field) of the JAX pipeline's
    ``--cube --precision double`` run, whose wave is float32: its packer
    writes float32 arrays and ``pipeline.main`` leaves x64 off (a trap of
    the reference; ``test_torch_cube.py`` holds the double wave itself to
    the JAX wave under x64).  The state's integers equal."""
    root = tmp_path / "dbl"
    extra = ["--cube", "--cube-psf-patch", "33", "--precision", "double"]
    assert jax_pipeline.main(argv_of(sim, root / "jax", extra)) == 0
    assert pipeline.main(argv_of(sim, root / "port", extra),
                         device="cpu") == 0
    inside = field()
    for ch in range(2):
        name = f"image_{ch:05d}_clean.fits"
        header, got = io.read_fits(str(root / "port" / name))
        _, want = io.read_fits(str(root / "jax" / name))
        assert header["BITPIX"] == -64
        got, want = np.asarray(got)[0, 0], np.asarray(want)[0, 0]
        assert np.isfinite(got).all()
        assert np.abs(got - want)[inside].max() <= 1e-4 * np.abs(want).max()
    js, ps = state(root / "jax"), state(root / "port")
    for ch in range(2):
        assert ps[f"status/{ch}"] == js[f"status/{ch}"] == "complete"
        for key in ("minor", "compressed_vis", "psf_patch_size"):
            assert ps[f"stats/{ch}"][key] == js[f"stats/{ch}"][key]


@pytest.fixture(scope="module")
def sim3(tmp_path_factory):
    """A 3-channel simulated observation (a partial last wave on 2
    ranks), its channels far enough apart in frequency that at a fixed
    pixel size their PSFs ask for different CLEAN patches."""
    root = tmp_path_factory.mktemp("pipeline3")
    path = root / "sim3.h5"
    freqs = np.array([900e6, 1100e6, 1350e6])
    jax_simulate.make_sim_dataset(str(path), num_antennas=16, num_times=16,
                                  num_channels=3, max_radius=800.0,
                                  frequencies=freqs)
    return root, str(path), str(root / "unused.txt")


MAIN = "katsdpimager_tpu_torch.pipeline:main"


@pytest.fixture(scope="module")
def ranked(sim3):
    """Each case's output directory: the 1-rank run in this process, the
    others on 2 ranks (gloo)."""
    from katsdpimager_tpu_torch.parallel import launch

    done = {}

    def get(name, extra, ranks):
        if name not in done:
            out = sim3[0] / name
            argv = argv_of(sim3, out, ["--cube"] + extra)
            if ranks == 1:
                assert pipeline.main(argv, device="cpu") == 0
            else:
                assert launch.run_ranks(ranks, MAIN, argv,
                                        device="cpu") == [0] * ranks
            done[name] = out
        return done[name]

    return get


FIXED = ["--cube-psf-patch", "33"]


def read_images(out, channels=3):
    return [np.asarray(io.read_fits(str(out / f"image_{ch:05d}_clean.fits"))[1])
            for ch in range(channels)]


def test_two_rank_chan_split_writes_the_one_rank_files(sim3, ranked):
    """``--cube`` on 2 ranks (chan 2, vis 1) over 3 channels: waves of 2
    channels, the last padded with its last channel and the pad dropped.
    Rank 0 writes the 1-rank run's FITS files bitwise and the same
    ``state.json`` channels and statistics; a rerun on 2 ranks skips
    every wave and rewrites nothing."""
    from katsdpimager_tpu_torch.parallel import launch

    one = ranked("one", FIXED, 1)
    two = ranked("two", FIXED, 2)
    for a, b in zip(read_images(two), read_images(one)):
        np.testing.assert_array_equal(a, b)
    s1, s2 = state(one), state(two)

    def channels(st):
        return {k: v for k, v in st.items()
                if k.startswith(("status/", "stats/"))}

    assert channels(s2) == channels(s1)
    assert sorted(k for k in s2 if k.startswith("status/")) == [
        "status/0", "status/1", "status/2"]
    assert (two / "metadata.json").exists()
    fits = sorted(two.glob("*.fits"))
    mtimes = [os.path.getmtime(f) for f in fits]
    assert launch.run_ranks(2, MAIN, argv_of(sim3, two, ["--cube"] + FIXED),
                            device="cpu") == [0, 0]
    assert [os.path.getmtime(f) for f in fits] == mtimes
    assert channels(state(two)) == channels(s2)


def test_two_rank_vis_split_double_matches_one_rank(ranked):
    """``--cube --precision double --vis-shards 2`` on 2 ranks (chan 1,
    vis 2): each channel's chunks split over both ranks and their grids
    summed; within 1e-4 of the 1-rank double run's peak inside the
    field, the same minor counts."""
    extra = FIXED + ["--precision", "double"]
    one = ranked("one double", extra, 1)
    two = ranked("two vis double", extra + ["--vis-shards", "2"], 2)
    inside = field()
    for a, b in zip(read_images(two), read_images(one)):
        assert a.dtype == b.dtype and a.dtype.itemsize == 8
        a, b = a[0, 0], b[0, 0]
        assert np.abs(a - b)[inside].max() <= 1e-4 * np.abs(b).max()
    s1, s2 = state(one), state(two)
    for ch in range(3):
        assert s2[f"stats/{ch}"]["minor"] == s1[f"stats/{ch}"]["minor"]


def test_two_rank_auto_patch_takes_the_waves_largest(ranked):
    """With the patch sized per wave, the ranks' channels ask for
    different patches (on 1 rank, one wave a channel, each its own); on 2
    ranks the wave of channels 0 and 1 takes the larger for both, as the
    JAX wave sizes it over its channels, and the run finishes."""
    # At a fixed pixel size the PSF narrows with frequency: its patch
    # need at a 20% cutoff falls from 65 to 33 between channels 0 and 1.
    extra = ["--pixel-size", "4arcsec", "--psf-cutoff", "0.2"]
    one = state(ranked("one auto", extra, 1))
    two = state(ranked("two auto", extra, 2))
    patch = {ch: one[f"stats/{ch}"]["psf_patch_size"][0] for ch in range(3)}
    assert patch[0] != patch[1]
    for ch in (0, 1):
        assert two[f"stats/{ch}"]["psf_patch_size"] == [
            max(patch[0], patch[1])] * 2
    assert two["stats/2"]["psf_patch_size"] == [patch[2]] * 2
    assert all(two[f"status/{ch}"] == "complete" for ch in range(3))


def test_per_channel_double_runs(sim, tmp_path):
    """``--precision double`` per channel (the per-channel CLI's float64
    route) completes every channel, and the restored image is finite."""
    out = tmp_path / "dbl"
    assert pipeline.main(argv_of(sim, out, ["--precision", "double"]),
                         device="cpu") == 0
    st = state(out)
    done = [k for k in st if k.startswith("status/")]
    assert done and all(st[k] == "complete" for k in done)
    _, data = io.read_fits(str(out / "image_00000_clean.fits"))
    assert np.isfinite(data).all() and np.abs(data).max() > 0.5


def test_main_needs_cuda_unless_asked_for_the_cpu(sim, tmp_path,
                                                  monkeypatch):
    """Without ``device``, the pipeline runs on the CUDA device and raises
    where there is none, before it reads the dataset."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.main(argv_of(sim, tmp_path / "x", ["--cube"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.main(argv_of(sim, tmp_path / "y", []))
    assert not (tmp_path / "x").exists()


def test_cube_k1_tile_limit_raises_on_cuda():
    """K > 64 needs tiles of 128, which K1 now takes: the cube's argument
    check accepts it (it once raised on CUDA)."""
    from katsdpimager_tpu_torch import arguments

    args = pipeline.get_parser().parse_args(
        ["in", "out", "--cube", "--kernel-width", "96"],
        namespace=arguments.SmartNamespace())
    cube_frontend._check_args(args)
    assert fused_gridder.MAX_TILE >= cube_frontend._tile_for(96)
    assert cube_frontend._tile_for(60) == 64
    assert cube_frontend._tile_for(96) == 128
    assert cube_frontend._patch_bucket(20, 256) == 33
    assert cube_frontend._patch_bucket(600, 256) == 255
