"""The port's per-channel CLI (``python -m katsdpimager_tpu_torch.imager
--host``) on a simulated observation, against the truth and against the
JAX package's CLI on the same file: restored fluxes within 10% of the
truth at every source (``tests/test_e2e.py``'s assertions, at 256 px);
images within 1e-4 of the JAX run's dirty peak inside the anti-aliased
field (taper^2 >= 0.2% of its peak) and the same CLEAN components there,
for Stokes I, IQUV, ``--degrid``, uniform weights and
``KTPU_PREDICT_EXACT=1``; ``--precision double`` against the JAX CLI
under ``jax_enable_x64``, within 1e-5."""

import math

import numpy as np
import pytest
import torch

from katsdpimager_tpu import arguments, io, loader, simulate
from katsdpimager_tpu import frontend as jax_frontend
from katsdpimager_tpu import imager as jax_imager
from katsdpimager_tpu.ops import wkernel
from katsdpimager_tpu_torch import frontend, imager

torch.set_num_threads(2)
N = 256


@pytest.fixture(scope="module")
def sim_dataset(tmp_path_factory):
    path = tmp_path_factory.mktemp("sim") / "tiny.h5"
    simulate.make_sim_dataset(str(path), num_antennas=16, num_times=24,
                              num_channels=1, max_radius=800.0)
    return str(path)


def run_capture(front, cli, argv):
    args = cli.get_parser().parse_args(argv,
                                       namespace=arguments.SmartNamespace())
    cap = {}

    class CaptureWriter(front.Writer):
        def needs_fits_image(self, name):
            return name in ("clean", "dirty", "model", "residuals")

        def needs_fits_grid(self, name):
            return False

        def write_fits_image(self, name, desc, ds, image, ip, ch,
                             beam=None, bunit=None):
            cap[name] = np.array(image)
            cap["image_p"] = ip

        def write_fits_grid(self, *a, **k):
            pass

        def statistics(self, dataset, channel, **kwargs):
            cap["stats"] = kwargs

    dataset = loader.load(argv[0], [])
    try:
        front.run(args, dataset, CaptureWriter())
    finally:
        dataset.close()
    return cap


def truth_peaks(image_p, rb, image):
    """At each source, the restored image's 5 x 5 maximum and the truth's
    (the I fluxes convolved with the fitted beam at the true positions)."""
    ra0, dec0 = simulate.DEFAULT_PHASE_CENTRE
    icov = np.linalg.inv(rb.covariance_sqrt() @ rb.covariance_sqrt().T)
    pos = []
    for src in simulate.DEFAULT_SOURCES:
        l, m, _ = simulate.lmn(np.array([src.ra]), np.array([src.dec]),
                               ra0, dec0)
        pos.append((N // 2 + m[0] / image_p.pixel_size,
                    N // 2 + l[0] / image_p.pixel_size))
    out = []
    for py, px in pos:
        iy, ix = int(round(py)), int(round(px))
        yy, xx = np.mgrid[iy - 2:iy + 3, ix - 2:ix + 3].astype(np.float64)
        truth = sum(src.flux_iquv[0] * np.exp(-0.5 * (
            icov[0, 0] * (yy - sy) ** 2 + 2 * icov[0, 1] * (yy - sy)
            * (xx - sx) + icov[1, 1] * (xx - sx) ** 2))
            for src, (sy, sx) in zip(simulate.DEFAULT_SOURCES, pos))
        out.append((image[0, iy - 2:iy + 3, ix - 2:ix + 3].max(),
                    truth.max()))
    return out


def _inside(n):
    taper = wkernel.taper(n, 7.0, 8, wkernel.default_beta(7.0))
    t2 = np.outer(taper, taper)
    return t2 >= 0.002 * t2.max()


MODES = {
    "I": ["--stokes", "I", "--clean-mode", "I"],
    # a smooth size that is no power of two and no multiple of the tile
    # size (560 % 64 = 48): the torch.fft route and a ragged tile grid
    "560px": ["--stokes", "I", "--pixels", "560"],
    "IQUV": ["--stokes", "IQUV", "--clean-mode", "IQUV"],
    "degrid": ["--stokes", "I", "--degrid"],
    "uniform": ["--stokes", "I", "--weight-type", "uniform"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_matches_jax(sim_dataset, mode):
    argv = [sim_dataset, "unused_%c.fits", "--pixels", str(N),
            "--kernel-width", "16", "--major", "2", "--no-tmp-file",
            *MODES[mode]]
    got = run_capture(frontend, imager, argv + ["--host"])
    want = run_capture(jax_frontend, jax_imager, argv + ["--host"])
    inside = _inside(got["dirty"].shape[-1])
    peak = np.abs(want["dirty"]).max()
    for name in ("dirty", "model", "residuals", "clean"):
        assert np.isfinite(got[name]).all()
        err = np.abs(got[name] - want[name])[:, inside].max()
        assert err <= 1e-4 * peak, (name, err / peak)
    np.testing.assert_array_equal((got["model"] != 0)[:, inside],
                                  (want["model"] != 0)[:, inside])
    assert got["stats"]["minor"] == want["stats"]["minor"]
    for key in ("compressed_vis", "major", "psf_patch_size"):
        assert got["stats"][key] == want["stats"][key], key
    if mode == "I":
        # test_e2e's flux assertions, at 256 px
        rb = got["stats"]["restoring_beam"]
        for have, truth in truth_peaks(got["image_p"], rb, got["clean"]):
            assert have == pytest.approx(truth, rel=0.1)
        assert got["stats"]["totals"]["I"] == pytest.approx(
            sum(s.flux_iquv[0] for s in simulate.DEFAULT_SOURCES), rel=0.1)


def test_cli_writes_fits(sim_dataset, tmp_path):
    out = str(tmp_path / "clean_%c.fits")
    rc = imager.main([sim_dataset, out, "--pixels", str(N),
                      "--kernel-width", "16", "--major", "2", "--host",
                      "--write-psf", str(tmp_path / "psf_%c.fits")])
    assert rc == 0
    header, data = io.read_fits(str(tmp_path / "clean_0.fits"))
    assert data.shape == (1, 1, N, N)
    assert header["CTYPE1"] == "RA---SIN" and header["BUNIT"] == "Jy/beam"
    assert "BMAJ" in header
    assert header["CRVAL1"] == pytest.approx(
        math.degrees(simulate.DEFAULT_PHASE_CENTRE[0]))
    image = np.asarray(data[0, 0, :, ::-1], np.float64)
    assert image[N // 2, N // 2] > 0.5
    assert (tmp_path / "psf_0.fits").exists()


def test_cli_refuses_what_is_not_ported(sim_dataset, tmp_path):
    argv = [sim_dataset, str(tmp_path / "x_%c.fits"), "--pixels", str(N),
            "--kernel-width", "16"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            imager.main(argv)


#: The double route's gate inside the field, over the JAX package's dirty
#: peak.  K1 fills float32 colour planes at double too (as the Pallas
#: kernel does on the JAX package's chip), so its band alone puts the
#: image 1e-6 to 1e-5 of the peak from the float64 oracle inside the field
#: (test_k1_f32_band_sets_the_double_gate); the float32 gate is 1e-4.
DOUBLE_GATE = 1e-5


@pytest.mark.parametrize("major_cycle", ["dft", "degrid"])
def test_double_precision_matches_jax(sim_dataset, major_cycle):
    """``--precision double`` (256 px, K = 12, 2 majors, the DFT or the
    degridding major cycle) against the JAX CLI under
    ``jax_enable_x64``, which grids and degrids in XLA at float64 off the
    TPU: float64 images, finite everywhere, within :data:`DOUBLE_GATE`
    of the dirty peak inside the field, the same components and minor
    counts.  Measured on the CPU: the dirty image 3.4e-6 of the peak
    inside the field (1.5e-4 over the whole image, where the taper
    divides); the restored image 5.5e-7 (8.6e-5) with the DFT, 6.8e-7
    (5.1e-5) with ``--degrid``; the model 3.9e-8 and 2.2e-7."""
    import jax

    argv = [sim_dataset, "unused_%c.fits", "--pixels", str(N),
            "--kernel-width", "12", "--major", "2", "--no-tmp-file",
            "--stokes", "I", "--precision", "double", "--host"] + (
                ["--degrid"] if major_cycle == "degrid" else [])
    got = run_capture(frontend, imager, argv)
    try:
        jax.config.update("jax_enable_x64", True)
        want = run_capture(jax_frontend, jax_imager, argv)
    finally:
        jax.config.update("jax_enable_x64", False)
    inside = _inside(N)
    peak = np.abs(want["dirty"]).max()
    for name in ("dirty", "model", "residuals", "clean"):
        assert got[name].dtype == want[name].dtype == np.float64
        assert np.isfinite(got[name]).all()
        err = np.abs(got[name] - want[name])[:, inside].max()
        assert err <= DOUBLE_GATE * peak, (name, err / peak)
    np.testing.assert_array_equal(got["model"] != 0, want["model"] != 0)
    assert got["stats"]["minor"] == want["stats"]["minor"]


def test_k1_f32_band_sets_the_double_gate():
    """The evidence for :data:`DOUBLE_GATE`: 1500 random visibilities
    gridded at 256 px, K = 12, by K1's plain version (float32 band, the
    kernel table in complex64) onto a float64 grid, and by the JAX
    package's float64 oracle ``gridder.grid_vis_reference``, both
    transformed in float64.  Inside the field the images differ by more
    than 1e-6 of the peak and less than the gate."""
    from katsdpimager_tpu.ops import gridder as jax_gridder
    from katsdpimager_tpu_torch import parameters, polarization
    from katsdpimager_tpu_torch.ops import fourier, fused_gridder, mxu_gridder
    from katsdpimager_tpu_torch.ops import wkernel as twkernel

    K = 12
    fixed = parameters.FixedImageParameters((polarization.STOKES_I,),
                                            "double")
    ip = parameters.make_image_parameters(
        fixed, 1.0, 5, 1.2e9, parameters.ArrayParameters(13.5, 1600.0),
        None, N)
    gp = parameters.GridParameters(
        parameters.FixedGridParameters(7.0, 8, 4, 1600.0, K), 1, 4)
    kern = twkernel.make_convolution_kernel(ip, gp)
    assert kern.dtype == np.complex128
    rng = np.random.default_rng(0)
    n = 1500
    lim = N // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    sub = rng.integers(0, 8, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, 4, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, 1))
           + 1j * rng.normal(size=(n, 1))).astype(np.complex64)
    ts = mxu_gridder.tile_size(N, K)
    plan = mxu_gridder.plan_chunks_tiled(
        uv, sub, wp, vis, np.ones((n, 1), np.float32), pixels=N,
        kernel_width=K, ts=ts, mc=256)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    gr = torch.zeros((1, N, N), dtype=torch.float64)
    gi = torch.zeros_like(gr)
    fused_gridder.grid_slice(
        t(kern.astype(np.complex64)), None, t(plan.uv), t(plan.sub_uv),
        t(plan.w_plane), t(plan.vis), t(plan.anchor), t(plan.valid),
        pixels=N, ts=ts, out=(gr, gi))
    oracle = jax_gridder.grid_vis_reference(
        np.zeros((1, N, N), np.complex128), kern, np.ones((1, N, N)), uv,
        sub, wp, vis.astype(np.complex128))
    taper = t(wkernel.taper(N, 7.0, 8, wkernel.default_beta(7.0)))
    zero = torch.zeros((1, N, N), dtype=torch.float64)
    got, want = (fourier.grid_to_image_plain(
        g, zero, taper, 0.0, ip.pixel_size).numpy()
        for g in (torch.complex(gr, gi), t(oracle)))
    err = np.abs(got - want)[:, _inside(N)].max() / np.abs(want).max()
    assert 1e-6 < err <= DOUBLE_GATE, err


def test_exact_predict_matches_jax(sim_dataset, monkeypatch):
    """``KTPU_PREDICT_EXACT=1`` routes the DFT major cycle through the
    exact predict in both packages (the port's is seen to run): images
    within 1e-4 of the JAX run's dirty peak inside the field, the same
    components, the same minor counts."""
    from katsdpimager_tpu_torch.ops import predict

    calls = []
    exact = predict.predict_subtract_exact

    def counted(*args, **kwargs):
        calls.append(1)
        return exact(*args, **kwargs)

    monkeypatch.setattr(predict, "predict_subtract_exact", counted)
    monkeypatch.setenv("KTPU_PREDICT_EXACT", "1")
    argv = [sim_dataset, "unused_%c.fits", "--pixels", str(N),
            "--kernel-width", "16", "--major", "2", "--no-tmp-file",
            "--stokes", "I", "--host"]
    got = run_capture(frontend, imager, argv)
    assert calls
    want = run_capture(jax_frontend, jax_imager, argv)
    inside = _inside(N)
    peak = np.abs(want["dirty"]).max()
    for name in ("dirty", "model", "residuals", "clean"):
        assert np.isfinite(got[name]).all()
        err = np.abs(got[name] - want[name])[:, inside].max()
        assert err <= 1e-4 * peak, (name, err / peak)
    np.testing.assert_array_equal((got["model"] != 0)[:, inside],
                                  (want["model"] != 0)[:, inside])
    assert got["stats"]["minor"] == want["stats"]["minor"]


def test_single_and_double_differ_as_in_jax(sim_dataset):
    """Float32 and float64 runs of one channel (512 px, K = 12,
    ``--degrid``) differ by the same amount in both packages: CLEAN's
    components drift between the two precisions (the model 1.9e-4 of the
    dirty peak apart inside the field, the residuals 5.2e-5, on the CPU),
    while each package's run matches the other's at each precision to
    1e-5.  So a float64 run on the card is held to its float32 run by its
    dirty image alone (``chip_smoke.py``'s ``double`` phase)."""
    import jax

    argv = [sim_dataset, "unused_%c.fits", "--pixels", "512",
            "--kernel-width", "12", "--major", "2", "--no-tmp-file",
            "--stokes", "I", "--degrid", "--host"]
    double = ["--precision", "double"]
    port = [run_capture(frontend, imager, argv + extra)
            for extra in ([], double)]
    jaxs = [run_capture(jax_frontend, jax_imager, argv)]
    try:
        jax.config.update("jax_enable_x64", True)
        jaxs.append(run_capture(jax_frontend, jax_imager, argv + double))
    finally:
        jax.config.update("jax_enable_x64", False)
    inside = _inside(512)
    peak = np.abs(jaxs[1]["dirty"]).max()

    def err(a, b, name):
        return np.abs(a[name].astype(np.float64)
                      - b[name])[:, inside].max() / peak

    for name in ("model", "residuals"):
        drift = err(port[0], port[1], name)
        assert drift > 1e-5, (name, drift)
        assert err(jaxs[0], jaxs[1], name) == pytest.approx(drift, rel=0.1)
        for a, b in zip(port, jaxs):
            assert err(a, b, name) <= 1e-5
    assert (port[0]["stats"]["minor"] == port[1]["stats"]["minor"]
            == jaxs[0]["stats"]["minor"] == jaxs[1]["stats"]["minor"])
