"""The port's per-channel CLI (``python -m katsdpimager_tpu_torch.imager
--host``) on a simulated observation, against the truth and against the
JAX package's CLI on the same file: restored fluxes within 10% of the
truth at every source (``tests/test_e2e.py``'s assertions, at 256 px);
images within 1e-4 of the JAX run's dirty peak inside the anti-aliased
field (taper^2 >= 0.2% of its peak) and the same CLEAN components there,
for Stokes I, IQUV, ``--degrid`` and uniform weights."""

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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        imager.main(argv + ["--host", "--precision", "double"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            imager.main(argv)
