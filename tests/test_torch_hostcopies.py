"""The port's own host modules against the JAX package's originals.

The port keeps copies of the JAX package's framework-free modules (it
imports nothing of that package).  Each case below runs one function of a
copy and of its original on the same inputs and holds the results equal:
bitwise for arrays, equal for strings, FITS header cards and parsed
objects.  The ``str()`` of the port's parameters is taken in a process
where JAX cannot be imported.
"""

import base64
import io as _io
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import katsdpimager_tpu as jax_pkg
import katsdpimager_tpu.native as jax_native
from katsdpimager_tpu import (fits_video as jax_fits_video, io as jax_io,
                              metadata as jax_metadata,
                              parameters as jax_params,
                              polarization as jax_pol,
                              primary_beam as jax_pb, report as jax_report,
                              simulate as jax_sim, sky_model as jax_sky,
                              units as jax_units)
from katsdpimager_tpu.ops import wkernel as jax_wkernel
from katsdpimager_tpu.ops.clean import CLEAN_I as JAX_CLEAN_I
from katsdpimager_tpu.ops.weights import WeightType as JaxWeightType
from katsdpimager_tpu.preprocess import ChannelGeometry

import katsdpimager_tpu_torch as port_pkg
from katsdpimager_tpu_torch import (fits_video, io, metadata, native,
                                    parameters, polarization, primary_beam,
                                    report, simulate, sky_model, units)
from katsdpimager_tpu_torch.ops import wkernel
from katsdpimager_tpu_torch.ops.clean import CLEAN_I
from katsdpimager_tpu_torch.ops.weights import WeightType
from katsdpimager_tpu_torch.preprocess import (
    ChannelGeometry as PortChannelGeometry)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _grid_setup(pkg, pixels=256, K=16, w_slices=2, w_planes=8):
    fixed = pkg.FixedImageParameters((1,), "single")       # Stokes I
    ap = pkg.ArrayParameters(13.5, 1500.0)
    ip = pkg.make_image_parameters(fixed, 1.0, 5, 1.2e9, ap, None, pixels)
    fgp = pkg.FixedGridParameters(7.0, 8, 4, 1500.0, K)
    return ip, pkg.GridParameters(fgp, w_slices, w_planes)


def _wkernel(wk, pkg, K):
    ip, gp = _grid_setup(pkg, K=K)
    beta = wk.default_beta(gp.fixed.antialias_width)
    return [wk.make_convolution_kernel(ip, gp),
            wk.taper(ip.pixels, gp.fixed.antialias_width,
                     gp.fixed.oversample, beta),
            wk.mid_w_values(ip, gp), wk.plane_w_values(ip, gp)]


def _simulate(sim):
    ants = sim.random_array(16, 2000.0, seed=4)
    freqs = np.array([0.9e9, 1.0e9])
    uvw, vis = sim.simulate_vis(
        ants, np.radians(-30.7), sim.DEFAULT_PHASE_CENTRE, freqs,
        sim.DEFAULT_SOURCES, np.linspace(-0.3, 0.3, 6), noise_jy=0.5,
        seed=9)
    return [ants, uvw, vis]


def _native(nat, pkg, params, geometry):
    rng = np.random.default_rng(3)
    n, Q = 5000, 4
    uvw = (rng.normal(size=(n, 3)) * [300, 300, 40]).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=(n, Q)).astype(np.float32)
    weights[::97, 1] = 0.0
    vis = (rng.normal(size=(n, Q))
           + 1j * rng.normal(size=(n, Q))).astype(np.complex64)
    mueller = pkg.polarization_matrix(
        [pkg.STOKES_I, pkg.STOKES_Q], [pkg.STOKES_XX, pkg.STOKES_XY,
                                       pkg.STOKES_YX, pkg.STOKES_YY])
    ip, gp = _grid_setup(params)
    out = nat.preprocess_channel(uvw, weights, vis, mueller,
                                 geometry.from_parameters(ip, gp))
    # The outputs are views of a reused arena: copy them.
    return [np.array(out[k]) for k in ("uv", "sub_uv", "w_plane", "weights",
                                       "vis", "slice_counts")] + [out["count"]]


_SKY_TEXT = """# ra dec I Q U V alpha ref_MHz
0:00:00.5 -30:00:00 1.5 0.1 0 0 -0.7 1400
12.5 -29.5 2.0
0:01:00 -30:10:00, 0.3, 0, 0.05, 0, 0.2
"""


def _sky(sky, tmp_path):
    path = tmp_path / f"{sky.__name__}.txt"
    path.write_text(_SKY_TEXT)
    model = sky.open_sky_model(str(path))
    return [model.positions, model.flux_iquv, model.spectral_index,
            model.ref_freq, model.lmn((0.001, -0.52))]


def _fits(fio, pkg, tmp_path):
    ip, _ = _grid_setup(pkg, pixels=64)
    image = np.arange(64 * 64, dtype=np.float32).reshape(1, 64, 64)
    path = tmp_path / f"{fio.__name__}.fits"
    fio.write_fits_image(image, ip, str(path), (0.3, -0.5),
                         history=["Command line: imager x.h5 y.fits"])
    data = path.read_bytes()
    return [data[:data.index(b"END" + b" " * 77) + 80],
            fio.read_fits(str(path))[0]]


def _polarization(pol):
    stokes = pol.parse_stokes("IQUV")
    return [pol.polarization_matrix(stokes, [pol.STOKES_XX, pol.STOKES_XY,
                                             pol.STOKES_YX, pol.STOKES_YY]),
            *pol.polarization_matrices(stokes, [pol.STOKES_RR,
                                                pol.STOKES_RL,
                                                pol.STOKES_LR,
                                                pol.STOKES_LL]),
            pol.unparse_stokes(stokes)]


def _units(u):
    return [u.parse_quantity(t).value for t in ("2.5 arcsec", "3 deg",
                                                "1.2 GHz", "100 m")]


def _beam(pb, band="L"):
    beam = pb.meerkat_v1_beam(band)
    x = np.linspace(-0.05, 0.05, 33)
    return [beam.frequencies, beam.radii, beam.power, beam.band,
            beam.sample_grid(x, x, 1.2e9)]


def _parameters_str(pkg, weight_type, clean_i):
    ip, gp = _grid_setup(pkg)
    return [str(ip), str(gp),
            str(pkg.WeightParameters(weight_type.ROBUST, 0.25)),
            str(pkg.WeightParameters(weight_type.UNIFORM)),
            str(pkg.CleanParameters(100, 0.1, 0.85, 5.0, clean_i, 0.01, 0.5,
                                    0.02))]


class _Dataset:
    """The dataset surface ``metadata.make_metadata`` reads."""

    def phase_centre(self):
        return (0.9, -0.61)

    def frequency(self, channel):
        return 1.0e9 + 2.5e5 * channel

    def capture_block_id(self):
        return "1234567890"


def _metadata(md, tmp_path):
    """``make_metadata`` (its ``StartTime`` is the clock's and is left
    out), ``format_timestamp`` at a fixed time, and the written file."""
    data = md.make_metadata(_Dataset(), None, [3, 4, 7])
    start = data.pop("StartTime")
    path = tmp_path / "metadata.json"
    md.write_metadata(str(path), dict(data, StartTime="fixed"))
    return [json.dumps(data, sort_keys=True), len(start),
            md.format_timestamp(1.6e9), path.read_text()]


def _sefd(rep):
    freqs = np.linspace(5e8, 1.8e9, 41)
    out = []
    for band in ("L", "UHF"):
        model = rep.meerkat_sefd_model(band)
        out += [model(freqs), model.coeffs, model.min_freq, model.max_freq]
    out += [rep.meerkat_sefd_model("S") is None,
            rep.PolynomialSEFDModel([1.0, 2.0, 3.0], 1e9, 2e9)(1.5e9),
            rep.predicted_noise(400.0, 64, 208984.375, 3600.0)]
    return out


CASES = {
    "wkernel K=16": (lambda tmp: _wkernel(jax_wkernel, jax_params, 16),
                     lambda tmp: _wkernel(wkernel, parameters, 16)),
    "wkernel K=60": (lambda tmp: _wkernel(jax_wkernel, jax_params, 60),
                     lambda tmp: _wkernel(wkernel, parameters, 60)),
    "simulate": (lambda tmp: _simulate(jax_sim),
                 lambda tmp: _simulate(simulate)),
    "native preprocess_channel": (
        lambda tmp: _native(jax_native, jax_pol, jax_params, ChannelGeometry),
        lambda tmp: _native(native, polarization, parameters,
                            PortChannelGeometry)),
    "sky_model": (lambda tmp: _sky(jax_sky, tmp),
                  lambda tmp: _sky(sky_model, tmp)),
    "fits header": (lambda tmp: _fits(jax_io, jax_params, tmp),
                    lambda tmp: _fits(io, parameters, tmp)),
    "polarization": (lambda tmp: _polarization(jax_pol),
                     lambda tmp: _polarization(polarization)),
    "units": (lambda tmp: _units(jax_units), lambda tmp: _units(units)),
    "primary_beam": (lambda tmp: _beam(jax_pb),
                     lambda tmp: _beam(primary_beam)),
    "primary_beam UHF": (lambda tmp: _beam(jax_pb, "UHF"),
                         lambda tmp: _beam(primary_beam, "UHF")),
    "metadata": (lambda tmp: _metadata(jax_metadata, tmp),
                 lambda tmp: _metadata(metadata, tmp)),
    "PolynomialSEFDModel": (lambda tmp: _sefd(jax_report),
                            lambda tmp: _sefd(report)),
    "parameters str": (
        lambda tmp: _parameters_str(jax_params, JaxWeightType, JAX_CLEAN_I),
        lambda tmp: _parameters_str(parameters, WeightType, CLEAN_I)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_copy_matches_original(case, tmp_path):
    original, copy = CASES[case]
    want = original(tmp_path / "jax")
    got = copy(tmp_path / "port")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.fixture(autouse=True)
def _dirs(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()


def test_parameters_str_without_jax():
    """The port's parameter objects print (their lazy imports reach the
    port's own ``ops.weights`` and ``ops.clean``) where JAX cannot be
    imported, and print as the JAX package's do."""
    probe = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from katsdpimager_tpu_torch import parameters as p\n"
        "from katsdpimager_tpu_torch.ops.weights import WeightType as W\n"
        "from katsdpimager_tpu_torch.ops.clean import CLEAN_I\n"
        "print(repr([str(p.WeightParameters(W.ROBUST, 0.25)),\n"
        "            str(p.WeightParameters(W.UNIFORM)),\n"
        "            str(p.CleanParameters(100, 0.1, 0.85, 5.0, CLEAN_I,\n"
        "                                  0.01, 0.5, 0.02))]))\n"
        "assert not any(m == 'katsdpimager_tpu'\n"
        "               or m.startswith('katsdpimager_tpu.')\n"
        "               for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = _parameters_str(jax_params, JaxWeightType, JAX_CLEAN_I)[2:]
    assert out.stdout.strip() == repr(want)


def test_native_builds_into_the_port():
    """The port's C++ core is built from its own source into its own
    ``_build/native/`` directory."""
    native.load()
    path = pathlib.Path(native.lib_path())
    assert path.exists()
    port_dir = pathlib.Path(port_pkg.__file__).parent
    assert path.parent == port_dir / "_build" / "native"
    assert pathlib.Path(jax_pkg.__file__).parent not in path.parents


def _state_dir(tmp_path):
    """A fixed pipeline ``state.json`` (three channels, one without
    data, an observation summary) and one channel thumbnail."""
    rng = np.random.default_rng(12)
    state = {"observation": {
        "antenna_positions": (np.array([[5109224.0, 2006790.0, -3239100.0]]
                                       * 4) + np.arange(4)[:, None] * 60
                              ).tolist(),
        "phase_centre": [0.9, -0.61],
        "time_range": [1590969600.0, 1590976800.0],
        "uvw_samples": rng.uniform(-800, 800, size=(200, 3)).tolist(),
        "band": "L"}}
    for ch, f in enumerate((1.0e9, 1.0002e9, 1.0004e9)):
        if ch == 1:
            state["status/1"] = "no-data"
            continue
        state[f"stats/{ch}"] = {
            "noise": 1e-4 * (1 + ch), "weights_noise": 8e-5, "peak": 1.5,
            "minor": 40 + ch, "major": 2, "totals": {"I": 5.2 - 0.1 * ch},
            "compressed_vis": 1911, "frequency": f}
        state[f"status/{ch}"] = "complete"
    path = tmp_path / "state.json"
    path.write_text(json.dumps(state))
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(1, 1), dpi=32)
    ax.imshow(rng.normal(size=(16, 16)))
    fig.savefig(tmp_path / "image_00000_clean.png")
    plt.close(fig)
    return path


_PNG = re.compile(r"data:image/png;base64,([A-Za-z0-9+/=]+)")


def _report_parts(html_text):
    """(the HTML with each embedded PNG replaced by a placeholder, the
    PNGs decoded to pixel arrays)."""
    import matplotlib.image as mpimg

    pngs = [mpimg.imread(_io.BytesIO(base64.b64decode(b)), format="png")
            for b in _PNG.findall(html_text)]
    return _PNG.sub("data:image/png;base64,PNG", html_text), pngs


def test_report_matches_original(tmp_path):
    """``report.write_report`` on a fixed ``state.json`` with an images
    directory writes the original's HTML: the text equal, each embedded
    plot and thumbnail equal as a decoded PNG pixel array."""
    pytest.importorskip("matplotlib")
    state = _state_dir(tmp_path)
    want_path, got_path = tmp_path / "jax.html", tmp_path / "port.html"
    jax_report.write_report(str(state), str(want_path), "QA",
                            str(tmp_path))
    assert report.main([str(state), str(got_path), "--title", "QA"]) == 0
    want_text, want_png = _report_parts(want_path.read_text())
    got_text, got_png = _report_parts(got_path.read_text())
    assert got_text == want_text
    assert len(got_png) == len(want_png) >= 6
    for g, w in zip(got_png, want_png):
        np.testing.assert_array_equal(g, w)


def test_fits_video_matches_original(tmp_path):
    """``fits_video.main`` on two FITS images writes the original's
    animation (a GIF through Pillow; ffmpeg is not needed), bitwise."""
    pytest.importorskip("matplotlib")
    import matplotlib.animation as animation

    if "pillow" not in animation.writers.list():
        pytest.skip("matplotlib's Pillow animation writer is not available")
    ip, _ = _grid_setup(parameters, pixels=32)
    rng = np.random.default_rng(5)
    for ch in range(2):
        io.write_fits_image(rng.normal(size=(1, 32, 32)).astype(np.float32),
                            ip, str(tmp_path / f"image_{ch:05d}_clean.fits"),
                            (0.3, -0.5))
    pattern = str(tmp_path / "image_*_clean.fits")
    outs = []
    for mod, name in ((jax_fits_video, "jax.gif"), (fits_video, "port.gif")):
        assert mod.main([pattern, str(tmp_path / name), "--fps", "2",
                         "--dpi", "20"]) == 0
        outs.append((tmp_path / name).read_bytes())
    assert outs[0] == outs[1] and len(outs[0]) > 0


@pytest.mark.parametrize("band", ["L", "UHF"])
def test_bundled_beam_npz_is_hdf5_to_npz_of_jax_table(band, tmp_path):
    """The port's bundled MeerKAT table is ``hdf5_to_npz`` of the JAX
    package's HDF5 table: regenerated here, its arrays equal the
    shipped ``.npz``'s bitwise."""
    table = os.path.join("models", "beams", "meerkat", "v1", f"beam_{band}")
    made = tmp_path / "beam.npz"
    primary_beam.hdf5_to_npz(
        os.path.join(os.path.dirname(jax_pkg.__file__), table + ".h5"),
        str(made))
    with np.load(made) as want, np.load(os.path.join(
            os.path.dirname(port_pkg.__file__), table + ".npz")) as got:
        assert sorted(got.files) == sorted(want.files) == [
            "beam", "frequency", "radius"]
        for k in want.files:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("band", ["L", "UHF"])
def test_meerkat_beam_without_h5py(band, monkeypatch):
    """The port reads its MeerKAT beam tables from ``.npz`` copies of the
    HDF5 files (the card's machine has no h5py): with h5py unimportable
    the beam equals the JAX package's, read from HDF5, bitwise."""
    want = _beam(jax_pb, band)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py  # noqa: F401
    got = _beam(primary_beam, band)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
