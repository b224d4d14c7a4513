"""The numerics probes P1 and P2: the port's plain versions against the
JAX package's Pallas probes (``scripts/mosaic_num_probe.py`` and
``scripts/mosaic_num_probe2.py``, imported unedited, Pallas in interpret
mode).  Each probe's error must be what the JAX probe prints: exactly 0
where that is 0, and f32 rounding (<= 1e-6 relative) for the band dot."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from katsdpimager_tpu_torch import probes

SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return _script("mosaic_num_probe"), _script("mosaic_num_probe2")


@pytest.fixture(scope="module")
def port_errors():
    return probes.run("cpu")


def _printed(capsys, fn) -> dict:
    fn()
    out = capsys.readouterr().out
    return {line.split(":")[0].strip(): float(re.search(
        r"rel err ([-+0-9.e]+)", line).group(1)) for line in out.splitlines()}


def test_data_is_the_scripts(scripts):
    p1, p2 = scripts
    d = probes.probe_data()
    for name in ("table", "idx", "a", "b", "c", "d"):
        np.testing.assert_array_equal(d[name], getattr(p1, name))
    np.testing.assert_array_equal(d["table"], p2.table)
    np.testing.assert_array_equal(d["idx"], p2.idx)


def test_split_matches_the_scripts_host_split(scripts):
    _, p2 = scripts
    table = torch.from_numpy(probes.probe_data()["table"])
    for got, want in zip(probes.split3(table), p2.split3_np(p2.table)):
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("probe,keys", [
    ("probe_a", {"A bf16-3split select": "A"}),
    ("probe_b", {"B f32-HI select": "B"}),
    ("probe_c", {"C stacked  band dot": "C_stacked",
                 "C separate band dot": "C_separate"}),
])
def test_p1_matches_jax(scripts, port_errors, capsys, probe, keys):
    jax_errs = _printed(capsys, getattr(scripts[0], probe))
    for line, name in keys.items():
        want, got = jax_errs[line], port_errors[name]
        if want == 0.0:
            assert got == 0.0, (name, got)
        else:
            assert 0.0 < got <= 1e-6 and want <= 1e-6, (name, got, want)


@pytest.mark.parametrize("probe,keys", [
    ("probe_e", {"E in-kernel direct recombine": "E"}),
    ("probe_f", {"F selected hi": "F_hi", "F selected mid": "F_mid",
                 "F selected lo": "F_lo"}),
])
def test_p2_matches_jax(scripts, port_errors, capsys, probe, keys):
    jax_errs = _printed(capsys, getattr(scripts[1], probe))
    for line, name in keys.items():
        assert jax_errs[line] == 0.0
        assert port_errors[name] == 0.0, (name, port_errors[name])


def test_tf32_route_loses_precision(port_errors):
    """The TF32 dot keeps 10 mantissa bits: its error is far above the
    FP32 dot's, the trap the port's no-TF32 rule guards against."""
    assert 1e-5 < port_errors["C_tf32"] < 1e-2
    assert port_errors["C_tf32"] > 100 * port_errors["C_stacked"]
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0])
    np.testing.assert_array_equal(probes.tf32_rna(x).numpy(),
                                  [1.0 + 2.0 ** -10, 1.0, -3.0])


def test_cli_prints_the_scripts_lines(capsys):
    assert probes.main(["--host"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("A bf16-3split select: rel err 0.000e+00")
    assert len(lines) == len(probes.LINES)
