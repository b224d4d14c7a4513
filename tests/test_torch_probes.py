"""The numerics probes P1 and P2: the port's plain versions against the
JAX package's Pallas probes (``scripts/mosaic_num_probe.py`` and
``scripts/mosaic_num_probe2.py``, imported unedited, Pallas in interpret
mode).  Each probe's error must be what the JAX probe prints: exactly 0
where that is 0, and f32 rounding (<= 1e-6 relative) for the band dot.
The plain versions do the arithmetic of the card's kernels (three TF32
pieces for B, 3xTF32 for C), and ``chip_smoke``'s probe bound counts each
dot on the unit that runs it."""

import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
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


def _ulp_bits(x):
    return x.contiguous().view(torch.int32) & 0x1FFF


@pytest.fixture(scope="module")
def inputs():
    return probes.inputs("cpu")


def test_three_tf32_pieces_rebuild_every_value(inputs):
    """B's split: three TF32 pieces (each with 13 low mantissa bits 0)
    whose sum (hi + mid) + lo is every table value, bit for bit."""
    table = inputs["table"]
    pieces = probes.split_tf32(table, 3)
    for p in pieces:
        assert not bool(_ulp_bits(p).any())
    hi, mid, lo = pieces
    assert bool(lo.ne(0).any())       # three pieces are needed here
    assert torch.equal((hi + mid) + lo, table)
    got = probes.select_tf32x3_plain(inputs["idx"], table)
    assert torch.equal(got, table[inputs["idx"].long()])


def test_two_piece_split_selection_is_not_exact(inputs):
    """K1's split (hi, lo) through the same one-hot product leaves the
    third piece out: not exact, within 2^-22 of each value."""
    table, idx = inputs["table"], inputs["idx"]
    onehot = probes._onehot(idx, table.shape[0])
    hi, lo = probes.split_tf32(table, 2)
    got = (onehot @ hi + onehot @ lo).double()
    want = table[idx.long()].double()
    rel = ((got - want).abs() / want.abs()).max().item()
    assert 0.0 < rel <= 2.0 ** -22


@pytest.mark.parametrize("form", ["stacked", "separate"])
def test_3xtf32_band_dot_keeps_f32(inputs, form):
    """C by 3xTF32 with K1's split, both forms: within 1e-6 of float64 relative to its
    largest value, and above 0 (it rounds)."""
    exact = inputs["av"].double().transpose(0, 1) @ inputs["bu"].double()
    if form == "stacked":
        got = probes.dot_3xtf32_plain(inputs["av"], inputs["bu"])
    else:
        got = probes.dot_3xtf32_separate_plain(
            *(inputs[k] for k in "abcd"))
    err = ((got.double() - exact).abs().max() / exact.abs().max()).item()
    assert 0.0 < err <= 1e-6


def test_separate_plain_fills_the_four_blocks(inputs):
    """The one-call separate form equals the four block dots bitwise, each
    in its place."""
    a, b, c, d = (inputs[k] for k in "abcd")
    got = probes.dot_3xtf32_separate_plain(a, b, c, d)
    n = a.shape[1]
    for r, x in enumerate((a, b)):
        for q, y in enumerate((c, d)):
            assert torch.equal(got[r * n:(r + 1) * n, q * n:(q + 1) * n],
                               probes.dot_3xtf32_plain(x, y))


#: Each probe's operations by unit at M = W = 256, L = 128: the one-hot
#: selections over W table rows (A over three bf16 thirds, B over three
#: TF32 pieces), the band dot over Mk = 256 (3xTF32: three passes).
PROBE_OPS = {
    "A": {"bf16": 2.0 * 3 * 256 * 256 * 128},
    "B": {"tf32": 2.0 * 3 * 256 * 256 * 128},
    "C_stacked": {"tf32": 2.0 * 3 * 256 ** 3},
    "C_separate": {"tf32": 2.0 * 3 * 256 ** 3},
    "C_tf32": {"tf32": 2.0 * 256 ** 3},
    "E": {},
    "F": {"bf16": 2.0 * 256 * 256 * 384},
}


@pytest.mark.parametrize("name", sorted(PROBE_OPS))
def test_probe_bound_counts_each_dot_on_its_unit(inputs, name):
    """``chip_smoke.probe_bound``: a probe's bound is the larger of its
    bytes (inputs once, output once) and its operations on the unit that
    runs them."""
    out = dict((c[0], c[3]()) for c in probes.cases(inputs))[name]
    keys, _ = chip_smoke.PROBE_WORK[name]
    nbytes = (sum(inputs[k].numel() * inputs[k].element_size()
                  for k in keys) + out.numel() * 4)
    assert chip_smoke.probe_bound(inputs, {name: out}) == chip_smoke.bound(
        nbytes, **PROBE_OPS[name])


def test_group_bound_reads_shared_inputs_once(inputs):
    """P2's group (E and F share the split table) reads the table once."""
    outs = {c[0]: c[3]() for c in probes.cases(inputs) if c[1] == "P2"}
    tab, idx = inputs["tab"], inputs["idx"]
    nbytes = (tab.numel() * 2 + idx.numel() * 4
              + sum(o.numel() * 4 for o in outs.values()))
    assert chip_smoke.probe_bound(inputs, outs) == chip_smoke.bound(
        nbytes, bf16=PROBE_OPS["F"]["bf16"])


@pytest.mark.parametrize("case", range(7))
def test_wrapper_on_the_cpu_runs_its_plain_version(inputs, case):
    """Every probe wrapper, given CPU tensors, runs its plain version and
    counts no launch: P1 has five kernels, P2 two, one launch a call."""
    name, probe, kernel, plain = probes.cases(inputs)[case]
    group = probes.P1 if probe == "P1" else probes.P2
    before = [fn.launches for fn in group]
    assert torch.equal(kernel(), plain()), name
    assert [fn.launches for fn in group] == before
    assert (len(probes.P1), len(probes.P2)) == (5, 2)


def test_cli_runs_on_the_card_unless_host(monkeypatch, capsys):
    """``python -m katsdpimager_tpu_torch.probes`` runs on the CUDA device,
    refuses to run without one, and takes the CPU only with ``--host``."""
    seen = []

    def fake_run(device):
        seen.append(torch.device(device).type)
        return {name: 0.0 for name in probes.LINES}

    monkeypatch.setattr(probes, "run", fake_run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        probes.main([])
    assert probes.main(["--host"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert probes.main([]) == 0
    assert seen == ["cpu", "cuda"]
    capsys.readouterr()
