"""Numerics probes P1 and P2: does a dot keep f32 exact on this card?

Counterpart of the JAX package's ``scripts/mosaic_num_probe.py`` (probes
A, B, C) and ``scripts/mosaic_num_probe2.py`` (probes E, F), over the
same data (``numpy.random.default_rng(0)``: an (W, L) f32 table, M
indices, four (M, L) f32 matrices; M = W = 256, L = 128).  There each
probe was a small Pallas kernel that asked what Mosaic's MXU lowering
does to f32 data; here each is a small CUDA kernel (``csrc/probe.cu``)
that asks the same of the route a kernel of the port could take:

- **A**: one-hot selection through bf16 tensor cores (``mma.sync``, f32
  accumulation) from the table split three ways into bf16 (hi, mid, lo),
  recombined ``(hi + mid) + lo``.  Exact.
- **B**: one-hot selection by an FP32 FMA dot.  Exact.
- **C**: the stacked band dot ``[a, b]^T [c, d]`` in FP32 against the
  four separate dots, both against a float64 product: f32 rounding,
  <= 1e-6 relative.  The same dot through TF32 tensor cores is printed
  (about 1e-3): the trap behind the port's rule that no f32 dot runs in
  TF32.
- **E**: the recombine with no dot.  Exact.
- **F**: the raw selected thirds against the host's split.  Exact.

Each kernel wrapper runs its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors, or raises.  ``python -m
katsdpimager_tpu_torch.probes`` prints the scripts' lines (``--host``:
the plain versions on the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .ops import _build
from .ops.fused_gridder import tf32_rna

M, W, L = 256, 256, 128


def probe_data() -> dict:
    """The scripts' data, drawn in their order: table (W, L) f32, idx (M,)
    int32, a, b, c, d (M, L) f32 (numpy)."""
    rng = np.random.default_rng(0)
    data = {"table": rng.normal(size=(W, L)).astype(np.float32),
            "idx": rng.integers(0, W, size=M).astype(np.int32)}
    for name in "abcd":
        data[name] = rng.normal(size=(M, L)).astype(np.float32)
    return data


def split3(x):
    """(hi, mid, lo) bf16 thirds of f32 ``x``: hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest."""
    hi = x.to(torch.bfloat16)
    r1 = x - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def split_table(table):
    """The (W, 3L) bf16 table ``[hi | mid | lo]`` of :func:`split3`."""
    return torch.cat(split3(table), dim=1).contiguous()


def _onehot(idx, width: int):
    cols = torch.arange(width, device=idx.device, dtype=idx.dtype)
    return (idx[:, None] == cols[None, :]).to(torch.float32)


def _recombined(sel, width: int):
    return (sel[:, :width] + sel[:, width:2 * width]) + sel[:, 2 * width:]


# ---------------------------------------------------------------------------
# Plain versions


def select_bf16_plain(idx, tab, recombine: bool):
    """Plain version of probes A (``recombine``) and F: the one-hot
    selection of the rows ``idx`` of the (W, 3L) bf16 table, as an f32
    matmul, then ``(hi + mid) + lo`` or the raw (M, 3L) selection."""
    sel = _onehot(idx, tab.shape[0]) @ tab.to(torch.float32)
    return _recombined(sel, tab.shape[1] // 3) if recombine else sel


def select_f32_plain(idx, table):
    """Plain version of probe B: one-hot f32 matmul."""
    return _onehot(idx, table.shape[0]) @ table


def dot_f32_plain(x, y):
    """Plain version of probe C: ``x^T y`` in f32."""
    return x.transpose(0, 1) @ y


def dot_tf32_plain(x, y):
    """Plain version of probe C through TF32: the inputs rounded to TF32,
    then an f32 matmul (the products of two TF32 values are exact in f32)."""
    return tf32_rna(x).transpose(0, 1) @ tf32_rna(y)


def recombine_plain(tab):
    """Plain version of probe E: ``(hi + mid) + lo`` of the bf16 table."""
    return _recombined(tab.to(torch.float32), tab.shape[1] // 3)


# ---------------------------------------------------------------------------
# Kernel wrappers


def _check(t, name, dtype, ndim):
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise TypeError(f"{name}: want a contiguous {ndim}-d {dtype} tensor, "
                        f"not {t.dtype} {tuple(t.shape)}")


def _select_bf16(idx, tab, recombine: bool):
    _check(idx, "idx", torch.int32, 1)
    _check(tab, "tab", torch.bfloat16, 2)
    m, (w, l3) = idx.shape[0], tab.shape
    out = torch.empty((m, l3 // 3 if recombine else l3), dtype=torch.float32,
                      device=idx.device)
    err = _build.load().ktt_probe_select_bf16(
        idx.data_ptr(), tab.data_ptr(), out.data_ptr(), m, w, l3 // 3,
        int(recombine), _build.stream_of(idx))
    _build.check(err, "ktt_probe_select_bf16")
    return out


def select_bf16_recombined(idx, tab):
    """Probe A: bf16 tensor-core one-hot selection of the (W, 3L) split
    table, recombined ``(hi + mid) + lo`` in registers.  (M,) int32 and
    (W, 3L) bf16 -> (M, L) f32.  CPU tensors run the plain version."""
    if idx.device.type == "cpu":
        return select_bf16_plain(idx, tab, True)
    out = _select_bf16(idx, tab, True)
    select_bf16_recombined.launches += 1
    return out


select_bf16_recombined.launches = 0


def select_bf16_raw(idx, tab):
    """Probe F: the same selection stored raw, (M, 3L) f32.  CPU tensors
    run the plain version."""
    if idx.device.type == "cpu":
        return select_bf16_plain(idx, tab, False)
    out = _select_bf16(idx, tab, False)
    select_bf16_raw.launches += 1
    return out


select_bf16_raw.launches = 0


def select_f32(idx, table):
    """Probe B: one-hot selection by an FP32 FMA dot.  (M,) int32 and
    (W, L) f32 -> (M, L) f32.  CPU tensors run the plain version."""
    if idx.device.type == "cpu":
        return select_f32_plain(idx, table)
    _check(idx, "idx", torch.int32, 1)
    _check(table, "table", torch.float32, 2)
    (m,), (w, l) = idx.shape, table.shape
    out = torch.empty((m, l), dtype=torch.float32, device=idx.device)
    err = _build.load().ktt_probe_select_f32(
        idx.data_ptr(), table.data_ptr(), out.data_ptr(), m, w, l,
        _build.stream_of(idx))
    _build.check(err, "ktt_probe_select_f32")
    select_f32.launches += 1
    return out


select_f32.launches = 0


def _dot(entry, x, y):
    _check(x, "x", torch.float32, 2)
    _check(y, "y", torch.float32, 2)
    if x.shape[0] != y.shape[0]:
        raise ValueError(f"contracted lengths differ: {x.shape} {y.shape}")
    mk, i = x.shape
    j = y.shape[1]
    out = torch.empty((i, j), dtype=torch.float32, device=x.device)
    err = getattr(_build.load(), entry)(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), mk, i, j,
        _build.stream_of(x))
    _build.check(err, entry)
    return out


def dot_f32(x, y):
    """Probe C: ``x^T y`` by FP32 FMA, x (Mk, I), y (Mk, J) f32 -> (I, J).
    CPU tensors run the plain version."""
    if x.device.type == "cpu":
        return dot_f32_plain(x, y)
    out = _dot("ktt_probe_dot_f32", x, y)
    dot_f32.launches += 1
    return out


dot_f32.launches = 0


def dot_tf32(x, y):
    """Probe C through TF32 tensor cores (``mma.sync`` m16n8k8): ``x^T y``
    with I % 16 == J % 8 == Mk % 8 == 0.  CPU tensors run the plain
    version."""
    if x.device.type == "cpu":
        return dot_tf32_plain(x, y)
    out = _dot("ktt_probe_dot_tf32", x, y)
    dot_tf32.launches += 1
    return out


dot_tf32.launches = 0


def recombine(tab):
    """Probe E: ``(hi + mid) + lo`` of the (W, 3L) bf16 table, no dot ->
    (W, L) f32.  CPU tensors run the plain version."""
    if tab.device.type == "cpu":
        return recombine_plain(tab)
    _check(tab, "tab", torch.bfloat16, 2)
    w, l3 = tab.shape
    out = torch.empty((w, l3 // 3), dtype=torch.float32, device=tab.device)
    err = _build.load().ktt_probe_recombine(
        tab.data_ptr(), out.data_ptr(), w, l3 // 3, _build.stream_of(tab))
    _build.check(err, "ktt_probe_recombine")
    recombine.launches += 1
    return out


recombine.launches = 0

#: The kernel wrappers of P1 and P2, for launch counts.
P1 = (select_bf16_recombined, select_f32, dot_f32, dot_tf32)
P2 = (recombine, select_bf16_raw)


# ---------------------------------------------------------------------------
# The probes


def _rel(got, want) -> float:
    want = want.to(torch.float64)
    return float((got.to(torch.float64) - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def inputs(device) -> dict:
    """The probe data as tensors on ``device``, plus the split table
    ``tab`` and the stacked band operands ``av = [a, b]``, ``bu = [c, d]``."""
    d = {k: torch.from_numpy(v).to(device) for k, v in probe_data().items()}
    d["tab"] = split_table(d["table"])
    d["av"] = torch.cat([d["a"], d["b"]], dim=1).contiguous()
    d["bu"] = torch.cat([d["c"], d["d"]], dim=1).contiguous()
    return d


def _separate(dot, d):
    blocks = [[dot(x, y) for y in (d["c"], d["d"])] for x in (d["a"], d["b"])]
    return torch.cat([torch.cat(r, dim=1) for r in blocks])


def cases(d) -> list:
    """``(name, probe, kernel call, plain call)`` for every probe on the
    inputs ``d`` of :func:`inputs`; ``probe`` is ``"P1"`` or ``"P2"``."""
    idx, tab, table, av, bu = d["idx"], d["tab"], d["table"], d["av"], d["bu"]
    return [
        ("A", "P1", lambda: select_bf16_recombined(idx, tab),
         lambda: select_bf16_plain(idx, tab, True)),
        ("B", "P1", lambda: select_f32(idx, table),
         lambda: select_f32_plain(idx, table)),
        ("C_stacked", "P1", lambda: dot_f32(av, bu),
         lambda: dot_f32_plain(av, bu)),
        ("C_separate", "P1", lambda: _separate(dot_f32, d),
         lambda: _separate(dot_f32_plain, d)),
        ("C_tf32", "P1", lambda: dot_tf32(av, bu),
         lambda: dot_tf32_plain(av, bu)),
        ("E", "P2", lambda: recombine(tab), lambda: recombine_plain(tab)),
        ("F", "P2", lambda: select_bf16_raw(idx, tab),
         lambda: select_bf16_plain(idx, tab, False)),
    ]


def run(device) -> dict:
    """Run every probe on ``device``; returns the relative errors by
    name: ``A``, ``B``, ``C_stacked``, ``C_separate``, ``C_tf32``, ``E``,
    ``F_hi``, ``F_mid``, ``F_lo``."""
    d = inputs(device)
    table, idx = d["table"], d["idx"].long()
    exact = d["av"].double().transpose(0, 1) @ d["bu"].double()
    want = {"A": table[idx], "B": table[idx], "C_stacked": exact,
            "C_separate": exact, "C_tf32": exact, "E": table}
    out = {}
    for name, _, kernel, _ in cases(d):
        got = kernel()
        if name != "F":
            out[name] = _rel(got, want[name])
            continue
        for k, (third, split) in enumerate(zip(("hi", "mid", "lo"),
                                               split3(table))):
            out["F_" + third] = _rel(got[:, k * L:(k + 1) * L],
                                     split.to(torch.float32)[idx])
    return out


#: The lines of the scripts, by error name.
LINES = {
    "A": "A bf16-3split select: rel err {:.3e}",
    "B": "B f32-HI select:      rel err {:.3e}",
    "C_stacked": "C stacked  band dot: rel err {:.3e}",
    "C_separate": "C separate band dot: rel err {:.3e}",
    "C_tf32": "C tf32     band dot: rel err {:.3e}",
    "E": "E in-kernel direct recombine: rel err {:.3e}",
    "F_hi": "F selected hi: rel err {:.3e}",
    "F_mid": "F selected mid: rel err {:.3e}",
    "F_lo": "F selected lo: rel err {:.3e}",
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="f32-exactness probes P1 (A, B, C) and P2 (E, F)")
    parser.add_argument("--host", action="store_true",
                        help="run the plain versions on the CPU")
    args = parser.parse_args(argv)
    if args.host:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        parser.error("no CUDA device (use --host for the plain versions)")
    for name, err in run(device).items():
        print(LINES[name].format(err), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
