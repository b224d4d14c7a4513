"""Numerics probes P1 and P2: does a product on this card's tensor cores
keep f32 exact?

Counterpart of the JAX package's ``scripts/mosaic_num_probe.py`` (probes
A, B, C) and ``scripts/mosaic_num_probe2.py`` (probes E, F), over the
same data (``numpy.random.default_rng(0)``: an (W, L) f32 table, M
indices, four (M, L) f32 matrices; M = W = 256, L = 128).  There each
probe was a small Pallas kernel that asked what the TPU's matrix unit
does to f32 data; here each is a small CUDA kernel (``csrc/probe.cu``,
``wgmma`` with operands in shared memory) that asks the same of the
tensor-core route a kernel of the port takes:

- **A**: one-hot selection through bf16 tensor cores (f32 accumulation)
  from the table split three ways into bf16 (hi, mid, lo), recombined
  ``(hi + mid) + lo``.  Exact.
- **B**: the f32 one-hot selection on the TF32 tensor cores in
  f32-faithful form (the counterpart of the TPU's ``Precision.HIGHEST``):
  the table split into three TF32 pieces, whose sum rebuilds every value.
  Exact.  (K1's two pieces would leave up to 2^-22 of each value.)
- **C**: the stacked band dot ``[a, b]^T [c, d]`` by 3xTF32 with K1's
  split and accumulation (``lo hi + hi lo + hi hi`` into one tensor-core
  accumulator, promoted into f32 totals every ``PROMOTE_STEPS`` k-steps
  of 8: ``csrc/wgmma.cuh``), against the same dot of the four separate
  blocks in one launch, both against a float64 product: <= 1e-6
  relative.  The same dot in one TF32 pass is printed (about 3e-4): the
  trap behind the port's rule that no f32 dot runs in TF32.
- **E**: the recombine with no dot.  Exact.
- **F**: the raw selected thirds against the host's split.  Exact.

Each kernel wrapper runs its plain PyTorch version where
:func:`.device.runs_plain` holds and otherwise launches its kernel, or
raises.  The plain versions do
each kernel's arithmetic: the same splits, f32 products of the pieces.
``python -m katsdpimager_tpu_torch.probes`` prints the scripts' lines
(``--host``: the plain versions on the CPU).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .device import runs_plain
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


def split_tf32(x, pieces: int) -> list:
    """The ``pieces`` TF32 pieces of f32 ``x``, each rounded to nearest
    (ties away): piece i is ``tf32_rna`` of ``x`` less the pieces before
    it.  Two are K1's hi and lo; three rebuild every f32 value exactly
    (3 x 11 significant bits cover f32's 24)."""
    out = []
    for _ in range(pieces):
        out.append(tf32_rna(x))
        x = x - out[-1]
    return out


# ---------------------------------------------------------------------------
# Plain versions


def select_bf16_plain(idx, tab, recombine: bool):
    """Plain version of probes A (``recombine``) and F: the one-hot
    selection of the rows ``idx`` of the (W, 3L) bf16 table, as an f32
    matmul, then ``(hi + mid) + lo`` or the raw (M, 3L) selection."""
    sel = _onehot(idx, tab.shape[0]) @ tab.to(torch.float32)
    return _recombined(sel, tab.shape[1] // 3) if recombine else sel


def select_tf32x3_plain(idx, table):
    """Plain version of probe B: the one-hot selection of each of the
    table's three TF32 pieces (f32 matmuls, exact: one nonzero product
    each), summed ``(hi + mid) + lo``."""
    onehot = _onehot(idx, table.shape[0])
    hi, mid, lo = (onehot @ p for p in split_tf32(table, 3))
    return (hi + mid) + lo


def dot_3xtf32_plain(x, y):
    """Plain version of probe C: ``x^T y`` by 3xTF32 with K1's split, the
    f32 products ``lo^T hi + hi^T lo + hi^T hi`` of the two-piece splits
    (a product of two TF32 values is exact in f32), summed in f32 in
    torch's order (the kernel's tensor-core accumulation is not
    modelled)."""
    xh, xl = (p.transpose(0, 1) for p in split_tf32(x, 2))
    yh, yl = split_tf32(y, 2)
    return (xl @ yh + xh @ yl) + xh @ yh


def dot_3xtf32_separate_plain(a, b, c, d):
    """Plain version of probe C's separate form: the (2I, 2J) output whose
    four blocks are :func:`dot_3xtf32_plain` of (a, c), (a, d), (b, c) and
    (b, d), each (Mk, I) or (Mk, J)."""
    i, j = a.shape[1], c.shape[1]
    out = a.new_empty((2 * i, 2 * j))
    for r, x in enumerate((a, b)):
        for q, y in enumerate((c, d)):
            out[r * i:(r + 1) * i, q * j:(q + 1) * j] = dot_3xtf32_plain(x, y)
    return out


def dot_tf32_plain(x, y):
    """Plain version of probe C in one TF32 pass: the inputs rounded to
    TF32, then an f32 matmul (the products of two TF32 values are exact in
    f32)."""
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
    (W, 3L) bf16 -> (M, L) f32; M and L multiples of 64, W of 16, W <=
    256."""
    if runs_plain(idx):
        return select_bf16_plain(idx, tab, True)
    out = _select_bf16(idx, tab, True)
    select_bf16_recombined.launches += 1
    return out


select_bf16_recombined.launches = 0


def select_bf16_raw(idx, tab):
    """Probe F: the same selection stored raw, (M, 3L) f32."""
    if runs_plain(idx):
        return select_bf16_plain(idx, tab, False)
    out = _select_bf16(idx, tab, False)
    select_bf16_raw.launches += 1
    return out


select_bf16_raw.launches = 0


def select_tf32x3(idx, table):
    """Probe B: one-hot selection on the TF32 tensor cores from the
    table's three TF32 pieces.  (M,) int32 and (W, L) f32 -> (M, L) f32;
    M and L multiples of 64, W of 32, W <= 256."""
    if runs_plain(idx):
        return select_tf32x3_plain(idx, table)
    _check(idx, "idx", torch.int32, 1)
    _check(table, "table", torch.float32, 2)
    (m,), (w, l) = idx.shape, table.shape
    out = torch.empty((m, l), dtype=torch.float32, device=idx.device)
    err = _build.load().ktt_probe_select_tf32x3(
        idx.data_ptr(), table.data_ptr(), out.data_ptr(), m, w, l,
        _build.stream_of(idx))
    _build.check(err, "ktt_probe_select_tf32x3")
    select_tf32x3.launches += 1
    return out


select_tf32x3.launches = 0


def _band_dot(xs, ys, split: bool):
    """``[xs]^T [ys]`` for one or two (Mk, xb) blocks ``xs`` side by side
    and likewise ``ys``, in one launch: out (len(xs) xb, len(ys) yb)."""
    for name, t in [("x", x) for x in xs] + [("y", y) for y in ys]:
        _check(t, name, torch.float32, 2)
    mk, xb = xs[0].shape
    yb = ys[0].shape[1]
    if any(x.shape != (mk, xb) for x in xs) or any(
            y.shape != (mk, yb) for y in ys):
        raise ValueError("blocks differ in shape: "
                         f"{[tuple(t.shape) for t in xs + ys]}")
    i, j = len(xs) * xb, len(ys) * yb
    out = torch.empty((i, j), dtype=torch.float32, device=xs[0].device)
    err = _build.load().ktt_probe_band_dot(
        xs[0].data_ptr(), xs[-1].data_ptr(), ys[0].data_ptr(),
        ys[-1].data_ptr(), out.data_ptr(), mk, i, j, xb, yb, int(split),
        _build.stream_of(out))
    _build.check(err, "ktt_probe_band_dot")
    return out


def dot_3xtf32(x, y):
    """Probe C, stacked: ``x^T y`` by 3xTF32 ``wgmma`` with K1's split and
    accumulation, x (Mk, I), y (Mk, J) f32 -> (I, J); Mk a multiple of 32
    up to 256, I and J multiples of 64."""
    if runs_plain(x):
        return dot_3xtf32_plain(x, y)
    out = _band_dot((x,), (y,), True)
    dot_3xtf32.launches += 1
    return out


dot_3xtf32.launches = 0


def dot_3xtf32_separate(a, b, c, d):
    """Probe C, separate: the (2I, 2J) output of the four block dots
    ``a^T c``, ``a^T d``, ``b^T c``, ``b^T d`` by 3xTF32, in one launch
    that writes each block in place; a, b (Mk, I), c, d (Mk, J) f32."""
    if runs_plain(a):
        return dot_3xtf32_separate_plain(a, b, c, d)
    out = _band_dot((a, b), (c, d), True)
    dot_3xtf32_separate.launches += 1
    return out


dot_3xtf32_separate.launches = 0


def dot_tf32(x, y):
    """Probe C in one TF32 ``wgmma`` pass, no split: ``x^T y`` as
    :func:`dot_3xtf32` takes it."""
    if runs_plain(x):
        return dot_tf32_plain(x, y)
    out = _band_dot((x,), (y,), False)
    dot_tf32.launches += 1
    return out


dot_tf32.launches = 0


def recombine(tab):
    """Probe E: ``(hi + mid) + lo`` of the (W, 3L) bf16 table, no dot ->
    (W, L) f32; L a multiple of 8."""
    if runs_plain(tab):
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
P1 = (select_bf16_recombined, select_tf32x3, dot_3xtf32, dot_3xtf32_separate,
      dot_tf32)
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


def cases(d) -> list:
    """``(name, probe, kernel call, plain call)`` for every probe on the
    inputs ``d`` of :func:`inputs`; ``probe`` is ``"P1"`` or ``"P2"``.
    Each kernel call is one launch."""
    idx, tab, table, av, bu = d["idx"], d["tab"], d["table"], d["av"], d["bu"]
    sep = (d["a"], d["b"], d["c"], d["d"])
    return [
        ("A", "P1", lambda: select_bf16_recombined(idx, tab),
         lambda: select_bf16_plain(idx, tab, True)),
        ("B", "P1", lambda: select_tf32x3(idx, table),
         lambda: select_tf32x3_plain(idx, table)),
        ("C_stacked", "P1", lambda: dot_3xtf32(av, bu),
         lambda: dot_3xtf32_plain(av, bu)),
        ("C_separate", "P1", lambda: dot_3xtf32_separate(*sep),
         lambda: dot_3xtf32_separate_plain(*sep)),
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
