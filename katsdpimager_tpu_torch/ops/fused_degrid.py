r"""Fused degridder: kernel K5 and its prep.

Counterpart of :func:`katsdpimager_tpu.ops.pallas_gridder.degrid_chunks_fused`.
For every visibility ``m`` of every occupied chunk, the model prediction

    pred[p, m] = sum_j sum_k kv[m, j] G[p, av + j, au + k] ku[m, k]

from the chunk's ``2ts x 2ts`` window of the (P, N, N) f32 grid planes
that K7 emits, with the UNCONJUGATED taps ``kv[m, j] = kernel[iv[m],
j - sv[m]]`` (zero outside ``[0, K)``), likewise ``ku``.  The prep is
plain PyTorch: tap rows ``iu/iv = wp O + sub``, in-window shifts clamped
to ``[0, 2ts - K]`` (wider than the gridder's ``[0, ts - 1]``, as in the
JAX degrid) and window anchors clamped to ``[0, ext - 2ts]`` with ``ext =
dense_pad_size``.  The window cells outside the unpadded planes read as
zero, which is what the JAX path's zero re-pad to ``ext`` gave.

The kernel is hand-written CUDA (``csrc/degrid.cu``); its plain PyTorch
version here gathers the windows in groups of chunks, as the plain K1
does, and CPU tensors run it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .fused_gridder import _shifted_rows
from .mxu_gridder import dense_pad_size

#: Chunks per group in the plain K5 (bounds its (P, G, Mc, 2ts) products).
_PLAIN_GROUP = 256

#: Largest ``2 ts`` window whose complex f32 copy fits the 227 KB of
#: shared memory one CUDA block may use.
_MAX_TS2 = 160


def degrid_taps(kernel, plan_uv, plan_sub, plan_wp, plan_anchor, *,
                pixels: int, ts: int):
    """K5's per-chunk inputs: window anchors ``(av, au)`` (NC,) int32 and
    tap rows / shifts ``(iu, iv, su, sv)`` (NC, Mc) int32."""
    K, O = kernel.shape[-1], kernel.shape[1]
    TS2 = 2 * ts
    uv_bias = (K - 1) // 2 - pixels // 2
    wp = plan_wp.to(torch.int32)
    sub = plan_sub.to(torch.int32)
    uv = plan_uv.to(torch.int32)
    anc = plan_anchor.to(torch.int32)
    iu = wp * O + sub[..., 0]
    iv = wp * O + sub[..., 1]
    su = (uv[..., 0] - uv_bias - anc[:, None, 1]).clamp(0, TS2 - K)
    sv = (uv[..., 1] - uv_bias - anc[:, None, 0]).clamp(0, TS2 - K)
    hi = dense_pad_size(pixels, ts) - TS2
    av = anc[:, 0].clamp(0, hi)
    au = anc[:, 1].clamp(0, hi)
    return tuple(t.contiguous() for t in (av, au, iu, iv, su, sv))


def degrid_table(kernel):
    """The UNCONJUGATED kernel rows (W*O, K) complex64 that K5 reads."""
    W, O, K = kernel.shape
    return kernel.reshape(W * O, K).to(torch.complex64).contiguous()


def degrid_planes_plain(gr, gi, av, au, iu, iv, su, sv, table, n: int, *,
                        ts: int):
    """Plain PyTorch version of K5 (same arguments as
    :func:`degrid_planes`): per group of chunks, the windows gathered
    from the zero-padded planes, ``B = ku @ window^T``, then the sum of
    ``kv * B`` over the tap rows."""
    NC, Mc = iu.shape
    P, N, _ = gr.shape
    TS2 = 2 * ts
    K = table.shape[1]
    pred = torch.zeros((NC, Mc, P), dtype=torch.complex64, device=gr.device)
    if n == 0:
        return pred
    ext = dense_pad_size(N, ts)
    pad = (0, ext - N, 0, ext - N)
    g = torch.complex(F.pad(gr, pad), F.pad(gi, pad))      # (P, ext, ext)
    tab = F.pad(torch.view_as_real(table), (0, 0, 0, TS2 - K))
    tab = torch.view_as_complex(tab.contiguous())          # (W*O, TS2)
    offs = torch.arange(TS2, device=gr.device)
    for g0 in range(0, n, _PLAIN_GROUP):
        g1 = min(n, g0 + _PLAIN_GROUP)
        rows = av[g0:g1, None].long() + offs                # (G, TS2)
        cols = au[g0:g1, None].long() + offs
        win = g[:, rows[:, :, None], cols[:, None, :]]      # (P, G, TS2, TS2)
        kv = _shifted_rows(tab, iv[g0:g1], sv[g0:g1], TS2)  # (G, Mc, TS2)
        ku = _shifted_rows(tab, iu[g0:g1], su[g0:g1], TS2)
        b = ku[None] @ win.transpose(-1, -2)                # (P, G, Mc, TS2)
        pred[g0:g1] = (b * kv[None]).sum(-1).permute(1, 2, 0)
    return pred


def degrid_planes(gr, gi, av, au, iu, iv, su, sv, table, n: int, *,
                  ts: int):
    """K5: predict the first ``n`` chunks' visibilities from the grid
    planes.  Returns (NC, Mc, P) complex64, zero for chunks past ``n``.

    gr/gi (P, N, N) f32, the unpadded grid planes (cells outside read as
    zero); av/au (NC,) int32 window anchors in ``[0, ext - 2ts]``;
    iu/iv/su/sv (NC, Mc) int32 tap rows and shifts in ``[0, 2ts - K]``;
    table (W*O, K) complex64, the unconjugated kernel rows.  The ranges
    are :func:`degrid_taps`' invariants; the kernel does not check them.

    CPU tensors run :func:`degrid_planes_plain`; CUDA tensors launch
    ``ktt_degrid_planes`` (``csrc/degrid.cu``) or raise.

    Replaces ``katsdpimager_tpu/ops/pallas_gridder.py:_make_degrid_kernel``.
    Bound by FP32 FMA throughput (K^2 complex MACs per visibility from a
    shared-memory window); one CTA per occupied chunk, a warp per
    visibility with lanes along k (details in the CUDA source).
    """
    if gr.device.type == "cpu":
        return degrid_planes_plain(gr, gi, av, au, iu, iv, su, sv, table, n,
                                   ts=ts)
    dev = gr.device
    NC, Mc = iu.shape
    P, N, _ = gr.shape
    WO, K = table.shape
    TS2 = 2 * ts
    if TS2 > _MAX_TS2 or K > TS2:
        raise NotImplementedError(
            f"K5 takes 2 ts <= {_MAX_TS2} and K <= 2 ts, not ts={ts}, K={K}")
    _build.expect(gr, "gr", torch.float32, (P, N, N), dev)
    _build.expect(gi, "gi", torch.float32, (P, N, N), dev)
    _build.expect(av, "av", torch.int32, (NC,), dev)
    _build.expect(au, "au", torch.int32, (NC,), dev)
    for name, t in (("iu", iu), ("iv", iv), ("su", su), ("sv", sv)):
        _build.expect(t, name, torch.int32, (NC, Mc), dev)
    _build.expect(table, "table", torch.complex64, (WO, K), dev)
    if not 0 <= n <= NC:
        raise ValueError(f"n = {n} outside [0, {NC}]")
    pred = torch.zeros((NC, Mc, P), dtype=torch.complex64, device=dev)
    if n == 0:
        return pred
    err = _build.load().ktt_degrid_planes(
        gr.data_ptr(), gi.data_ptr(), av.data_ptr(), au.data_ptr(),
        iu.data_ptr(), iv.data_ptr(), su.data_ptr(), sv.data_ptr(),
        table.data_ptr(), pred.data_ptr(), n, Mc, P, N, K, TS2,
        _build.stream_of(gr))
    _build.check(err, "ktt_degrid_planes")
    degrid_planes.launches += 1
    return pred


degrid_planes.launches = 0


def degrid_chunks_fused(gr, gi, kernel, plan_uv, plan_sub, plan_wp,
                        plan_anchor, n_chunks: int, *, pixels: int, ts: int,
                        plain: bool = False):
    """Prep plus K5: predicted (NC, Mc, P) complex64 for the first
    ``n_chunks`` chunks (zero past them) from the (P, N, N) f32 grid
    planes.  Callers mask by ``valid`` and apply weights.  ``plain`` runs
    K5's plain version whatever the device."""
    av, au, iu, iv, su, sv = degrid_taps(kernel, plan_uv, plan_sub, plan_wp,
                                         plan_anchor, pixels=pixels, ts=ts)
    k5 = degrid_planes_plain if plain else degrid_planes
    return k5(gr, gi, av, au, iu, iv, su, sv, degrid_table(kernel),
              n_chunks, ts=ts)
