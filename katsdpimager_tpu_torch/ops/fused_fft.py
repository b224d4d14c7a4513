r"""Fused grid <-> image transforms: kernels K3, K4, K6, K7 and K8.

Counterpart of :func:`katsdpimager_tpu.ops.pallas_fft.grid_to_image_fused_parts`
and :func:`~katsdpimager_tpu.ops.pallas_fft.image_to_grid_fused_parts`.
Each 2-D unnormalised DFT runs as two column passes, with the imaging
corrections riding on one of them.  Grid -> image (inverse DFT):

- **K3** (:func:`cb_col_fft`): ``y = colDFT(cb * x)``, stored transposed
  (the JAX path's XLA transpose between the passes is folded into the
  kernel's store);
- **K4** (:func:`epi_col_fft`): ``Y = colDFT(y)``, then
  ``imgT += Y.re * cos(ph) * common - Y.im * sin(ph) * common`` in place,
  with ``common = cb * n / taper^2`` and ``ph = 2 pi w (n - 1)``; one W
  slice a launch, or several, each slice's update added in turn.

The slice loop takes **K23** (:func:`combine_cb_col_fft`) in place of K2
then K3: K3 whose load sums the gridder's four colour planes as K2 does,
so the slice's grid is never written; each slice's K23 pair goes into a
stack, and K4 takes the channel's stack in one launch, so the image is
read and written once a channel (:class:`SliceStack`).

Image -> grid (forward DFT, for the degridder):

- **K6** (:func:`pre_col_fft`): from the transposed model image,
  ``layer = img * cb / (taper^2 n) * exp(-2 pi i w (n - 1))`` in
  registers, then ``colDFT(layer)``, stored transposed;
- **K7** (:func:`cbout_col_fft`): ``cb * colDFT(x)``, stored in place:
  ``colDFT(swap(colDFT(layerT))) == DFT2(layer)`` the right way round.

The 2-D transform building block:

- **K8** (:func:`col_fft`): the plain unnormalised column DFT, sign +1 or
  -1, stored in natural orientation; :func:`fft2` drives it twice, as the
  JAX package's ``fft2_pallas`` does.

All six run on one four-step column-FFT tile core
(``csrc/col_fft_tile.cuh``), each with its own load and store hooks (K6
also with a per-value hook that computes its prologue after the loads).

The dirty image stays TRANSPOSED across the W-slice loop (every factor is
symmetric in (row, col)); the caller transposes it once per channel.

The kernels are hand-written CUDA (``csrc/fft.cu``) for power-of-two N
from 256 to 8192; other sizes raise on CUDA.  Each has a plain PyTorch
version here (``torch.fft.ifft(..., norm="forward")`` is the
unnormalised inverse, ``torch.fft.fft`` the unnormalised forward), which
runs at any even N where :func:`..device.runs_plain` says.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import device as device_mod
from ..device import runs_plain
from ..profiling import profile
from . import _build
from .fused_gridder import combine_planes_plain

#: Power-of-two sizes the CUDA kernels take.
MIN_N, MAX_N = 256, 8192


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root (as CUDA's ``sqrtf``).  PyTorch's
    CPU ``sqrt`` is off by one ulp at some inputs, and the W-phase
    ``2 pi w (n - 1)`` turns one ulp of ``n`` into a phase error of
    ``2 pi w * 6e-8``; the square root taken in float64 and rounded once
    is exact."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def checkerboard(n: int, device) -> torch.Tensor:
    """(-1)^(r+c) over an (n, n) f32 array."""
    s = 1.0 - 2.0 * (torch.arange(n, device=device) % 2).to(torch.float32)
    return s[:, None] * s[None, :]


@functools.lru_cache(maxsize=16)
def twiddles_full(n: int, device: torch.device) -> torch.Tensor:
    """exp(+2 pi i k / n) for k < n: computed in float64, stored as
    complex64 on ``device`` (the tile core's twiddle table)."""
    k = np.arange(n)
    t = np.exp(2j * np.pi * k / n).astype(np.complex64)
    return torch.from_numpy(t).to(device)


def kernel_size_ok(n: int) -> bool:
    """Whether the column-DFT kernels take columns of length ``n``."""
    return not n & (n - 1) and MIN_N <= n <= MAX_N


def _check_kernel_size(n: int) -> None:
    if not kernel_size_ok(n):
        raise NotImplementedError(
            f"the column-DFT kernels take power-of-two N in [{MIN_N}, "
            f"{MAX_N}], not {n}; 2^a 3^b 5^c 7^d sizes are not ported yet")


# ---------------------------------------------------------------------------
# K3


def cb_col_fft_plain(gr, gi):
    """Plain PyTorch version of K3: ``(yT_re, yT_im)`` with
    ``y = ifft(cb * (gr + i gi), dim=-2)`` unnormalised, transposed.
    Each plane is transformed on its own, so that, as in the kernel, a
    plane's result does not depend on the planes beside it (the CPU's
    ``torch.fft`` rounds a lone plane otherwise than one of a batch, and
    K23 transforms each polarization group's planes apart)."""
    cb = checkerboard(gr.shape[-1], gr.device)
    x = torch.complex(gr * cb, gi * cb)
    y = torch.stack([torch.fft.ifft(p, dim=-2, norm="forward") for p in x])
    return (y.real.transpose(-1, -2).contiguous(),
            y.imag.transpose(-1, -2).contiguous())


def cb_col_fft(gr, gi):
    """K3: checkerboard, unnormalised inverse DFT of every column,
    transposed store.  gr/gi (P, N, N) f32 -> new (P, N, N) f32 pair.

    Runs :func:`cb_col_fft_plain` where
    :func:`..device.runs_plain` holds; otherwise launches
    ``ktt_cb_col_fft`` (``csrc/fft.cu``) or raises.

    Replaces ``katsdpimager_tpu/ops/pallas_fft.py:_make_cb_col_kernel``
    and the transpose after it.  Bound by device memory (one read and one
    write of both planes).  The tile core of :func:`col_fft` with the
    checkerboard applied as the values load; the cluster's finish runs
    along k, so each warp writes 128 contiguous bytes of a transposed row
    (N = 256 and 512, without clusters, stage the rows in shared
    memory)."""
    with profile("k3.launch"):
        if runs_plain(gr):
            return cb_col_fft_plain(gr, gi)
        P, n, _ = gr.shape
        _check_kernel_size(n)
        _build.expect(gr, "gr", torch.float32, (P, n, n), gr.device)
        _build.expect(gi, "gi", torch.float32, (P, n, n), gr.device)
        tw = twiddles_full(n, gr.device)
        yr = torch.empty_like(gr)
        yi = torch.empty_like(gr)
        err = _build.load().ktt_cb_col_fft(
            gr.data_ptr(), gi.data_ptr(), tw.data_ptr(), yr.data_ptr(),
            yi.data_ptr(), P, n, _build.stream_of(gr))
        _build.check(err, "ktt_cb_col_fft")
        cb_col_fft.launches += 1
        return yr, yi


cb_col_fft.launches = 0


# ---------------------------------------------------------------------------
# K23: K2 fused into K3


def combine_cb_col_fft_plain(accr, acci, occ, *, pixels: int, ts: int,
                             out=None):
    """Plain PyTorch version of K23 (same arguments as
    :func:`combine_cb_col_fft`): K2's plain version, then K3's."""
    yr, yi = cb_col_fft_plain(*combine_planes_plain(accr, acci, occ,
                                                    pixels=pixels, ts=ts))
    if out is None:
        return yr, yi
    out[0].copy_(yr)
    out[1].copy_(yi)
    return out


def combine_cb_col_fft(accr, acci, occ, *, pixels: int, ts: int, out=None):
    """K23: K3 on the grid K2 would make from the colour planes, without
    making it.  ``accr``/``acci`` (2, 2, P, ext2, ext2) f32 and ``occ``
    (2, 2, nt2, nt2) bool, as
    :func:`.fused_gridder.combine_planes` takes them, -> K3's transposed
    (P, N, N) f32 pair; with ``out``, a (P, N, N) f32 pair (views of a
    larger pair are fine where contiguous), written into it and returned.
    Bitwise ``cb_col_fft(*combine_planes(accr, acci, occ, ...))``.

    Runs :func:`combine_cb_col_fft_plain` where
    :func:`..device.runs_plain` holds; otherwise launches
    ``ktt_combine_cb_col_fft`` (``csrc/fft.cu``) or raises.  Counts its
    launches in ``combine_cb_col_fft.launches``; a ``k3.launch`` span.

    Replaces, on the slice loop's path, K2 then K3
    (``katsdpimager_tpu/ops/pallas_gridder.py:_make_combine_kernel`` and
    ``katsdpimager_tpu/ops/pallas_fft.py:_make_cb_col_kernel``).  Bound by
    device memory: the colour planes' values in the N x N grid read once
    from occupied blocks, the output written once; the grid K2 wrote and
    K3 read back never exists.  The tile core of :func:`cb_col_fft`,
    whose load reads each value from the shared-memory slot in which the
    kernel has just summed its four terms, a few values at a time, in
    K2's order; an absent term is never read (see the CUDA source)."""
    with profile("k3.launch"):
        if runs_plain(accr):
            return combine_cb_col_fft_plain(accr, acci, occ, pixels=pixels,
                                            ts=ts, out=out)
        dev = accr.device
        _check_kernel_size(pixels)
        _, _, P, ext2, _ = accr.shape
        if ts < 1 or ext2 % (2 * ts):
            raise ValueError(f"K23: plane extent {ext2} is no multiple of "
                             f"2 ts = {2 * ts}")
        nt2 = ext2 // (2 * ts)
        if pixels + ts > ext2:
            raise ValueError(f"K23: pixels {pixels} incompatible with ts "
                             f"{ts} and plane extent {ext2}")
        _build.expect(accr, "accr", torch.float32, (2, 2, P, ext2, ext2), dev)
        _build.expect(acci, "acci", torch.float32, (2, 2, P, ext2, ext2), dev)
        _build.expect(occ, "occ", torch.bool, (2, 2, nt2, nt2), dev)
        if out is None:
            yr = torch.empty((P, pixels, pixels), dtype=torch.float32,
                             device=dev)
            yi = torch.empty_like(yr)
        else:
            yr, yi = out
            _build.expect(yr, "yr", torch.float32, (P, pixels, pixels), dev)
            _build.expect(yi, "yi", torch.float32, (P, pixels, pixels), dev)
        tw = twiddles_full(pixels, dev)
        err = _build.load().ktt_combine_cb_col_fft(
            accr.data_ptr(), acci.data_ptr(), occ.data_ptr(), tw.data_ptr(),
            yr.data_ptr(), yi.data_ptr(), P, pixels, ts, nt2,
            _build.stream_of(accr))
        _build.check(err, "ktt_combine_cb_col_fft")
        combine_cb_col_fft.launches += 1
        return yr, yi


combine_cb_col_fft.launches = 0


# ---------------------------------------------------------------------------
# K4


def epi_col_fft_plain(ar_t, ai_t, imageT, taper, scal):
    """Plain PyTorch version of K4 (same arguments as :func:`epi_col_fft`),
    with the f32 formulas of the JAX epilogue: each slice's update in
    slice order.  Updates ``imageT`` in place and returns it."""
    if ar_t.dim() == 3:
        ar_t, ai_t, scal = ar_t[None], ai_t[None], scal[None]
    n = ar_t.shape[-1]
    dev = ar_t.device
    idx = torch.arange(n, device=dev, dtype=torch.float32)
    half = 0.5 * n
    taper2 = taper[:, None] * taper[None, :]
    for xr, xi, (w, ps) in zip(ar_t, ai_t, scal):
        y = torch.fft.ifft(torch.complex(xr, xi), dim=-2, norm="forward")
        lm_r = ((idx - half) * ps)[:, None]
        lm_c = ((idx - half) * ps)[None, :]
        n_lm = sqrt_rn(1.0 - lm_r * lm_r - lm_c * lm_c)
        phase = ((2.0 * math.pi) * w) * (n_lm - 1.0)
        common = checkerboard(n, dev) * n_lm / taper2
        imageT.copy_((imageT + y.real * (torch.cos(phase) * common))
                     - y.imag * (torch.sin(phase) * common))
    return imageT


def epi_col_fft(ar_t, ai_t, imageT, taper, scal):
    """K4: unnormalised inverse column DFT of the transposed pass-A
    output, imaging corrections, accumulated into ``imageT`` in place.

    ar_t/ai_t (P, N, N) f32 and scal (2,) f32 for one W slice, or
    (S, P, N, N) and (S, 2) for S slices; imageT (P, N, N) f32; taper
    (N,) f32.  ``scal[s]`` holds slice s's mid-w and the pixel size (on
    the device, so no sync).  The slices' updates are added in slice
    order, each as one launch of one slice would add it, so the image is
    bitwise that of S one-slice calls.  Returns ``imageT``.

    Runs :func:`epi_col_fft_plain` where
    :func:`..device.runs_plain` holds; otherwise launches
    ``ktt_epi_col_fft`` (``csrc/fft.cu``) or raises.  Counts its launches
    in ``epi_col_fft.launches`` and the slices they took in
    ``epi_col_fft.slices``; a ``k4.launch`` span.

    Replaces ``katsdpimager_tpu/ops/pallas_fft.py:_make_epi_col_kernel``.
    Bound by device memory: every slice's planes read, the image read
    and written once a launch.  The tile core of :func:`col_fft`, a CTA
    taking its tile through every slice; each finished value takes the
    epilogue, computed in registers from its indices.  Between slices each
    thread keeps its image values in shared memory where that costs the
    SM no CTA (N = 8192), else in the image through L2 under an
    evict-last policy; the first slice's finish reads the image, the last
    one's writes it."""
    with profile("k4.launch"):
        if runs_plain(ar_t):
            return epi_col_fft_plain(ar_t, ai_t, imageT, taper, scal)
        dev = ar_t.device
        S = 1 if ar_t.dim() == 3 else ar_t.shape[0]
        P, n, _ = imageT.shape
        _check_kernel_size(n)
        stacked = (P, n, n) if ar_t.dim() == 3 else (S, P, n, n)
        _build.expect(ar_t, "ar_t", torch.float32, stacked, dev)
        _build.expect(ai_t, "ai_t", torch.float32, stacked, dev)
        _build.expect(imageT, "imageT", torch.float32, (P, n, n), dev)
        _build.expect(taper, "taper", torch.float32, (n,), dev)
        _build.expect(scal, "scal", torch.float32,
                      (2,) if ar_t.dim() == 3 else (S, 2), dev)
        tw = twiddles_full(n, dev)
        err = _build.load().ktt_epi_col_fft(
            ar_t.data_ptr(), ai_t.data_ptr(), tw.data_ptr(), taper.data_ptr(),
            scal.data_ptr(), imageT.data_ptr(), S, P, n,
            _build.stream_of(ar_t))
        _build.check(err, "ktt_epi_col_fft")
        epi_col_fft.launches += 1
        epi_col_fft.slices += S
        return imageT


epi_col_fft.launches = 0
epi_col_fft.slices = 0


def scalars(w, pixel_size, device) -> torch.Tensor:
    """K4's (2,) f32 ``[w, pixel_size]`` on ``device``."""
    return torch.stack([torch.as_tensor(w, dtype=torch.float32, device=device),
                        torch.as_tensor(pixel_size, dtype=torch.float32,
                                        device=device)])


def grid_to_image_fused_parts(gr, gi, imageT, kernel1d, w, pixel_size):
    """K3 then K4: accumulate one W slice's (P, N, N) f32 grid planes into
    the TRANSPOSED dirty image ``imageT`` (in place; returned)."""
    scal = scalars(w, pixel_size, gr.device)
    taper = kernel1d.to(device=gr.device, dtype=torch.float32).contiguous()
    ar_t, ai_t = cb_col_fft(gr, gi)
    return epi_col_fft(ar_t, ai_t, imageT, taper, scal)


class SliceStack:
    """K23 then K4 over a channel's W slices: each slice, given as its
    polarization groups' colour planes, is added into the TRANSPOSED
    dirty image ``imageT`` (in place) through a stack of the slices' K23
    pairs, which K4 takes in one launch, so that the image is read and
    written once a channel, not once a slice.

    ``slices`` is how many slices the channel will :meth:`add`.  The
    stack, (S', P, N, N) f32 twice, is made once the first group's planes
    are, when the gridder's temporaries are gone, as K2's grid was; it
    holds S' = ``slices`` slices where that fits beside the first group's
    planes in the memory free on the device (:func:`..device.free_memory`,
    read then), else as many as fit, at least one: K4 then launches each
    time the stack is full, on consecutive slices, which adds the same
    updates in the same order.  :meth:`flush`, after the last slice,
    launches K4 on what is left."""

    def __init__(self, imageT, kernel1d, pixel_size, *, slices: int,
                 pixels: int, ts: int):
        self.imageT = imageT
        self.taper = kernel1d.to(device=imageT.device,
                                 dtype=torch.float32).contiguous()
        self.pixel_size = pixel_size
        self.slices, self.pixels, self.ts = slices, pixels, ts
        self.yr = self.yi = None
        self.scal = []
        self.added = 0

    def _make(self, planes_bytes: int) -> None:
        """The stack, as deep as :class:`SliceStack` says."""
        dev = self.imageT.device
        pair = 2 * self.imageT.numel() * 4
        fits = (device_mod.free_memory(dev) - planes_bytes) // pair
        depth = max(1, min(self.slices, fits))
        self.yr = torch.empty((depth,) + tuple(self.imageT.shape),
                              dtype=torch.float32, device=dev)
        self.yi = torch.empty_like(self.yr)

    def add(self, groups, w) -> None:
        """K23 of one W slice, given as its polarization groups' colour
        planes (``(p0, p1, accr, acci, occ)`` each, from
        :func:`.fused_gridder.slice_planes`), into the stack: each group's
        planes ``p0:p1`` of the slice's (P, N, N) pair.  ``w`` is the
        slice's mid-w (a 0-d tensor on the device: no sync).  Each
        group's planes are dropped before the next group's are made, so
        one group's are alive at a time."""
        for p0, p1, accr, acci, occ in groups:
            if self.yr is None:
                self._make(2 * accr.numel() * accr.element_size())
            k = len(self.scal)
            combine_cb_col_fft(accr, acci, occ, pixels=self.pixels,
                               ts=self.ts,
                               out=(self.yr[k, p0:p1], self.yi[k, p0:p1]))
            del accr, acci, occ     # before the next group's planes are made
        self.scal.append(scalars(w, self.pixel_size, self.imageT.device))
        self.added += 1
        if len(self.scal) == len(self.yr) and self.added < self.slices:
            self.flush()                # full, with slices still to come

    def flush(self):
        """K4 on the slices added since its last launch (none: nothing);
        returns ``imageT``."""
        k = len(self.scal)
        if k:
            epi_col_fft(self.yr[:k], self.yi[:k], self.imageT, self.taper,
                        torch.stack(self.scal))
            self.scal = []
        return self.imageT


# ---------------------------------------------------------------------------
# K6


def pre_col_fft_plain(imageT, taper, scal):
    """Plain PyTorch version of K6 (same arguments as :func:`pre_col_fft`),
    with the f32 formulas of the JAX prologue."""
    n = imageT.shape[-1]
    dev = imageT.device
    w, ps = scal[0], scal[1]
    idx = torch.arange(n, device=dev, dtype=torch.float32)
    half = 0.5 * n
    lm_r = ((idx - half) * ps)[:, None]
    lm_c = ((idx - half) * ps)[None, :]
    n_lm = sqrt_rn(1.0 - lm_r * lm_r - lm_c * lm_c)
    phase = ((-2.0 * math.pi) * w) * (n_lm - 1.0)
    taper2 = taper[:, None] * taper[None, :]
    pre = imageT * (checkerboard(n, dev) / (taper2 * n_lm))
    y = torch.fft.fft(torch.complex(pre * torch.cos(phase),
                                    pre * torch.sin(phase)), dim=-2)
    return (y.real.transpose(-1, -2).contiguous(),
            y.imag.transpose(-1, -2).contiguous())


def pre_col_fft(imageT, taper, scal):
    """K6: image -> layer prologue, unnormalised forward DFT of every
    column, transposed store.

    imageT (P, N, N) f32, the TRANSPOSED real model image; taper (N,) f32;
    scal (2,) f32 ``[w, pixel_size]`` on the device.  Returns a new
    (P, N, N) f32 pair.

    Runs :func:`pre_col_fft_plain` where
    :func:`..device.runs_plain` holds; otherwise launches
    ``ktt_pre_col_fft`` (``csrc/fft.cu``) or raises.

    Replaces ``katsdpimager_tpu/ops/pallas_fft.py:_make_pre_col_kernel``
    and the transpose after it.  Bound by device memory (one plane read,
    two written).  The tile core of :func:`col_fft` at sign -1: the load
    hook fetches only the image value, and the prologue, computed from
    the indices, runs once all of a thread's loads are in flight, so its
    branches never hold a load back; the transposed store is
    :func:`cb_col_fft`'s."""
    if runs_plain(imageT):
        return pre_col_fft_plain(imageT, taper, scal)
    dev = imageT.device
    P, n, _ = imageT.shape
    _check_kernel_size(n)
    _build.expect(imageT, "imageT", torch.float32, (P, n, n), dev)
    _build.expect(taper, "taper", torch.float32, (n,), dev)
    _build.expect(scal, "scal", torch.float32, (2,), dev)
    tw = twiddles_full(n, dev)
    yr = torch.empty_like(imageT)
    yi = torch.empty_like(imageT)
    err = _build.load().ktt_pre_col_fft(
        imageT.data_ptr(), tw.data_ptr(), taper.data_ptr(), scal.data_ptr(),
        yr.data_ptr(), yi.data_ptr(), P, n, _build.stream_of(imageT))
    _build.check(err, "ktt_pre_col_fft")
    pre_col_fft.launches += 1
    return yr, yi


pre_col_fft.launches = 0


# ---------------------------------------------------------------------------
# K7


def cbout_col_fft_plain(xr, xi):
    """Plain PyTorch version of K7: ``cb * fft(xr + i xi, dim=-2)``
    unnormalised, as an f32 re/im pair."""
    cb = checkerboard(xr.shape[-1], xr.device)
    y = torch.fft.fft(torch.complex(xr, xi), dim=-2)
    return (y.real * cb).contiguous(), (y.imag * cb).contiguous()


def cbout_col_fft(xr, xi):
    """K7: unnormalised forward DFT of every column, times the output
    checkerboard, stored in place of its column.  xr/xi (P, N, N) f32
    (K6's transposed output) -> the (P, N, N) f32 grid planes.

    Runs :func:`cbout_col_fft_plain` where
    :func:`..device.runs_plain` holds; otherwise launches
    ``ktt_cbout_col_fft`` (``csrc/fft.cu``) or raises.

    Replaces ``katsdpimager_tpu/ops/pallas_fft.py:_make_cbout_col_kernel``.
    Bound by device memory (one read and one write of both planes).  The
    tile core of :func:`col_fft` at sign -1; the checkerboard is moved to
    the load, exactly: the input shifted by N/2 rows (which makes
    ``(-1)^k``), odd columns negated."""
    if runs_plain(xr):
        return cbout_col_fft_plain(xr, xi)
    P, n, _ = xr.shape
    _check_kernel_size(n)
    _build.expect(xr, "xr", torch.float32, (P, n, n), xr.device)
    _build.expect(xi, "xi", torch.float32, (P, n, n), xr.device)
    tw = twiddles_full(n, xr.device)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xr)
    err = _build.load().ktt_cbout_col_fft(
        xr.data_ptr(), xi.data_ptr(), tw.data_ptr(), yr.data_ptr(),
        yi.data_ptr(), P, n, _build.stream_of(xr))
    _build.check(err, "ktt_cbout_col_fft")
    cbout_col_fft.launches += 1
    return yr, yi


cbout_col_fft.launches = 0


def image_to_grid_fused_parts(imageT, kernel1d, w, pixel_size):
    """K6 then K7: the TRANSPOSED real (P, N, N) model image to the
    untransposed (P, N, N) f32 grid planes ``(gr, gi)``, centre at the
    middle (K5's input)."""
    scal = scalars(w, pixel_size, imageT.device)
    taper = kernel1d.to(device=imageT.device,
                        dtype=torch.float32).contiguous()
    ar_t, ai_t = pre_col_fft(imageT, taper, scal)
    return cbout_col_fft(ar_t, ai_t)


# ---------------------------------------------------------------------------
# K8


def col_fft_plain(xr, xi, sign: int):
    """Plain PyTorch version of K8: the unnormalised DFT along axis -2 of
    ``xr + i xi`` (``torch.fft.fft`` for ``sign = -1``, the unnormalised
    inverse for ``sign = +1``), as an f32 re/im pair."""
    x = torch.complex(xr, xi)
    if sign == -1:
        y = torch.fft.fft(x, dim=-2)
    elif sign == 1:
        y = torch.fft.ifft(x, dim=-2, norm="forward")
    else:
        raise ValueError(f"sign must be +1 or -1, not {sign}")
    return y.real.contiguous(), y.imag.contiguous()


def col_fft(xr, xi, sign: int):
    """K8: the unnormalised DFT of every column of (..., N, M) f32 re/im
    planes, sign -1 (forward) or +1 (inverse), stored in natural
    orientation.  Returns a new (..., N, M) f32 pair.

    Runs :func:`col_fft_plain` where
    :func:`..device.runs_plain` holds; otherwise launches
    ``ktt_col_fft`` (``csrc/fft.cu``) or raises.  N must be a power of
    two in [256, 8192]; M is free (a ragged last column tile is
    masked).

    Replaces ``katsdpimager_tpu/ops/pallas_fft.py:_make_col_kernel``
    (``col_fft``).  Bound by device memory (one read and one write of both
    planes).  One launch: a cluster of Q CTAs per 16-column tile splits
    N = Q R four-step, each CTA doing a length-R DFT in two
    register-resident radix passes and the cluster a length-Q DFT over
    its shared memory (``csrc/col_fft_tile.cuh``)."""
    if runs_plain(xr):
        return col_fft_plain(xr, xi, sign)
    if sign not in (1, -1):
        raise ValueError(f"sign must be +1 or -1, not {sign}")
    *batch, n, m = xr.shape
    _check_kernel_size(n)
    B = math.prod(batch)
    _build.expect(xr, "xr", torch.float32, xr.shape, xr.device)
    _build.expect(xi, "xi", torch.float32, xr.shape, xr.device)
    tw = twiddles_full(n, xr.device)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xr)
    err = _build.load().ktt_col_fft(
        xr.data_ptr(), xi.data_ptr(), tw.data_ptr(), yr.data_ptr(),
        yi.data_ptr(), B, n, m, sign, _build.stream_of(xr))
    _build.check(err, "ktt_col_fft")
    col_fft.launches += 1
    return yr, yi


col_fft.launches = 0


def fft2(x, sign: int = -1):
    """Unnormalised 2-D DFT over the last two axes of a complex square
    array, as :func:`katsdpimager_tpu.ops.pallas_fft.fft2_pallas`: a K8
    column pass, a swap, a second column pass, a swap back."""
    xr = x.real.to(torch.float32).contiguous()
    xi = x.imag.to(torch.float32).contiguous()
    yr, yi = col_fft(xr, xi, sign)
    zr, zi = col_fft(yr.transpose(-1, -2).contiguous(),
                     yi.transpose(-1, -2).contiguous(), sign)
    return torch.complex(zr.transpose(-1, -2), zi.transpose(-1, -2))
