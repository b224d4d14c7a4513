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
  with ``common = cb * n / taper^2`` and ``ph = 2 pi w (n - 1)``.

Image -> grid (forward DFT, for the degridder):

- **K6** (:func:`pre_col_fft`): from the transposed model image,
  ``layer = img * cb / (taper^2 n) * exp(-2 pi i w (n - 1))`` in
  registers, then ``colDFT(layer)``, stored transposed;
- **K7** (:func:`cbout_col_fft`): ``cb * colDFT(x)``, stored in place:
  ``colDFT(swap(colDFT(layerT))) == DFT2(layer)`` the right way round.

The 2-D transform building block:

- **K8** (:func:`col_fft`): the plain unnormalised column DFT, sign +1 or
  -1, stored in natural orientation; :func:`fft2` drives it twice, as the
  JAX package's ``fft2_pallas`` does.  K8 runs on the four-step
  column-FFT tile core (``csrc/col_fft_tile.cuh``); K3, K4, K6 and K7 on
  the radix-2 core of ``csrc/fft.cu``.

The dirty image stays TRANSPOSED across the W-slice loop (every factor is
symmetric in (row, col)); the caller transposes it once per channel.

The kernels are hand-written CUDA (``csrc/fft.cu``) for power-of-two N
from 256 to 8192; other sizes raise on CUDA.  Each has a plain PyTorch
version here (``torch.fft.ifft(..., norm="forward")`` is the
unnormalised inverse, ``torch.fft.fft`` the unnormalised forward), which
CPU tensors run at any even N.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _build

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
def twiddles(n: int, device: torch.device) -> torch.Tensor:
    """exp(+2 pi i k / n) for k < n/2: computed in float64, stored as
    complex64 on ``device`` (the kernels' twiddle table)."""
    k = np.arange(n // 2)
    t = np.exp(2j * np.pi * k / n).astype(np.complex64)
    return torch.from_numpy(t).to(device)


@functools.lru_cache(maxsize=16)
def twiddles_full(n: int, device: torch.device) -> torch.Tensor:
    """exp(+2 pi i k / n) for k < n: computed in float64, stored as
    complex64 on ``device`` (K8's twiddle table)."""
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
    ``y = ifft(cb * (gr + i gi), dim=-2)`` unnormalised, transposed."""
    cb = checkerboard(gr.shape[-1], gr.device)
    y = torch.fft.ifft(torch.complex(gr * cb, gi * cb), dim=-2,
                       norm="forward")
    return (y.real.transpose(-1, -2).contiguous(),
            y.imag.transpose(-1, -2).contiguous())


def cb_col_fft(gr, gi):
    """K3: checkerboard, unnormalised inverse DFT of every column,
    transposed store.  gr/gi (P, N, N) f32 -> new (P, N, N) f32 pair.

    CPU tensors run :func:`cb_col_fft_plain`; CUDA tensors launch
    ``ktt_cb_col_fft`` (``csrc/fft.cu``) or raise.

    Replaces ``katsdpimager_tpu/ops/pallas_fft.py:_make_cb_col_kernel``
    and the transpose after it.  Bound by shared-memory traffic of the
    radix-2 passes and the strided column loads; the transposed store is
    coalesced."""
    if gr.device.type == "cpu":
        return cb_col_fft_plain(gr, gi)
    P, n, _ = gr.shape
    _check_kernel_size(n)
    _build.expect(gr, "gr", torch.float32, (P, n, n), gr.device)
    _build.expect(gi, "gi", torch.float32, (P, n, n), gr.device)
    tw = twiddles(n, gr.device)
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
# K4


def epi_col_fft_plain(ar_t, ai_t, imageT, taper, scal):
    """Plain PyTorch version of K4 (same arguments as :func:`epi_col_fft`),
    with the f32 formulas of the JAX epilogue.  Updates ``imageT`` in
    place and returns it."""
    n = ar_t.shape[-1]
    dev = ar_t.device
    y = torch.fft.ifft(torch.complex(ar_t, ai_t), dim=-2, norm="forward")
    w, ps = scal[0], scal[1]
    idx = torch.arange(n, device=dev, dtype=torch.float32)
    half = 0.5 * n
    lm_r = ((idx - half) * ps)[:, None]
    lm_c = ((idx - half) * ps)[None, :]
    n_lm = sqrt_rn(1.0 - lm_r * lm_r - lm_c * lm_c)
    phase = ((2.0 * math.pi) * w) * (n_lm - 1.0)
    taper2 = taper[:, None] * taper[None, :]
    common = checkerboard(n, dev) * n_lm / taper2
    imageT.copy_((imageT + y.real * (torch.cos(phase) * common))
                 - y.imag * (torch.sin(phase) * common))
    return imageT


def epi_col_fft(ar_t, ai_t, imageT, taper, scal):
    """K4: unnormalised inverse column DFT of the transposed pass-A
    output, imaging corrections, accumulated into ``imageT`` in place.

    ar_t/ai_t/imageT (P, N, N) f32; taper (N,) f32; scal (2,) f32 holding
    the slice's mid-w and the pixel size (on the device, so no sync).
    Returns ``imageT``.

    CPU tensors run :func:`epi_col_fft_plain`; CUDA tensors launch
    ``ktt_epi_col_fft`` (``csrc/fft.cu``) or raise.

    Replaces ``katsdpimager_tpu/ops/pallas_fft.py:_make_epi_col_kernel``.
    Bound like K3; the epilogue is computed in registers from the
    indices, so it adds one read-modify-write of the image and no other
    pass."""
    if ar_t.device.type == "cpu":
        return epi_col_fft_plain(ar_t, ai_t, imageT, taper, scal)
    dev = ar_t.device
    P, n, _ = ar_t.shape
    _check_kernel_size(n)
    for name, t in (("ar_t", ar_t), ("ai_t", ai_t), ("imageT", imageT)):
        _build.expect(t, name, torch.float32, (P, n, n), dev)
    _build.expect(taper, "taper", torch.float32, (n,), dev)
    _build.expect(scal, "scal", torch.float32, (2,), dev)
    tw = twiddles(n, dev)
    err = _build.load().ktt_epi_col_fft(
        ar_t.data_ptr(), ai_t.data_ptr(), tw.data_ptr(), taper.data_ptr(),
        scal.data_ptr(), imageT.data_ptr(), P, n, _build.stream_of(ar_t))
    _build.check(err, "ktt_epi_col_fft")
    epi_col_fft.launches += 1
    return imageT


epi_col_fft.launches = 0


def scalars(w, pixel_size, device) -> torch.Tensor:
    """K4's (2,) f32 ``[w, pixel_size]`` on ``device``."""
    return torch.stack([torch.as_tensor(w, dtype=torch.float32, device=device),
                        torch.as_tensor(pixel_size, dtype=torch.float32,
                                        device=device)])


def grid_to_image_fused_parts(gr, gi, imageT, kernel1d, w, pixel_size, *,
                              plain: bool = False):
    """K3 then K4: accumulate one W slice's (P, N, N) f32 grid planes into
    the TRANSPOSED dirty image ``imageT`` (in place; returned).
    ``plain`` runs both kernels' plain versions whatever the device."""
    scal = scalars(w, pixel_size, gr.device)
    taper = kernel1d.to(device=gr.device, dtype=torch.float32).contiguous()
    k3 = cb_col_fft_plain if plain else cb_col_fft
    k4 = epi_col_fft_plain if plain else epi_col_fft
    ar_t, ai_t = k3(gr, gi)
    return k4(ar_t, ai_t, imageT, taper, scal)


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

    CPU tensors run :func:`pre_col_fft_plain`; CUDA tensors launch
    ``ktt_pre_col_fft`` (``csrc/fft.cu``) or raise.

    Replaces ``katsdpimager_tpu/ops/pallas_fft.py:_make_pre_col_kernel``
    and the transpose after it.  Bound like K3 (shared-memory radix-2
    passes, strided column loads); the prologue is computed from the
    indices as the columns load, so it adds no memory pass."""
    if imageT.device.type == "cpu":
        return pre_col_fft_plain(imageT, taper, scal)
    dev = imageT.device
    P, n, _ = imageT.shape
    _check_kernel_size(n)
    _build.expect(imageT, "imageT", torch.float32, (P, n, n), dev)
    _build.expect(taper, "taper", torch.float32, (n,), dev)
    _build.expect(scal, "scal", torch.float32, (2,), dev)
    tw = twiddles(n, dev)
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

    CPU tensors run :func:`cbout_col_fft_plain`; CUDA tensors launch
    ``ktt_cbout_col_fft`` (``csrc/fft.cu``) or raise.

    Replaces ``katsdpimager_tpu/ops/pallas_fft.py:_make_cbout_col_kernel``.
    Bound like K3."""
    if xr.device.type == "cpu":
        return cbout_col_fft_plain(xr, xi)
    P, n, _ = xr.shape
    _check_kernel_size(n)
    _build.expect(xr, "xr", torch.float32, (P, n, n), xr.device)
    _build.expect(xi, "xi", torch.float32, (P, n, n), xr.device)
    tw = twiddles(n, xr.device)
    yr = torch.empty_like(xr)
    yi = torch.empty_like(xr)
    err = _build.load().ktt_cbout_col_fft(
        xr.data_ptr(), xi.data_ptr(), tw.data_ptr(), yr.data_ptr(),
        yi.data_ptr(), P, n, _build.stream_of(xr))
    _build.check(err, "ktt_cbout_col_fft")
    cbout_col_fft.launches += 1
    return yr, yi


cbout_col_fft.launches = 0


def image_to_grid_fused_parts(imageT, kernel1d, w, pixel_size, *,
                              plain: bool = False):
    """K6 then K7: the TRANSPOSED real (P, N, N) model image to the
    untransposed (P, N, N) f32 grid planes ``(gr, gi)``, centre at the
    middle (K5's input).  ``plain`` runs both kernels' plain versions
    whatever the device."""
    scal = scalars(w, pixel_size, imageT.device)
    taper = kernel1d.to(device=imageT.device,
                        dtype=torch.float32).contiguous()
    k6 = pre_col_fft_plain if plain else pre_col_fft
    k7 = cbout_col_fft_plain if plain else cbout_col_fft
    ar_t, ai_t = k6(imageT, taper, scal)
    return k7(ar_t, ai_t)


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

    CPU tensors run :func:`col_fft_plain`; CUDA tensors launch
    ``ktt_col_fft`` (``csrc/fft.cu``) or raise.  N must be a power of two
    in [256, 8192]; M is free (a ragged last column tile is masked).

    Replaces ``katsdpimager_tpu/ops/pallas_fft.py:_make_col_kernel``
    (``col_fft``).  Bound by device memory (one read and one write of both
    planes).  One launch: a cluster of Q CTAs per 16-column tile splits
    N = Q R four-step, each CTA doing a length-R DFT in two
    register-resident radix passes and the cluster a length-Q DFT over
    its shared memory (``csrc/col_fft_tile.cuh``)."""
    if xr.device.type == "cpu":
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
