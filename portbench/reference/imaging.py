r"""The plain reference of W-stacked imaging and degridding, at sampled
pixels.

What the program computes for one channel: each W slice's visibilities
gridded with the conjugated separable kernel
(``grid[v0 + j, u0 + k] += vis * conj(kv[j]) * conj(ku[k])``, with
``u0 = u + N/2 - (K-1)//2``), the grid's unnormalised inverse DFT with
the centring checkerboards, the W correction ``exp(2 pi i w_s (n - 1))``
of the slice's mid-w, the real part, times ``n = sqrt(1 - l^2 - m^2)``
and divided by the separable taper, summed over slices.

The reference evaluates that sum directly at a product set of sampled
rows ``y`` and columns ``x``, without a grid: the transform of a
visibility's footprint is separable,

    L[y, x] = sum_vis vis * A[vis, y] * B[vis, x],
    A[vis, y] = sum_j conj(kv[j]) e^{2 pi i (v0 + j)(y + N/2) / N},

so each slice is two small products over the taps and one over the
visibilities.  Degridding is the transpose: a model of point components
has the grid ``G[v, u] = sum_c f_c cb_c / (t(y_c) t(x_c) n_c)
e^{-i phi_c} e^{-2 pi i (v + N/2) y_c / N} e^{-2 pi i (u + N/2) x_c / N}``
(the image's corrections undone, then the forward DFT), and a
visibility's prediction is ``sum_j sum_k kv[j] ku[k] G[v0 + j, u0 + k]``,
again separable per component.

It runs in float64 or, as the control (``tf32=True``), in float32 with
every product's operands rounded to TF32 (10 mantissa bits), as a
float32 program with TF32 matrix products on would take them.  The
image-plane ``n`` is the single-precision configuration's float32 value
(:func:`n_single`), as katsdpimager computes it: with ``n`` in float64
the program's own float32 rounding of ``n`` (up to 3e-8, times 2 pi w of
up to ~3000 wavelengths) reads 3e-4 of the peak, as much as the TF32
control, and no limit separates the two.  The reference takes the raw
visibilities and works out the kernel tables, taper and mid-w again
(:mod:`.wkernel`); it imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import wkernel

#: The speed of light, m/s.
C_M_PER_S = 299792458.0

#: The anti-aliased field: pixels where taper^2 is at least this share of
#: its peak.  Outside it the division by the taper amplifies float32
#: rounding by up to ~1e4 (katsdpimager's "1e-4 image gate").
FIELD_SHARE = 0.002


def field_axis(taper: np.ndarray) -> np.ndarray:
    """Indices along one axis where the taper is at least sqrt(FIELD_SHARE)
    of its peak, so that every pixel of a product set of such rows and
    columns lies inside the field."""
    return np.flatnonzero(taper >= math.sqrt(FIELD_SHARE) * taper.max())


def sample_axes(seed: int, taper: np.ndarray, count: int):
    """``count`` distinct rows and ``count`` distinct columns inside the
    field, drawn from ``seed``, sorted."""
    rng = np.random.default_rng([seed, 0x5A4D])
    axis = field_axis(taper)
    count = min(count, len(axis))
    rows = np.sort(rng.choice(axis, size=count, replace=False))
    cols = np.sort(rng.choice(axis, size=count, replace=False))
    return rows, cols


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 (or complex64) values to TF32's 10 mantissa bits,
    to nearest, ties to even."""
    if x.is_complex():
        return torch.complex(round_tf32(x.real.contiguous()),
                             round_tf32(x.imag.contiguous()))
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def _phase(a: torch.Tensor, idx: torch.Tensor, pixels: int, cdtype,
           sign: int = 1):
    """exp(sign 2 pi i a (idx + N/2) / N) for int64 ``a`` (n,) and ``idx``
    (L,), the product reduced mod N exactly before the angle is taken."""
    r = (a[:, None] * (idx[None, :] + pixels // 2)) % pixels
    ang = r.to(torch.float64) * (sign * 2 * math.pi / pixels)
    return torch.polar(torch.ones_like(ang), ang).to(cdtype)


def n_single(y, x, *, pixels: int, pixel_size: float) -> torch.Tensor:
    """float64 values of the float32 ``n = sqrt(1 - l^2 - m^2)`` of the
    single-precision configuration at pixel rows ``y`` and columns ``x``
    (broadcast together): ``lm = (index - N/2) * pixel_size``, the
    column's square subtracted from 1 first, then the row's, each step
    rounded to float32, the square root correctly rounded to float32
    (katsdpimager's formula)."""
    f32 = torch.float32
    ps = torch.tensor(pixel_size, dtype=f32)
    half = torch.tensor(0.5 * pixels, dtype=f32)
    lm_y = (torch.as_tensor(y).cpu().to(f32) - half) * ps
    lm_x = (torch.as_tensor(x).cpu().to(f32) - half) * ps
    arg = (1.0 - lm_x * lm_x) - lm_y * lm_y
    return torch.sqrt(arg.to(torch.float64)).to(f32).to(torch.float64)


def weighted(slices, *, pixels: int, weight_type: str) -> list:
    """Each slice's (uv, sub_uv, w_plane, vis, weights) as (uv, sub_uv,
    w_plane, sample), the visibilities as they are gridded: natural
    weights grid them as they are; uniform weights divide each by the sum
    of the channel's statistical weights in its UV cell (over every
    slice, per polarisation), the imaging density."""
    if weight_type == "natural":
        return [(uv, sub, wp, vis) for uv, sub, wp, vis, _ in slices]
    if weight_type != "uniform":
        raise ValueError(f"unknown weight_type {weight_type!r}")
    half = pixels // 2

    def cells(uv):
        return ((uv[:, 1].astype(np.int64) + half) * pixels
                + uv[:, 0].astype(np.int64) + half)

    P = slices[0][3].shape[1]
    total = [np.bincount(np.concatenate([cells(s[0]) for s in slices]),
                         np.concatenate([s[4][:, p] for s in slices]
                                        ).astype(np.float64),
                         minlength=pixels * pixels) for p in range(P)]
    out = []
    for uv, sub, wp, vis, _ in slices:
        c = cells(uv)
        density = np.stack([1.0 / total[p][c] for p in range(P)], axis=1)
        out.append((uv, sub, wp, vis.astype(np.complex128) * density))
    return out


@dataclasses.dataclass
class Channel:
    """One channel's imaging geometry, worked out from the configuration:
    the kernel stack (W, O, K) complex128 on ``device``, the taper and
    each slice's mid-w."""

    pixels: int
    pixel_size: float
    kernel: torch.Tensor
    taper: np.ndarray
    mid_w: np.ndarray
    device: object

    @classmethod
    def of(cls, wavelength: float, conf: dict, device) -> "Channel":
        """From a configuration file's keys (``pixels``, ``pixel_size``,
        ``w_slices``, ``w_planes``, ``max_w_m``, ``kernel_width``,
        ``oversample``, ``antialias_width``, ``image_oversample``)."""
        kern = wkernel.convolution_kernel(
            wavelength, pixels=conf["pixels"], pixel_size=conf["pixel_size"],
            w_slices=conf["w_slices"], w_planes=conf["w_planes"],
            max_w=conf["max_w_m"], kernel_width=conf["kernel_width"],
            oversample=conf["oversample"],
            antialias_width=conf["antialias_width"],
            image_oversample=conf["image_oversample"])
        return cls(conf["pixels"], conf["pixel_size"],
                   torch.from_numpy(kern).to(device),
                   wkernel.taper(conf["pixels"], conf["antialias_width"],
                                 conf["oversample"]),
                   wkernel.mid_w_values(wavelength,
                                        w_slices=conf["w_slices"],
                                        max_w=conf["max_w_m"]),
                   device)

    @property
    def bias(self) -> int:
        """The first footprint cell of a visibility is ``uv - bias``."""
        return (self.kernel.shape[-1] - 1) // 2 - self.pixels // 2

    def _index(self, a):
        a = a if torch.is_tensor(a) else np.asarray(a)
        return torch.as_tensor(a, dtype=torch.int64, device=self.device)

    def _taps(self, uv, sub_uv, w_plane):
        """Per-visibility (n, K) kernel rows (u, v) and first footprint
        cells (u0, v0), on the device."""
        uv = self._index(uv)
        sub = self._index(sub_uv)
        wp = self._index(w_plane)
        return (self.kernel[wp, sub[:, 0]], self.kernel[wp, sub[:, 1]],
                uv[:, 0] - self.bias, uv[:, 1] - self.bias)

    def corrections(self, rows, cols, s: int) -> tuple:
        """(common, w phase) at ``rows x cols`` for slice ``s``:
        ``cb n / (t t)`` and ``exp(2 pi i w_s (n - 1))``, float64."""
        ry, cx = self._index(rows), self._index(cols)
        n = n_single(ry[:, None], cx[None, :], pixels=self.pixels,
                     pixel_size=self.pixel_size).to(self.device)
        cb = 1.0 - 2.0 * ((ry[:, None] + cx[None, :]) % 2).to(torch.float64)
        t = torch.from_numpy(self.taper).to(self.device)
        common = cb * n / (t[ry][:, None] * t[cx][None, :])
        phase = (2 * math.pi * float(self.mid_w[s])) * (n - 1.0)
        return common, torch.polar(torch.ones_like(phase), phase)

    def image(self, slices, rows, cols, *, tf32: bool = False,
              block: int = 1 << 17) -> torch.Tensor:
        """The (P, len(rows), len(cols)) image at ``rows x cols`` of
        ``slices[s]`` = (uv, sub_uv, w_plane, vis) arrays of W slice ``s``
        (vis (n, P) complex, gridded as they are).  float64, or with
        ``tf32`` the control: float32 with TF32-rounded operands in every
        product."""
        N, K = self.pixels, self.kernel.shape[-1]
        rdtype = torch.float32 if tf32 else torch.float64
        cdtype = torch.complex64 if tf32 else torch.complex128
        rnd = round_tf32 if tf32 else (lambda t: t)
        ry, cx = self._index(rows), self._index(cols)
        taps = torch.arange(K, dtype=torch.int64, device=self.device)
        # (-1)^j e^{2 pi i j y / N} = e^{2 pi i j (y + N/2) / N}, per tap j.
        ey = rnd(_phase(taps, ry, N, cdtype))                 # (K, Ly)
        ex = rnd(_phase(taps, cx, N, cdtype))                 # (K, Lx)
        P = np.asarray(slices[0][3]).shape[1]
        image = torch.zeros((P, len(rows), len(cols)), dtype=rdtype,
                            device=self.device)
        for s, (uv, sub_uv, w_plane, vis) in enumerate(slices):
            acc = torch.zeros((P, len(rows), len(cols)), dtype=cdtype,
                              device=self.device)
            for b0 in range(0, len(uv), block):
                b1 = min(len(uv), b0 + block)
                ku, kv, u0, v0 = self._taps(uv[b0:b1], sub_uv[b0:b1],
                                            w_plane[b0:b1])
                vis_b = torch.as_tensor(vis[b0:b1]).to(self.device).to(
                    cdtype)
                a = (rnd(kv.conj().to(cdtype)) @ ey) * _phase(v0, ry, N,
                                                              cdtype)
                b = rnd((rnd(ku.conj().to(cdtype)) @ ex)
                        * _phase(u0, cx, N, cdtype))
                for p in range(P):
                    acc[p] += rnd(vis_b[:, p, None] * a).transpose(0, 1) @ b
            common, corr = self.corrections(rows, cols, s)
            image += (common * (acc * corr.to(cdtype)).real).to(rdtype)
        return image

    def predict(self, s: int, uv, sub_uv, w_plane, ys, xs, flux,
                block: int = 1 << 15) -> torch.Tensor:
        """(n, P) complex128 degrid predictions, on W slice ``s``, of the
        point components at pixels ``(ys, xs)`` (m,) with ``flux`` (m, P)
        for visibilities ``(uv, sub_uv, w_plane)``."""
        N, K = self.pixels, self.kernel.shape[-1]
        cdtype = torch.complex128
        ys, xs = self._index(ys), self._index(xs)
        flux = torch.as_tensor(flux, dtype=torch.float64).to(self.device)
        # Each component's image corrections undone: f cb / (t t n) e^{-i phi}.
        n = n_single(ys, xs, pixels=N,
                     pixel_size=self.pixel_size).to(self.device)
        t = torch.from_numpy(self.taper).to(self.device)
        cb = 1.0 - 2.0 * ((ys + xs) % 2).to(torch.float64)
        phi = (2 * math.pi * float(self.mid_w[s])) * (n - 1.0)
        amp = (cb / (t[ys] * t[xs] * n))[:, None] * flux      # (m, P)
        amp = amp.to(cdtype) * torch.polar(torch.ones_like(phi),
                                           -phi)[:, None]
        taps = torch.arange(K, dtype=torch.int64, device=self.device)
        ey = _phase(taps, ys, N, cdtype, -1)                  # (K, m)
        ex = _phase(taps, xs, N, cdtype, -1)
        out = []
        for b0 in range(0, len(uv), block):
            b1 = min(len(uv), b0 + block)
            ku, kv, u0, v0 = self._taps(uv[b0:b1], sub_uv[b0:b1],
                                        w_plane[b0:b1])
            a = (kv.to(cdtype) @ ey) * _phase(v0, ys, N, cdtype, -1)
            b = (ku.to(cdtype) @ ex) * _phase(u0, xs, N, cdtype, -1)
            out.append((a * b) @ amp)
        return torch.cat(out)
