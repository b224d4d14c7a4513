"""The plain reference of one CLEAN stage (Hogbom minor cycles).

A stage, as the configuration states it: the noise is the median of the
interior's absolute values times 1.4826; the first cycle always
subtracts and measures the starting peak; the threshold is then
``max(noise * sigma, (1 - major_gain) * first_peak)``, and each later
cycle, up to ``minor - 1`` of them, takes the interior's largest
``|Stokes I|``, subtracts ``loop_gain`` times the residual there times
the PSF patch centred on it (the patch may overhang the image) and adds
the same to the model, until the peak falls below the threshold.

CLEAN is a sequence of data-dependent choices, so the reference cannot
run it from the raw inputs and meet the program's components: it
replays a stage from the program's own state, the residual image and
model the stage was given and the PSF patch (the PSF itself is checked
against the reference's by itself).  float64, or with ``tf32`` the
control: float32 with each subtraction's product formed from TF32-rounded
operands.
"""

from __future__ import annotations

import torch

from .imaging import round_tf32

#: Median of |N(0, 1)| to its sigma.
MEDIAN_TO_RMS = 1.4826022185056031


def noise_est(image: torch.Tensor, border: int) -> torch.Tensor:
    """The scaled median of the interior's absolute values (the mean of
    the two middle values where their count is even)."""
    N = image.shape[-1]
    a = image[:, border:N - border, border:N - border].abs().reshape(-1)
    s = torch.sort(a).values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2]) * MEDIAN_TO_RMS


def stage(residual: torch.Tensor, model: torch.Tensor, patch: torch.Tensor,
          *, border: int, loop_gain: float, major_gain: float,
          sigma: float, minor: int, tf32: bool = False):
    """Replay one stage on (P, N, N) ``residual`` and ``model`` with the
    (P, ph, pw) ``patch``; Stokes I picks the peaks.  Returns (residual,
    model, cycles), new tensors, in float64 (float32 with ``tf32``)."""
    dtype = torch.float32 if tf32 else torch.float64
    rnd = round_tf32 if tf32 else (lambda t: t)
    P, N, _ = residual.shape
    ph, pw = patch.shape[-2:]
    pad = max(ph, pw) // 2 + 1
    res = torch.zeros((P, N + 2 * pad, N + 2 * pad), dtype=dtype,
                      device=residual.device)
    res[:, pad:pad + N, pad:pad + N] = residual.to(dtype)
    model = model.to(dtype).clone()
    patch = rnd(patch.to(dtype))
    noise = float(noise_est(residual.to(dtype), border))
    lo, hi = pad + border, pad + N - border
    width = hi - lo
    threshold = 0.0
    cycles = 0
    while cycles < minor:
        metric = res[0, lo:hi, lo:hi].abs()
        flat = int(torch.argmax(metric))
        peak = float(metric.reshape(-1)[flat])
        if cycles > 0 and peak < threshold:
            break
        y, x = lo + flat // width, lo + flat % width
        scale = loop_gain * res[:, y, x]
        res[:, y - ph // 2:y - ph // 2 + ph, x - pw // 2:x - pw // 2 + pw] -= (
            rnd(scale)[:, None, None] * patch)
        model[:, y - pad, x - pad] += scale
        if cycles == 0:
            threshold = max(noise * sigma, (1.0 - major_gain) * peak)
        cycles += 1
    return res[:, pad:pad + N, pad:pad + N], model, cycles
