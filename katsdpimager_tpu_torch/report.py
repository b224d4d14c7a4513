"""HTML QA report from pipeline statistics.

Parity target: the reference's ``report.py`` / ``imager-mkat-report.py``
(bokeh/jinja2 report of per-channel status, noise, peak and total flux
spectra, with SEFD-predicted noise).  This implementation reads the
pipeline's JSON state store and renders a standalone HTML file with
matplotlib plots embedded as base64 PNGs — no template or server
dependencies.

The port's own copy of :mod:`katsdpimager_tpu.report` (host code, no
kernel); the port imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import html
import io as _io
import json
import math
import os
from typing import Dict, List, Optional

import numpy as np


def _fig_to_b64(fig) -> str:
    buf = _io.BytesIO()
    fig.savefig(buf, format="png", dpi=80, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return base64.b64encode(buf.getvalue()).decode("ascii")


class PolynomialSEFDModel:
    """System-equivalent flux density as a polynomial in frequency (the
    reference's SEFD model family, report.py:69-158)."""

    def __init__(self, coeffs, min_freq_hz: float, max_freq_hz: float):
        self.coeffs = np.asarray(coeffs, np.float64)
        self.min_freq = min_freq_hz
        self.max_freq = max_freq_hz

    def __call__(self, freq_hz) -> np.ndarray:
        f = np.asarray(freq_hz, np.float64) / 1e6  # polynomial in MHz
        out = np.polyval(self.coeffs[::-1], f)
        mask = (np.asarray(freq_hz) >= self.min_freq) & (
            np.asarray(freq_hz) <= self.max_freq)
        return np.where(mask, out, np.nan)


def meerkat_sefd_model(band: str) -> Optional[PolynomialSEFDModel]:
    """Approximate MeerKAT SEFD models (quadratic fits to the published
    L/UHF receiver curves; the reference embeds similar polynomials)."""
    if band == "L":
        return PolynomialSEFDModel([880.0, -0.33, 1.45e-4], 900e6, 1670e6)
    if band == "UHF":
        return PolynomialSEFDModel([1100.0, -1.1, 6.5e-4], 580e6, 1015e6)
    return None


def predicted_noise(sefd_jy: float, n_antennas: int, bandwidth_hz: float,
                    t_integration_s: float, efficiency: float = 0.9) -> float:
    """Radiometer-equation image noise (Jy/beam)."""
    n_baselines = n_antennas * (n_antennas - 1) / 2
    return sefd_jy / (efficiency * math.sqrt(
        2 * bandwidth_hz * t_integration_s * n_baselines))


def load_stats(state_path: str) -> Dict[int, dict]:
    with open(state_path) as f:
        data = json.load(f)
    stats = {}
    for key, value in data.items():
        if key.startswith("stats/"):
            stats[int(key.split("/", 1)[1])] = value
    return stats


def load_observation(state_path: str) -> Optional[dict]:
    with open(state_path) as f:
        data = json.load(f)
    return data.get("observation")


def load_status(state_path: str) -> Dict[int, str]:
    with open(state_path) as f:
        data = json.load(f)
    return {int(k.split("/", 1)[1]): v for k, v in data.items()
            if k.startswith("status/")}


def observation_plots(obs: dict, plt, mid_freq_hz: Optional[float]) -> list:
    """UV-coverage and elevation/parallactic-angle figures (parity with
    reference report.py:362-521, computed from the recorded observation
    summary via :mod:`.ephem` instead of katpoint/bokeh)."""
    from . import ephem, units

    plots = []
    uvw = obs.get("uvw_samples")
    if uvw is not None and len(uvw):
        uvw = np.asarray(uvw, np.float64)
        if mid_freq_hz:
            scale = 1e-3 / units.wavelength_m(mid_freq_hz)
            unit = r"k$\lambda$"
        else:
            scale = 1e-3
            unit = "km"
        fig, ax = plt.subplots(figsize=(4.5, 4.5))
        for sign in (1.0, -1.0):
            ax.plot(sign * uvw[:, 0] * scale, sign * uvw[:, 1] * scale,
                    ".", markersize=0.5, color="tab:blue", alpha=0.4)
        ax.set_xlabel(f"u [{unit}]")
        ax.set_ylabel(f"v [{unit}]")
        ax.set_aspect("equal")
        ax.set_title("UV coverage")
        plots.append(_fig_to_b64(fig))

    pos = obs.get("antenna_positions")
    pc = obs.get("phase_centre")
    trange = obs.get("time_range")
    if pos is not None and pc is not None and trange and trange[1] > trange[0]:
        pos = np.asarray(pos, np.float64)
        ra, dec = float(pc[0]), float(pc[1])
        lat, lon, _ = ephem.ecef_to_geodetic(pos.mean(axis=0))
        times = np.linspace(trange[0], trange[1], 200)
        hours = (times - trange[0]) / 3600.0
        elev = np.degrees(ephem.elevation(lat, lon, ra, dec, times,
                                          apparent=True))
        pa = np.degrees(ephem.parallactic_angle(lat, lon, ra, dec, times,
                                                apparent=True))
        fig, axes = plt.subplots(1, 2, figsize=(9, 3))
        axes[0].plot(hours, elev)
        axes[0].set_xlabel("Time [h since start]")
        axes[0].set_ylabel("Elevation [deg]")
        axes[0].set_title("Target elevation")
        axes[1].plot(hours, pa)
        axes[1].set_xlabel("Time [h since start]")
        axes[1].set_ylabel("Parallactic angle [deg]")
        axes[1].set_title("Parallactic angle")
        fig.tight_layout()
        plots.append(_fig_to_b64(fig))
    return plots


def write_report(state_path: str, output_path: str,
                 title: str = "Imaging QA report",
                 images_dir: Optional[str] = None) -> None:
    """Render the report from a pipeline ``state.json``; when
    ``images_dir`` is given, channel thumbnails (``*_clean.png``) are
    embedded as a gallery (the reference's images-report analogue)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    stats = load_stats(state_path)
    channels = sorted(stats)
    freqs = np.array([stats[c].get("frequency", np.nan) for c in channels]) / 1e6
    noise = np.array([stats[c].get("noise", np.nan) for c in channels])
    weights_noise = np.array([
        stats[c].get("weights_noise") or np.nan for c in channels])
    peak = np.array([stats[c].get("peak", np.nan) for c in channels])
    minor = np.array([stats[c].get("minor", 0) for c in channels])
    totals_i = np.array([
        (stats[c].get("totals") or {}).get("I", np.nan) for c in channels])

    plots: List[str] = []
    obs = load_observation(state_path)
    if channels:
        fig, ax = plt.subplots(figsize=(7, 3))
        ax.plot(freqs, noise * 1e6, label="measured")
        if np.isfinite(weights_noise).any():
            ax.plot(freqs, weights_noise * 1e6, label="from weights")
        # SEFD-predicted thermal noise (radiometer equation), when the
        # observation summary carries the band and geometry (reference
        # report.py SNR plot shows the same predicted-vs-measured pair)
        if (obs and obs.get("band") and obs.get("time_range")
                and obs.get("antenna_positions") is not None
                and len(channels) >= 2):
            model = meerkat_sefd_model(obs["band"])
            if model is not None:
                t0, t1 = obs["time_range"]
                n_ant = len(obs["antenna_positions"])
                bw = float(np.median(np.abs(np.diff(freqs)))) * 1e6
                if t1 > t0 and bw > 0:
                    pred = [predicted_noise(float(model(f * 1e6)), n_ant,
                                            bw, t1 - t0)
                            for f in freqs]
                    ax.plot(freqs, np.asarray(pred) * 1e6, "--",
                            label="predicted (SEFD)")
        ax.set_xlabel("Frequency [MHz]")
        ax.set_ylabel("Noise [uJy/beam]")
        ax.legend()
        ax.set_title("Residual noise")
        plots.append(_fig_to_b64(fig))

        fig, ax = plt.subplots(figsize=(7, 3))
        ax.plot(freqs, peak, label="peak")
        ax.plot(freqs, totals_i, label="total I")
        ax.set_xlabel("Frequency [MHz]")
        ax.set_ylabel("Flux density [Jy]")
        ax.legend()
        ax.set_title("Peak and total flux")
        plots.append(_fig_to_b64(fig))

        fig, ax = plt.subplots(figsize=(7, 3))
        ax.plot(freqs, minor)
        ax.set_xlabel("Frequency [MHz]")
        ax.set_ylabel("Minor cycles")
        ax.set_title("CLEAN effort")
        plots.append(_fig_to_b64(fig))

    # per-channel status strip (complete / no-data / missing; reference
    # report.py:282-296 plots the same per-channel status)
    status = load_status(state_path)
    if status:
        chans = sorted(status)
        codes = {"complete": 1.0, "no-data": 0.5}
        vals = [codes.get(status[c], 0.0) for c in chans]
        fig, ax = plt.subplots(figsize=(7, 1.4))
        ax.bar(chans, [1] * len(chans), width=1.0,
               color=["tab:green" if v == 1.0 else
                      "tab:orange" if v == 0.5 else "tab:red"
                      for v in vals])
        ax.set_yticks([])
        ax.set_xlabel("Channel")
        ax.set_title("Status (green=complete, orange=no data)")
        plots.append(_fig_to_b64(fig))

    if obs:
        mid_freq = (float(np.nanmean(freqs)) * 1e6
                    if channels and np.isfinite(freqs).any() else None)
        plots.extend(observation_plots(obs, plt, mid_freq))

    gallery = ""
    if images_dir and os.path.isdir(images_dir):
        import glob

        tiles = []
        for png in sorted(glob.glob(os.path.join(images_dir,
                                                 "*_clean.png"))):
            with open(png, "rb") as f:
                b64 = base64.b64encode(f.read()).decode("ascii")
            name = html.escape(os.path.basename(png))
            tiles.append(
                f'<figure style="display:inline-block;margin:4px">'
                f'<img src="data:image/png;base64,{b64}" width="192">'
                f'<figcaption style="font-size:small">{name}</figcaption>'
                f"</figure>")
        if tiles:
            gallery = "<h2>Channel images</h2>" + "".join(tiles)

    rows = []
    for c in channels:
        s = stats[c]
        rows.append(
            "<tr>"
            f"<td>{c}</td>"
            f"<td>{s.get('frequency', 0) / 1e6:.2f}</td>"
            f"<td>{s.get('noise', float('nan')):.3e}</td>"
            f"<td>{s.get('peak', float('nan')):.4f}</td>"
            f"<td>{s.get('major', 0)}</td>"
            f"<td>{s.get('minor', 0)}</td>"
            f"<td>{s.get('compressed_vis', 0)}</td>"
            "</tr>")

    doc = f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{html.escape(title)}</title>
<style>
body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #999; padding: 0.3em 0.7em; }}
</style></head><body>
<h1>{html.escape(title)}</h1>
<p>{len(channels)} channels imaged.</p>
{''.join(f'<p><img src="data:image/png;base64,{p}"></p>' for p in plots)}
{gallery}
<h2>Per-channel statistics</h2>
<table>
<tr><th>Channel</th><th>Freq [MHz]</th><th>Noise [Jy/beam]</th>
<th>Peak [Jy/beam]</th><th>Major</th><th>Minor</th><th>Vis</th></tr>
{''.join(rows)}
</table>
</body></html>
"""
    with open(output_path, "w") as f:
        f.write(doc)


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="imager-tpu-report", description="Render the imaging QA report")
    parser.add_argument("state_json", help="Pipeline state.json")
    parser.add_argument("output_html")
    parser.add_argument("--title", default="Imaging QA report")
    parser.add_argument("--images-dir",
                        help="Directory of *_clean.png thumbnails to embed")
    args = parser.parse_args(argv)
    images_dir = args.images_dir
    if images_dir is None:
        images_dir = os.path.dirname(os.path.abspath(args.state_json))
    write_report(args.state_json, args.output_html, args.title, images_dir)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
