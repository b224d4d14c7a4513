"""Combine per-channel FITS images into an MP4 video.

Parity with the reference's ``fits-video.py`` helper: intended for FITS
files produced by this imager (assumes the axis ordering and units this
package writes).  Requires matplotlib with ffmpeg available.

The port's own copy of :mod:`katsdpimager_tpu.fits_video` (host code, no
kernel); the port imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import glob
import sys

import numpy as np

from . import io


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="fits-video",
        description="Render per-channel FITS images into a video")
    parser.add_argument("pattern",
                        help="Glob for input FITS files (e.g. 'out/*_clean.fits')")
    parser.add_argument("output", help="Output video file (.mp4)")
    parser.add_argument("--fps", type=float, default=5.0)
    parser.add_argument("--vmin", type=float)
    parser.add_argument("--vmax", type=float)
    parser.add_argument("--dpi", type=int, default=96)
    args = parser.parse_args(argv)

    files = sorted(glob.glob(args.pattern))
    if not files:
        parser.error(f"no files match {args.pattern!r}")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    # Determine a common stretch from the first file unless given.
    header0, data0 = io.read_fits(files[0])
    img0 = np.asarray(data0[0, 0], np.float64)
    finite = img0[np.isfinite(img0)]
    vmin = args.vmin if args.vmin is not None else np.percentile(finite, 1)
    vmax = args.vmax if args.vmax is not None else np.percentile(finite, 99.9)

    fig, ax = plt.subplots(figsize=(6, 6))
    im = ax.imshow(img0, origin="lower", vmin=vmin, vmax=vmax,
                   cmap="viridis")
    title = ax.set_title(files[0])
    ax.set_axis_off()
    fig.tight_layout()

    def update(i):
        _h, data = io.read_fits(files[i])
        im.set_data(np.asarray(data[0, 0], np.float64))
        title.set_text(files[i])
        return [im, title]

    anim = animation.FuncAnimation(fig, update, frames=len(files))
    writers = animation.writers.list()
    if args.output.endswith(".gif") or "ffmpeg" not in writers:
        if not args.output.endswith(".gif"):
            parser.error("ffmpeg is not available; use a .gif output "
                         f"(available writers: {writers})")
        anim.save(args.output, fps=args.fps, dpi=args.dpi, writer="pillow")
    else:
        anim.save(args.output, fps=args.fps, dpi=args.dpi)
    plt.close(fig)
    print(f"wrote {args.output} ({len(files)} frames)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
