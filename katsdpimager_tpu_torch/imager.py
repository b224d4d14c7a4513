"""Command-line imager: input dataset -> per-channel FITS images.

Counterpart of :mod:`katsdpimager_tpu.imager`, with the same flag surface
and debug product dumps (``--write-weights``, ``--write-psf``, ...)::

    python -m katsdpimager_tpu_torch.imager input.h5 "clean_%c.fits" \\
        --pixels 4096 --kernel-width 60 --major 2

(``%c`` in an output name is the channel number.)  It images on the CUDA
card, where every kernel of the path runs, and raises if there is none;
``--host`` images on the CPU with the kernels' plain versions.  Without
``h5py`` (``--tmp-file``, the default, spills to HDF5) pass
``--no-tmp-file``.  ``--write-profile`` writes the host stages' times and
``--write-device-profile`` each device kernel's time (``torch.profiler``),
both in flamegraph.pl format.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from . import arguments, io, loader

from . import device as device_mod
from . import frontend, profiling

logger = logging.getLogger(__name__)

DEBUG_PRODUCTS = ["weights", "psf", "grid", "dirty", "model", "residuals",
                  "primary_beam"]


def format_channel_filename(template: str, channel: int) -> str:
    """Substitute the channel number: printf-style (``out%05d.fits``) or
    the ``%c`` placeholder."""
    if "%c" in template:
        return template.replace("%c", str(channel))
    try:
        return template % channel
    except TypeError:
        return template


class FileWriter(frontend.Writer):
    """Writes FITS products to files derived from the output template."""

    def __init__(self, args):
        self.args = args

    def _filename(self, name, channel):
        if name == "clean":
            template = self.args.output_file
        else:
            template = getattr(self.args, "write_" + name, None)
            if template is None:
                return None
        return format_channel_filename(template, channel)

    def needs_fits_image(self, name):
        return self._filename(name, 0) is not None

    def needs_fits_grid(self, name):
        return self._filename(name, 0) is not None

    def write_fits_image(self, name, description, dataset, image,
                         image_parameters, channel, beam=None,
                         bunit="Jy/beam"):
        filename = self._filename(name, channel)
        if filename is None:
            return
        history = ["Command line: " + " ".join(sys.argv)]
        io.write_fits_image(np.asarray(image), image_parameters, filename,
                            dataset.phase_centre(), beam, bunit,
                            dataset.extra_fits_headers(), history)
        logger.info("Wrote %s to %s", description, filename)

    def write_fits_grid(self, name, description, fftshift, grid_data,
                        image_parameters, channel):
        filename = self._filename(name, channel)
        if filename is None:
            return
        io.write_fits_grid(np.asarray(grid_data), image_parameters, filename)
        logger.info("Wrote %s to %s", description, filename)

    def statistics(self, dataset, channel, **kwargs):
        logger.info("Channel %d: noise=%g peak=%g totals=%s major=%d minor=%d",
                    channel, kwargs.get("noise"), kwargs.get("peak"),
                    kwargs.get("totals"), kwargs.get("major"),
                    kwargs.get("minor"))


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="imager-cuda",
        description="Spectral-line imager on a CUDA card (PyTorch port)")
    parser.add_argument("input_file", help="Input dataset (.h5 / .ms)")
    parser.add_argument("output_file",
                        help="Output FITS file (%%c = channel number)")
    frontend.add_options(parser)
    group = parser.add_argument_group("Debug output options")
    for name in DEBUG_PRODUCTS:
        group.add_argument(f"--write-{name.replace('_', '-')}",
                           metavar="FILE",
                           help=f"Write {name} to FITS file")
    group.add_argument("--write-profile", metavar="FILE",
                       help="Write a flamegraph-format profile of the host "
                            "stages")
    group.add_argument("--write-device-profile", metavar="FILE",
                       help="Trace the run with torch.profiler and write "
                            "per-kernel device times (flamegraph format); "
                            "the raw trace is kept in FILE.trace/")
    parser.add_argument("--host", action="store_true",
                        help="Image on the CPU with the kernels' plain "
                             "PyTorch versions instead of on the CUDA card")
    parser.add_argument("--log-level", default="INFO",
                        help="Logging level [%(default)s]")
    return parser


def setup_logging(level: str):
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(levelname)s:%(name)s: %(message)s")


def run(args, dataset, writer, *, device=None) -> list:
    """``frontend.run`` with the profile dumps that ``args`` asks for:
    ``--write-profile`` (the host stages, flamegraph format) and
    ``--write-device-profile`` (a ``torch.profiler`` trace kept in
    ``FILE.trace/``, summed per device kernel into FILE)."""
    Profiler = profiling.Profiler
    old = Profiler.get_profiler()
    if args.write_profile:
        Profiler.set_profiler(profiling.FlamegraphProfiler())
    try:
        if not args.write_device_profile:
            return frontend.run(args, dataset, writer, device=device)
        trace_dir = args.write_device_profile + ".trace"
        with profiling.device_trace(trace_dir):
            results = frontend.run(args, dataset, writer, device=device)
        totals = profiling.parse_device_profile(trace_dir)
        with open(args.write_device_profile, "w") as f:
            profiling.write_device_profile(totals, f)
        logger.info("Wrote device profile (%d ops) to %s; raw trace in %s",
                    len(totals), args.write_device_profile, trace_dir)
        return results
    finally:
        if args.write_profile:
            with open(args.write_profile, "w") as f:
                Profiler.get_profiler().write_flamegraph(f)
            Profiler.set_profiler(old)


def main(argv=None) -> int:
    parser = get_parser()
    args = parser.parse_args(argv, namespace=arguments.SmartNamespace())
    setup_logging(args.log_level)
    device = device_mod.select(args.host)
    if args.subtract and args.subtract != "auto":
        from . import sky_model

        try:
            sky_model.open_sky_model(args.subtract)
        except (OSError, ValueError) as exc:
            parser.error(f"cannot open sky model {args.subtract}: {exc}")
    try:
        dataset = loader.load(args.input_file, args.input_option,
                              args.start_channel, args.stop_channel)
    except (FileNotFoundError, OSError) as exc:
        parser.error(f"cannot open {args.input_file}: {exc}")
    try:
        run(args, dataset, FileWriter(args), device=device)
    except ValueError as exc:
        parser.error(str(exc))
    finally:
        dataset.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
