"""Batch pipeline writer: channel-granularity resume, thumbnails, metadata
and a statistics store.

Counterpart of :mod:`katsdpimager_tpu.pipeline` (``imager-tpu-pipeline``):
a JSON state store in the output directory records each channel's status
and statistics, so a rerun skips what is done; PNG thumbnails are
rendered with matplotlib, and ``metadata.json`` is written per run.
Output files land in the output directory atomically (written to a
temporary name, then renamed).

Run it as ``python -m katsdpimager_tpu_torch.pipeline INPUT OUTPUT_DIR
[--cube] ...``.  The imaging runs on the CUDA device, where every kernel
of the path runs: :func:`main` and :func:`run` take ``device=None``,
which means the CUDA device and raises without one; inside
:func:`.device.plain_versions` every kernel's plain version runs (the
parity reference).  Tests pass ``device="cpu"``.  :func:`run` takes a loaded dataset, so an in-memory
dataset needs no file format.

``--cube`` runs on several processes (ranks), one card each, on one host
or several (:mod:`.parallel.mesh`): launched by ``torchrun`` (``python
-m torch.distributed.run --nproc-per-node N -m
katsdpimager_tpu_torch.pipeline ...``; :func:`main` joins the group when
``WORLD_SIZE`` is set) or with ``--coordinator HOST:PORT
--num-processes N --process-id I`` per process.  ``N`` counts the ranks
over every host, one per card, and ``I`` is the rank among them (a JAX
``--num-processes`` counts hosts, one process each).  Without
``torchrun`` the ranks find their hosts' layout through the rendezvous
(:func:`.parallel.mesh.host_layout`): each drives the card of its index
among its host's ranks.  A wave then holds one channel per chan group of
``--vis-shards`` ranks, and rank 0 writes.  The backend is ``nccl`` where
every rank has a card of its own, else ``gloo`` (the CPU, or ranks
sharing a card).  The per-channel route stays on one process.

The JAX module enables XLA's persistent compilation cache
(``xfer.enable_compilation_cache``); the port compiles nothing per
shape, so it has no counterpart.  Thumbnails need matplotlib: where it is
missing, or a thumbnail fails to render, that is logged and the run goes
on.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile

import numpy as np

from . import frontend, io, metadata

logger = logging.getLogger(__name__)


class StateStore:
    """Per-run persistent key/value store (a JSON file)."""

    def __init__(self, path: str):
        self._path = path
        self._data = {}
        if os.path.exists(path):
            with open(path) as f:
                self._data = json.load(f)

    def get(self, key: str, default=None):
        return self._data.get(key, default)

    def set(self, key: str, value) -> None:
        self._data[key] = value
        self._flush()

    def _flush(self) -> None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self._path) or ".",
                                   suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(self._data, f, indent=2, default=_json_default)
        os.replace(tmp, self._path)


def _json_default(obj):
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)


def _thumbnail(image: np.ndarray, filename: str) -> None:
    """Render a PNG thumbnail of the Stokes-I plane."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = image[0]
    finite = data[np.isfinite(data)]
    if finite.size == 0:
        return
    vmax = np.percentile(finite, 99.9)
    vmin = np.percentile(finite, 1)
    fig, ax = plt.subplots(figsize=(4, 4), dpi=64)
    ax.imshow(data, origin="lower", vmin=vmin, vmax=vmax, cmap="viridis")
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.savefig(filename)
    plt.close(fig)


class PipelineWriter(frontend.Writer):
    """Writer with channel resume, thumbnails and a statistics store."""

    def __init__(self, output_dir: str, prefix: str = "image",
                 thumbnails: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.output_dir = output_dir
        self.prefix = prefix
        self.thumbnails = thumbnails
        self.store = StateStore(os.path.join(output_dir, "state.json"))

    # -- resume ---------------------------------------------------------
    def channel_already_done(self, dataset, channel) -> bool:
        return self.store.get(f"status/{channel}") in ("complete", "no-data")

    def skip_channel(self, dataset, image_parameters, channel):
        self.store.set(f"status/{channel}", "no-data")

    # -- products -------------------------------------------------------
    def needs_fits_image(self, name):
        return name == "clean"

    def needs_fits_grid(self, name):
        return False

    def _path(self, name: str, channel) -> str:
        return os.path.join(self.output_dir,
                            f"{self.prefix}_{channel:05d}_{name}.fits")

    def write_fits_image(self, name, description, dataset, image,
                         image_parameters, channel, beam=None,
                         bunit="Jy/beam"):
        path = self._path(name, channel)
        tmp = path + ".writing"
        io.write_fits_image(np.asarray(image), image_parameters, tmp,
                            dataset.phase_centre(), beam, bunit,
                            dataset.extra_fits_headers())
        os.replace(tmp, path)
        logger.info("Wrote %s to %s", description, path)
        if name == "clean" and self.thumbnails:
            try:
                _thumbnail(np.asarray(image), path[:-5] + ".png")
            except Exception:
                logger.warning("Thumbnail rendering failed", exc_info=True)

    def write_fits_grid(self, *args, **kwargs):
        pass

    # -- statistics -----------------------------------------------------
    def statistics(self, dataset, channel, **kwargs):
        stats = {}
        for key, value in kwargs.items():
            if key in ("image_parameters", "grid_parameters",
                       "clean_parameters"):
                stats[key] = str(value)
            elif key == "restoring_beam":
                stats[key] = {"major": value.major, "minor": value.minor,
                              "theta": value.theta}
            else:
                stats[key] = value
        stats["frequency"] = dataset.frequency(channel)
        self.store.set(f"stats/{channel}", stats)
        self.store.set(f"status/{channel}", "complete")

    def finalize(self, dataset, channels) -> None:
        try:
            obs = dataset.observation()
            if obs:
                band = dataset.band()
                if band:
                    obs = dict(obs, band=band)
                self.store.set("observation", {
                    k: (np.asarray(v).tolist()
                        if isinstance(v, (np.ndarray, tuple, list)) else v)
                    for k, v in obs.items()})
        except Exception:
            logger.warning("Could not record observation summary",
                           exc_info=True)
        try:
            image_p = None
            md = metadata.make_metadata(dataset, image_p, list(channels))
            metadata.write_metadata(
                os.path.join(self.output_dir, "metadata.json"), md)
        except Exception:
            logger.warning("Failed to write metadata.json", exc_info=True)


def get_parser():
    """The ``imager-tpu-pipeline`` command line (the JAX module's)."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="imager-tpu-pipeline",
        description="Batch spectral-line imaging pipeline with resume")
    parser.add_argument("input_file")
    parser.add_argument("output_dir")
    parser.add_argument("--prefix", default="image")
    parser.add_argument("--no-thumbnails", dest="thumbnails",
                        action="store_false", default=True)
    parser.add_argument("--cube", action="store_true",
                        help="Image channels in device waves "
                             "(the fast path for large cubes)")
    parser.add_argument("--vis-shards", type=int, default=1,
                        help="Processes (one card each) cooperating per "
                             "channel in --cube mode; it must divide their "
                             "number [%(default)s]")
    group = parser.add_argument_group("Several processes (--cube)")
    group.add_argument("--coordinator", default=None,
                       help="HOST:PORT of process 0 (without it, torchrun's "
                            "environment, where WORLD_SIZE is set)")
    group.add_argument("--num-processes", type=int, default=None,
                       help="Ranks over every host, one per card")
    group.add_argument("--process-id", type=int, default=None,
                       help="This rank, 0 to --num-processes - 1")
    parser.add_argument("--cube-psf-patch", type=int, default=0,
                        help="CLEAN PSF patch size in --cube mode; 0 "
                             "auto-sizes per wave from the measured PSF "
                             "[%(default)s]")
    parser.add_argument("--log-level", default="INFO")
    frontend.add_options(parser)
    return parser


def run(args, dataset, writer, *, device=None):
    """Image ``dataset`` into ``writer`` (a :class:`PipelineWriter`) on
    ``device`` (None: the CUDA device, which must exist): with
    ``args.cube`` in waves (:func:`.cube_frontend.run_cube`, whose
    per-wave timings are returned), else channel by channel
    (:func:`.frontend.run`, whose per-channel statistics are returned);
    then the observation summary and ``metadata.json``.  Under a process
    group (``--cube`` only) ``device`` None is this rank's card, and only
    rank 0 writes."""
    from .parallel import mesh as mesh_mod

    device = mesh_mod.default_device(device)
    if mesh_mod.world_size() > 1 and not args.cube:
        raise NotImplementedError(
            "the per-channel route runs on one process, as in the JAX "
            "package; several processes image with --cube")
    if args.cube:
        from . import cube_frontend

        result = cube_frontend.run_cube(args, dataset, writer, device=device)
    else:
        result = frontend.run(args, dataset, writer, device=device)
    stop = (args.stop_channel if args.stop_channel is not None
            else dataset.num_channels())
    if mesh_mod.rank() == 0:
        writer.finalize(dataset, range(args.start_channel, stop))
    return result


def main(argv=None, *, device=None) -> int:
    """Batch pipeline CLI: parse ``argv``, load the dataset and
    :func:`run` it on ``device`` (None: the CUDA device, which must
    exist)."""
    from . import arguments, loader
    from .imager import setup_logging

    from .parallel import mesh as mesh_mod

    parser = get_parser()
    args = parser.parse_args(argv, namespace=arguments.SmartNamespace())
    setup_logging(args.log_level)
    if args.coordinator is not None or "WORLD_SIZE" in os.environ:
        mesh_mod.initialize_distributed(
            args.coordinator, args.num_processes, args.process_id)
    device = mesh_mod.default_device(device)

    if args.cube_psf_patch and (args.cube_psf_patch % 2 == 0
                                or args.cube_psf_patch < 9):
        parser.error("--cube-psf-patch must be 0 (auto) or an odd size "
                     ">= 9 (CLEAN patches are centred on the PSF peak)")
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
        writer = PipelineWriter(args.output_dir, args.prefix, args.thumbnails)
        run(args, dataset, writer, device=device)
    finally:
        dataset.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
