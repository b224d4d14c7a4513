"""A small configuration and mix of the dirty step for the CPU tests: the
shapes of the port's own small tests (256 px, K 16), 2 channels."""

import torch

from portbench import manifest

torch.set_num_threads(2)

SMALL_CONFIG = dict(
    pixels=256, num_pols=1, precision="single", kernel_width=16,
    oversample=8, antialias_width=7.0, image_oversample=4, w_planes=8,
    w_slices=2, max_w_m=1000.0, pixel_size=1.0 / (256 * 16), chunk_size=128,
    chunks_per_slice=64, tile_size=32, weight_type="natural")

SMALL_TRAFFIC = dict(
    config="small", runner="dirty_step", metric_prefix="dirty", channels=2,
    vis_per_slice=2048,
    base_frequency_hz=1.0e9, channel_step=0.01, sample_axis=32,
    trace_steps=2, limits={"dirty_err": 2e-5})

SEED = 2 ** 31 + 11


def small_cell(**traffic) -> manifest.Cell:
    """The small cell, reporting the metrics of ``mkat_l_4k.dirty``."""
    e2e, layer = manifest.metrics_of(manifest.load(), "mkat_l_4k.dirty")
    return manifest.Cell("small.dirty", 1, dict(SMALL_CONFIG),
                         dict(SMALL_TRAFFIC, **traffic), e2e, layer,
                         manifest.HERE)

#: The cube wave's mix at the small size: patches of 9 pixels (five
#: sources 18 pixels apart fit the central half of 256 px), 300 minor
#: cycles at most.
WAVE_TRAFFIC = dict(
    SMALL_TRAFFIC, runner="cube_wave", majors=2, minor=300, patch=9,
    psf_core=32, border=0, loop_gain=0.1, major_gain=0.85,
    threshold_sigma=5.0,
    limits={"psf_err": 1e-4, "dirty_err": 1e-4, "regrid_err": 1e-4,
            "clean_err": 1e-4})


#: The cube wave's metrics (``mkat_l_4k.clean`` is not in the manifest:
#: PERF.md, Open questions).
WAVE_METRICS = (
    [{"name": "setup_s", "unit": "s"},
     {"name": "wave_s_per_channel", "unit": "s/channel"}],
    [{"name": "clean.clean_share", "unit": "%"},
     {"name": "clean.minor_cycles_per_s", "unit": "cycles/s"},
     {"name": "clean.idle_share", "unit": "%"}])


def wave_cell(**traffic) -> manifest.Cell:
    """The small wave cell, with the cube wave's metrics."""
    return manifest.Cell("small.clean", 1, dict(SMALL_CONFIG),
                         dict(WAVE_TRAFFIC, **traffic), *WAVE_METRICS,
                         manifest.HERE)
