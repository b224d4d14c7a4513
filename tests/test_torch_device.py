"""The port's entry points run on the CUDA device unless the caller asks
for the CPU: with no CUDA device each raises by default and runs with
``device="cpu"``."""

import numpy as np
import pytest
import torch

from katsdpimager_tpu_torch import device, frontend, imaging, parameters
from katsdpimager_tpu_torch import preprocess
from katsdpimager_tpu_torch.ops import clean, weights
from katsdpimager_tpu_torch.parallel import multichannel

SMALL = dict(pixels=256, num_pols=1, kernel_width=16, oversample=8,
             w_planes=4, w_slices=2, chunks_per_slice=64, chunk_size=64,
             rv=32, ru=32, minor_cycles=0, weight_type="natural")


def _params():
    fixed = parameters.FixedImageParameters((1,), "single")     # Stokes I
    ap = parameters.ArrayParameters(13.5, 400.0)
    ip = parameters.make_image_parameters(fixed, 1.0, 5, 1.0e9, ap, None,
                                          256)
    gp = parameters.GridParameters(
        parameters.FixedGridParameters(7.0, 8, 4, 400.0, 16), 2, 16)
    clean_p = parameters.CleanParameters(100, 0.1, 0.85, 5.0, clean.CLEAN_I,
                                         0.01, 0.5, 0.02)
    return ip, gp, clean_p


class _DoneWriter:
    def channel_already_done(self, dataset, channel):
        return True


def _process_channel(dev):
    ip, gp, clean_p = _params()

    class ChannelP:
        channel = 0
        image_p = ip
        grid_p = gp

    return frontend.process_channel(
        None, None, 0, None, _DoneWriter(), ChannelP, None,
        parameters.WeightParameters(weights.WeightType.NATURAL), clean_p,
        None, **dev)


def _imaging(dev):
    ip, gp, clean_p = _params()
    return imaging.Imaging(ip, gp, parameters.WeightParameters(
        weights.WeightType.NATURAL), clean_p, **dev)


def _hdf5_collector(dev, tmp_path):
    pytest.importorskip("h5py")
    ip, gp, _ = _params()
    return preprocess.VisibilityCollectorHDF5(str(tmp_path / "spill.h5"),
                                              [ip], [gp], **dev)


ENTRY_POINTS = {
    "Imaging": lambda dev, tmp: _imaging(dev),
    "process_channel": lambda dev, tmp: _process_channel(dev),
    "MxuGridder": lambda dev, tmp: imaging.MxuGridder(
        pixels=256, kernel_width=16, **dev),
    "make_example_batch": lambda dev, tmp: multichannel.make_example_batch(
        multichannel.MultiChannelConfig(**SMALL), 1, vis_per_slice=500,
        **dev),
    "VisibilityCollectorMem": lambda dev, tmp:
        preprocess.VisibilityCollectorMem([_params()[0]], [_params()[1]],
                                          **dev),
    "VisibilityCollectorHDF5": lambda dev, tmp: _hdf5_collector(dev, tmp),
    "Weights": lambda dev, tmp: weights.Weights(
        weights.WeightType.NATURAL, 1, 64, **dev),
}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_needs_cuda_unless_cpu(name, no_cuda, tmp_path):
    make = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make({}, tmp_path)
    make({"device": "cpu"}, tmp_path)


def test_resolve(no_cuda):
    assert device.resolve("cpu") == torch.device("cpu")
    assert device.select(True) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve(None)
    with pytest.raises(RuntimeError, match="--host"):
        device.select(False)


def test_cpu_objects_live_on_cpu():
    g = imaging.MxuGridder(pixels=256, kernel_width=16, device="cpu")
    w = weights.Weights(weights.WeightType.UNIFORM, 1, 64, device="cpu")
    assert g.device == torch.device("cpu")
    assert w.grid.device == torch.device("cpu")
    assert np.all(w.grid.numpy() == 0)


def test_plain_versions_switch():
    """:func:`device.runs_plain` is false for a non-CPU tensor outside
    :func:`device.plain_versions` and true inside it, nested blocks
    included; it is false again after a block, also one left by an
    exception.  A CPU tensor always runs plain."""
    meta = torch.empty(1, device="meta")
    assert device.runs_plain(torch.zeros(1))
    assert not device.runs_plain(meta)
    with device.plain_versions():
        assert device.runs_plain(meta)
        with device.plain_versions():
            assert device.runs_plain(meta)
        assert device.runs_plain(meta)
    assert not device.runs_plain(meta)
    with pytest.raises(ValueError):
        with device.plain_versions():
            assert device.runs_plain(meta)
            raise ValueError
    assert not device.runs_plain(meta)
    assert device.runs_plain(torch.zeros(1))


@pytest.mark.parametrize("all_plain", [False, True])
def test_two_argument_step_form(all_plain, monkeypatch):
    """``single_channel_step(cfg, flag)`` runs each call of its step
    inside :func:`device.plain_versions` exactly when ``flag`` is true;
    ``single_channel_step(cfg)`` never does."""
    meta = torch.empty(1, device="meta")
    seen = []
    monkeypatch.setattr(multichannel, "_channel_pipeline",
                        lambda *args: seen.append(device.runs_plain(meta)))
    cfg = multichannel.MultiChannelConfig(**SMALL)
    multichannel.single_channel_step(cfg, all_plain)(*[None] * 11)
    multichannel.single_channel_step(cfg)(*[None] * 11)
    assert seen == [all_plain, False]
    assert not device.runs_plain(meta)
