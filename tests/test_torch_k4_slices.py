"""K4 over several W slices in one launch, and the slice loop's hand-off
to it, on the CPU: the plain K4 over a stack of slices against one slice
at a time; ``multichannel.image_slices`` launching K4 once a channel on
the K23 route (several polarization groups, empty slices skipped, the
stack split by the memory it finds) and once a slice elsewhere; the
wrapper's counters."""

import numpy as np
import pytest
import torch

from katsdpimager_tpu_torch import device
from katsdpimager_tpu_torch.ops import _build, fourier, fused_fft, mxu_gridder
from katsdpimager_tpu_torch.parallel import mesh, multichannel
from test_torch_k23 import SMALL, _batch, _bits, _count, _image, _ViaK2

N = 256


def _stack(S, P, seed):
    """S slices of random transposed (P, N, N) pairs, a random image, a
    taper and (S, 2) scalars: a w of its own a slice, one pixel size."""
    gen = torch.Generator().manual_seed(seed)
    xr, xi, start = (torch.randn(shape, generator=gen) for shape in (
        (S, P, N, N), (S, P, N, N), (P, N, N)))
    taper = 0.5 + torch.rand(N, generator=gen)
    scal = torch.tensor([[150.0 * s - 400.0, 1.0 / (N * 16)]
                         for s in range(S)])
    return xr, xi, start, taper, scal


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 6])
def test_plain_k4_over_slices_is_one_slice_at_a_time(S, P):
    """The plain K4 over a (S, P, N, N) stack, and the wrapper given it,
    is bitwise the plain one-slice K4 applied slice by slice in order."""
    xr, xi, start, taper, scal = _stack(S, P, 10 * S + P)
    want = start.clone()
    for s in range(S):
        fused_fft.epi_col_fft_plain(xr[s], xi[s], want, taper, scal[s])
    got = fused_fft.epi_col_fft_plain(xr, xi, start.clone(), taper, scal)
    assert torch.equal(_bits(got), _bits(want))
    got = fused_fft.epi_col_fft(xr, xi, start.clone(), taper, scal)
    assert torch.equal(_bits(got), _bits(want))


def _k4_calls(monkeypatch) -> list:
    """Wrap ``fused_fft.epi_col_fft`` so that each call appends the number
    of slices it was given."""
    calls = []
    original = fused_fft.epi_col_fft

    def counted(ar_t, *args):
        calls.append(1 if ar_t.dim() == 3 else ar_t.shape[0])
        return original(ar_t, *args)

    monkeypatch.setattr(fused_fft, "epi_col_fft", counted)
    return calls


def _nonempty(batch, take=None) -> int:
    return sum(int(n) > 0 for n in (batch.n_chunks[0] if take is None
                                    else take))


@pytest.mark.parametrize("weight_type", ["natural", "uniform"])
def test_slice_loop_launches_k4_once_a_channel(monkeypatch, weight_type):
    """On the K23 route the slice loop calls K4 once, with every non-empty
    slice; its image is bitwise that of K2, K3 and K4 once a slice."""
    cfg, batch = _batch(weight_type=weight_type)
    density = None
    if weight_type == "uniform":
        c = multichannel.channel_args(batch, 0)
        density = multichannel._density(cfg, c[4], c[7], c[8], c[9])
    calls = _k4_calls(monkeypatch)
    got = _image(cfg, batch, density)
    nonempty = _nonempty(batch)
    assert nonempty > 1
    assert calls == [nonempty]
    monkeypatch.setattr(fused_fft, "SliceStack", _ViaK2)
    want = _image(cfg, batch, density)
    assert calls == [nonempty] + [1] * nonempty
    assert torch.equal(_bits(got), _bits(want))


def test_slice_loop_k4_by_polarization_groups(monkeypatch):
    """With the accumulator cap forcing several polarization groups a
    slice, each group's K23 writes its planes of the slice's slot and K4
    still takes the channel in one call: the image is bitwise the
    one-group image and that of one slice a launch."""
    cfg, batch = _batch()
    joint = _image(cfg, batch)
    monkeypatch.setattr(mxu_gridder, "MAX_ACC_GB", 0.007)
    groups = len(mxu_gridder.pol_groups(cfg.num_pols, cfg.pixels, cfg.rv))
    assert groups > 1
    k23 = _count(monkeypatch, fused_fft, "combine_cb_col_fft")
    calls = _k4_calls(monkeypatch)
    split = _image(cfg, batch)
    nonempty = _nonempty(batch)
    assert len(k23) == groups * nonempty
    assert calls == [nonempty]
    monkeypatch.setattr(fused_fft, "SliceStack", _ViaK2)
    one_a_slice = _image(cfg, batch)
    assert torch.equal(_bits(split), _bits(joint))
    assert torch.equal(_bits(split), _bits(one_a_slice))


def _three_slices():
    cfg = multichannel.MultiChannelConfig(pixels=N, **dict(SMALL,
                                                           w_slices=3),
                                          weight_type="natural")
    return cfg, multichannel.make_example_batch(cfg, 1, seed=7,
                                                device="cpu")


def _image_take(cfg, batch, take):
    (kernel, taper, ps, mid_w, uv, sub, wp, anc, val, _, vis,
     nc) = multichannel.channel_args(batch, 0)
    return multichannel.image_slices(
        kernel, None, taper, ps, mid_w, uv, sub, wp, anc, val, vis, nc,
        pixels=cfg.pixels, ts=cfg.rv, take=take)


def test_slice_loop_skips_empty_slices(monkeypatch):
    """A slice whose count is 0 is neither gridded nor stacked: K4 takes
    the others in one call, and the image is bitwise that of one slice a
    launch over the same slices."""
    cfg, batch = _three_slices()
    take = [int(n) for n in batch.n_chunks[0]]
    assert min(take) > 0
    take[1] = 0
    k23 = _count(monkeypatch, fused_fft, "combine_cb_col_fft")
    calls = _k4_calls(monkeypatch)
    got = _image_take(cfg, batch, take)
    assert len(k23) == 2 and calls == [2]
    monkeypatch.setattr(fused_fft, "SliceStack", _ViaK2)
    want = _image_take(cfg, batch, take)
    assert torch.equal(_bits(got), _bits(want))
    assert not torch.equal(_bits(got), _bits(_image_take(
        cfg, batch, [int(n) for n in batch.n_chunks[0]])))


@pytest.mark.parametrize("depth,launches", [(1, [1, 1, 1]), (2, [2, 1]),
                                            (3, [3]), (7, [3])])
def test_stack_splits_by_the_memory_free(monkeypatch, depth, launches):
    """Where the free memory (read when the stack is made, beside the
    first group's colour planes) holds fewer slices' pairs than the
    channel has, K4 launches each time the stack is full, on consecutive
    slices, and once for the rest: the image is bitwise that of one
    launch."""
    cfg, batch = _three_slices()
    whole = _image(cfg, batch)
    ext2 = mxu_gridder.colour_tiles(N, cfg.rv) * 2 * cfg.rv
    planes = 2 * (2 * 2 * cfg.num_pols * ext2 * ext2) * 4
    pair = 2 * cfg.num_pols * N * N * 4
    read = []

    def free_memory(dev):
        read.append(torch.device(dev))
        return planes + depth * pair

    monkeypatch.setattr(device, "free_memory", free_memory)
    calls = _k4_calls(monkeypatch)
    got = _image(cfg, batch)
    assert read == [torch.device("cpu")]
    assert calls == launches
    assert torch.equal(_bits(got), _bits(whole))


def test_vis_split_launches_k4_once_a_slice(monkeypatch):
    """Under a vis split the grid is summed before the transform, so K3
    and K4 take one slice a call."""
    cfg, batch = _batch()
    monkeypatch.setattr(multichannel, "psum", lambda x, m: x)
    split = mesh.Mesh(rank=0, world=2, chan_index=0, chan_size=1,
                      vis_index=0, vis_size=2, vis_group=None,
                      device=torch.device("cpu"))
    calls = _k4_calls(monkeypatch)
    _image(cfg, batch, mesh=split)
    assert calls == [1] * _nonempty(batch)


@pytest.mark.parametrize("precision,pixels", [("double", 256),
                                              ("single", 264)])
def test_double_and_sizes_off_the_kernels_take_torch_fft(
        monkeypatch, precision, pixels):
    """At float64 and at sizes the column-DFT kernels do not take, the
    transform is ``torch.fft`` once a non-empty slice: K4 is never
    called."""
    cfg, batch = _batch(pixels=pixels)
    if precision == "double":
        batch = batch._replace(taper1d=batch.taper1d.double(),
                               pixel_size=batch.pixel_size.double(),
                               mid_w=batch.mid_w.double(),
                               vis=batch.vis.to(torch.complex128))
    calls = _k4_calls(monkeypatch)
    plain = _count(monkeypatch, fourier, "grid_to_image_plain")
    _image(cfg, batch)
    assert calls == []
    assert len(plain) == _nonempty(batch)


class _FakeLibrary:
    """Stands in for the kernels' library: records ``ktt_epi_col_fft``'s
    integer arguments and reports success."""

    def __init__(self):
        self.calls = []

    def ktt_epi_col_fft(self, *args):
        self.calls.append(args[6:9])
        return 0


def test_wrapper_counts_launches_and_slices(monkeypatch):
    """Outside the plain versions the wrapper launches once a call and
    counts one launch and the slices it was given: S for a (S, P, N, N)
    stack with (S, 2) scalars, 1 for a (P, N, N) pair with (2,) ones; it
    passes (S, P, N) to the library and checks the scalars' shape."""
    lib = _FakeLibrary()
    monkeypatch.setattr(fused_fft, "runs_plain", lambda t: False)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(fused_fft.epi_col_fft, "launches", 0)
    monkeypatch.setattr(fused_fft.epi_col_fft, "slices", 0)
    xr, xi, start, taper, scal = _stack(3, 2, 1)
    fused_fft.epi_col_fft(xr, xi, start, taper, scal)
    fused_fft.epi_col_fft(xr[1], xi[1], start, taper, scal[1])
    assert lib.calls == [(3, 2, N), (1, 2, N)]
    assert (fused_fft.epi_col_fft.launches,
            fused_fft.epi_col_fft.slices) == (2, 4)
    with pytest.raises(ValueError):
        fused_fft.epi_col_fft(xr, xi, start, taper, scal[0])
    assert fused_fft.epi_col_fft.launches == 2


def test_image_slices_takes_the_module_stack(monkeypatch):
    """The slice loop makes its stack through the module's name, sized to
    the channel's non-empty slices, and flushes it once, after the last
    slice, so that K4's one launch is the channel's, outside every
    slice's span."""
    cfg, batch = _three_slices()
    made = []

    class Recorded(fused_fft.SliceStack):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
            self.flushes = 0

        def flush(self):
            self.flushes += 1
            return super().flush()

    monkeypatch.setattr(fused_fft, "SliceStack", Recorded)
    image = _image(cfg, batch)
    assert len(made) == 1
    assert made[0].slices == _nonempty(batch) == 3
    assert made[0].flushes == 1        # after the last slice
    assert np.isfinite(image.numpy()).all()


def test_free_memory_reads_the_card_once(monkeypatch):
    """On a CUDA device the free memory is read from the card once a
    process (``cudaMemGetInfo`` waits for the device), then followed by
    the caching allocator's counters: what it had reserved at the reading
    and holds allocated now."""
    state = {"reserved": 3, "allocated": 2}
    reads = []

    def mem_get_info(index):
        reads.append(index)
        return 100, 1000

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda index: state["reserved"])
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda index: state["allocated"])
    device._card_memory.cache_clear()
    try:
        assert device.free_memory("cuda:1") == 100 + 3 - 2
        state.update(reserved=50, allocated=40)
        assert device.free_memory(torch.device("cuda:1")) == 103 - 40
    finally:
        device._card_memory.cache_clear()
    assert reads == [1]
