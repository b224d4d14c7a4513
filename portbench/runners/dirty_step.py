"""The multi-channel dirty-image step, back to back.

Set-up draws the batch's visibilities from the seed
(:mod:`portbench.gen.example_batch`), lets the program work out each
channel's kernel tables, taper and mid-w (``parameters``, ``ops.wkernel``)
and pack each (channel, W slice) with its planner
(``multichannel.chunk_channel``), uploads the batch and runs one step to
warm up.  The window then calls
``multichannel.single_channel_step`` on every channel of the batch, one
step after another, the images left on the device, until ``seconds``
have passed on the host clock, and synchronises once.  CUDA events on the
stream at each step's boundaries time the steps, so a host stall that
starves the stream counts in the step it delays.

Every image of every step is read at a product set of sampled pixels
inside the anti-aliased field (one gather per image, on the device);
once the window has closed and the program's state is freed, the
reference (:mod:`portbench.reference.imaging`) evaluates each channel at
those pixels in float64, and each image's widest gap, over the channel's
largest reference value, is held to the mix's limit.

The mix's ``metric_prefix`` names the end-to-end metrics
(``<prefix>_mvis_per_s``, ``<prefix>_step_p95_ms``), so that cells of
different weighting are bounded apart.

With ``trace``, the window also times each call of the imaging weights'
grid (``multichannel.weight_grid``, uniform weights only), synchronised
on both sides (``weight_grid`` spans), and after the window a stretch of
``trace_steps`` steps runs under ``torch.profiler``; the readers get its
events, the window's step spans (``dirty.step``, call to the last
launch's return) and the work of K1's launches (``k1.work``: per step,
one record per non-empty slice).
"""

from __future__ import annotations

import time

import numpy as np

from portbench.common.trace import Recorder, Trace, profiled
from portbench.gen import example_batch
from portbench.reference import imaging as reference


def step_config(conf: dict):
    from katsdpimager_tpu_torch.parallel import multichannel as mc

    return mc.MultiChannelConfig(
        pixels=conf["pixels"], num_pols=conf["num_pols"],
        kernel_width=conf["kernel_width"], oversample=conf["oversample"],
        w_planes=conf["w_planes"], w_slices=conf["w_slices"],
        chunks_per_slice=conf["chunks_per_slice"],
        chunk_size=conf["chunk_size"], rv=conf["tile_size"],
        ru=conf["tile_size"], minor_cycles=0,
        weight_type=conf["weight_type"])


def frequencies(traffic: dict) -> list:
    base, step = traffic["base_frequency_hz"], traffic["channel_step"]
    return [base * (1 + step * c) for c in range(traffic["channels"])]


def draw(conf: dict, traffic: dict, seed: int, pack) -> list:
    """The mix's visibilities from ``seed`` (:mod:`portbench.gen.
    example_batch`), each (channel, slice) handed to ``pack``."""
    return example_batch.draw_slices(
        seed, channels=traffic["channels"], w_slices=conf["w_slices"],
        pixels=conf["pixels"], kernel_width=conf["kernel_width"],
        oversample=conf["oversample"], w_planes=conf["w_planes"],
        num_pols=conf["num_pols"], vis_per_slice=traffic["vis_per_slice"],
        pack=pack)


def program_batch(conf: dict, traffic: dict, seed: int, device,
                  draws=None):
    """The program's batch: the frozen draws (or ``draws``, already
    drawn), the program's own tables and planner.  Returns (batch, draws,
    work), ``work[c][s]`` K1's inputs of each non-empty (channel, slice):
    chunks, valid visibilities, anchor runs."""
    import torch

    from katsdpimager_tpu_torch import parameters, polarization
    from katsdpimager_tpu_torch.ops import wkernel
    from katsdpimager_tpu_torch.parallel import multichannel as mc
    from katsdpimager_tpu_torch.units import C_M_PER_S

    cfg = step_config(conf)
    C, S = traffic["channels"], cfg.w_slices
    N, K, O, P = cfg.pixels, cfg.kernel_width, cfg.oversample, cfg.num_pols
    NC, Mc = cfg.chunks_per_slice, cfg.chunk_size
    fixed = parameters.FixedImageParameters(
        (polarization.STOKES_I,) * P, conf["precision"])
    gp = parameters.GridParameters(parameters.FixedGridParameters(
        antialias_width=conf["antialias_width"], oversample=O,
        image_oversample=conf["image_oversample"], max_w=conf["max_w_m"],
        kernel_width=K), S, cfg.w_planes)
    kernels = np.empty((C, cfg.w_planes, O, K), np.complex64)
    tapers = np.empty((C, N), np.float32)
    pixel_sizes = np.empty((C,), np.float32)
    mid_ws = np.empty((C, S), np.float32)
    for c, freq in enumerate(frequencies(traffic)):
        ip = parameters.ImageParameters(fixed, C_M_PER_S / freq,
                                        pixel_size=conf["pixel_size"],
                                        pixels=N)
        kernels[c] = wkernel.make_convolution_kernel(ip, gp)
        tapers[c] = wkernel.taper(N, conf["antialias_width"], O)
        pixel_sizes[c] = ip.pixel_size
        mid_ws[c] = wkernel.mid_w_values(ip, gp)

    shape = (C, S, NC, Mc)
    arrays = {"uv": np.zeros(shape + (2,), np.int32),
              "sub_uv": np.zeros(shape + (2,), np.int32),
              "w_plane": np.zeros(shape, np.int32),
              "anchor": np.zeros((C, S, NC, 2), np.int32),
              "valid": np.zeros(shape, bool),
              "weights": np.zeros(shape + (P,), np.float32),
              "vis": np.zeros(shape + (P,), np.complex64)}
    n_chunks = np.zeros((C, S), np.int64)
    names = ("uv", "sub_uv", "w_plane", "anchor", "valid", "weights", "vis")

    def pack(c, s, d):
        packed, n_chunks[c, s] = mc.chunk_channel(
            cfg, d.uv, d.sub_uv, d.w_plane, d.vis, d.weights)
        for name, a in zip(names, packed):
            arrays[name][c, s] = a

    if draws is None:
        draws = draw(conf, traffic, seed, pack)
    else:
        for c, row in enumerate(draws):
            for s, d in enumerate(row):
                pack(c, s, d)
    work = [[None if n_chunks[c, s] == 0 else {
        "chunks": int(n_chunks[c, s]),
        "valid": int(arrays["valid"][c, s].sum()),
        "runs": len(np.unique(arrays["anchor"][c, s, :n_chunks[c, s]],
                              axis=0)),
        "pols": P, "ts": cfg.rv, "kernel_width": K,
        "table_rows": cfg.w_planes * O} for s in range(S)] for c in range(C)]

    def dev(a):
        return torch.from_numpy(a).to(device)

    batch = mc.ChannelBatch(
        kernel=dev(kernels), taper1d=dev(tapers), pixel_size=dev(pixel_sizes),
        mid_w=dev(mid_ws), **{k: dev(v) for k, v in arrays.items()},
        n_chunks=torch.from_numpy(n_chunks))
    return batch, draws, work


class _Clock:
    """Step boundaries: CUDA events on the stream, or the host clock on
    the CPU."""

    def __init__(self, cuda: bool):
        import torch

        self.torch, self.cuda, self.marks = torch, cuda, []

    def mark(self) -> None:
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> list:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        control: bool = False) -> dict:
    """One run of the cell.  ``control`` (the readings tool only) also
    puts the reference at TF32 in the program's place and returns its
    reading as ``control`` (``{"dirty_err": ...}``)."""
    import torch

    from katsdpimager_tpu_torch.parallel import multichannel as mc

    conf, traffic = cell.config, cell.traffic
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = step_config(conf)
    C, N, P = traffic["channels"], cfg.pixels, cfg.num_pols
    batch, draws, work = program_batch(conf, traffic, seed, device)
    num_vis = sum(len(d.uv) for row in draws for d in row)
    rows, cols = reference.sample_axes(
        seed, reference.wkernel.taper(N, conf["antialias_width"],
                                      cfg.oversample),
        traffic["sample_axis"])
    idx = torch.as_tensor((rows[:, None] * N + cols[None, :]).ravel(),
                          device=device)
    step = mc.single_channel_step(cfg)
    args = [mc.channel_args(batch, c) for c in range(C)]
    samples: list = []

    def one_step():
        images = [step(*a)[0] for a in args]
        samples.append([img.reshape(P, -1).index_select(1, idx)
                        for img in images])

    one_step()                                    # warm-up
    samples.clear()
    sync()
    rec = Recorder()
    weight_grid = mc.weight_grid
    if trace:
        def timed_weight_grid(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = weight_grid(*args, **kwargs)
            sync()
            rec.add_span("weight_grid", t0, time.perf_counter())
            return out

        mc.weight_grid = timed_weight_grid
    clock = _Clock(cuda)
    try:
        t_open = time.perf_counter()
        clock.mark()
        k = 0
        while True:
            t0 = time.perf_counter()
            one_step()
            clock.mark()
            t1 = time.perf_counter()
            rec.add_span("dirty.step", t0, t1)
            k += 1
            if t1 - t_open >= seconds:
                break
        sync()
        window = time.perf_counter() - t_open
    finally:
        mc.weight_grid = weight_grid
    prefix = traffic["metric_prefix"]
    metrics = {f"{prefix}_mvis_per_s": k * num_vis / window / 1e6,
               f"{prefix}_step_p95_ms": float(np.percentile(clock.step_ms(),
                                                            95))}

    tr = None
    if trace:
        from katsdpimager_tpu_torch.ops import fused_gridder

        n_trace = traffic["trace_steps"]
        launches = fused_gridder.grid_planes.launches
        with profiled(cuda, host=False) as events:
            t0 = time.perf_counter()
            for _ in range(n_trace):
                one_step()
            sync()
            traced = time.perf_counter() - t0
        rec.count("trace.steps", n_trace)
        rec.count("k1.launches", fused_gridder.grid_planes.launches - launches)
        rec.counters["k1.work"] = [w for row in work for w in row if w]
        with profiled(cuda, host=True) as host_events:
            one_step()
            sync()
        tr = Trace(rec.spans, rec.counters, events, traced, host_events)

    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del batch, args
    got = [torch.stack([s[c] for s in samples]).cpu() for c in range(C)]
    samples.clear()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    limit = traffic["limits"]["dirty_err"]
    worst, failed, control_worst = 0.0, 0, 0.0
    for c, freq in enumerate(frequencies(traffic)):
        ch = reference.Channel.of(reference.C_M_PER_S / freq, conf, device)
        slices = reference.weighted(draws[c], pixels=N,
                                    weight_type=conf["weight_type"])

        def ref_at(tf32):
            return ch.image(slices, rows, cols, tf32=tf32).reshape(
                P, -1).cpu()

        ref = ref_at(False)
        err = gaps(got[c], ref)
        worst = max(worst, float(err.max()))
        failed += int((err > limit).sum())
        if control:
            control_worst = max(control_worst,
                                float(gaps(ref_at(True)[None], ref).max()))
    out = {"correct": failed == 0 and k > 0, "attempted": len(got[0]) * C,
           "failed": failed, "metrics": metrics, "trace": tr,
           "memory_peak_bytes": int(memory_peak), "t_open": t_open,
           "reference_s": time.perf_counter() - t_ref,
           "checks": {"dirty_err": (worst, limit)}}
    if control:
        out["control"] = {"dirty_err": control_worst}
    return out


def gaps(got, ref):
    """Each image's widest gap from the reference over its sampled pixels,
    over the reference's largest magnitude there: ``got`` (images, P, L)
    against ``ref`` (P, L) float64; a non-finite gap reads infinite."""
    import torch

    err = ((got.to(torch.float64) - ref).abs().amax(dim=(1, 2))
           / ref.abs().max())
    return torch.where(torch.isfinite(err), err, torch.inf)
