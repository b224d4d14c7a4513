"""The cube wave, back to back: weights, PSF, major cycles with the
degridding major cycle, and their CLEAN stages.

Set-up draws the dirty step's batch from the seed (:func:`dirty_step.
draw`), adds :mod:`portbench.gen.point_sources`' bright sources (their
visibilities predicted by the reference's degridding in float64 and
added, weighted, to the draws, so that both sides get the same data),
lets the program pack the batch (:func:`dirty_step.program_batch`) and
runs one wave to warm up.  The window then calls
``parallel.cube.wave_image`` on the batch, one wave after another, until
``seconds`` have passed on the host clock; every wave's channels count.

The benchmark wraps ``cube._clean_stage`` from outside: every stage's
input residual is read at the sampled pixels (one gather), its PSF
patch kept, and for one wave, drawn from the seed, the whole input,
model and output of every stage.  After the window, per channel:

- ``psf_err``: every wave's PSF patch against the reference's PSF (the
  weights imaged as visibilities, normalised by its own peak);
- ``dirty_err``: the first major cycle's CLEAN input at the sampled
  pixels against the reference's dirty image times its PSF scale;
- ``regrid_err``: the second major cycle's input against the reference's
  image of the visibilities less the weighted degrid prediction of the
  program's first-stage model (the program's state);
- ``clean_err``: each stage of the sampled wave replayed from the
  program's own state (:mod:`portbench.reference.clean`), its model and
  residual against the program's, the cycle counts equal; every other
  wave's final residual at the sampled pixels, and its model's count and
  sum, against that replay.

With ``trace``, each CLEAN stage is synchronised on both sides and timed
(``clean.stage`` spans, beside each wave's ``wave`` span and its
``minor`` cycles), and after the window one more wave runs under
``torch.profiler``.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.common.trace import Recorder, Trace, profiled
from portbench.runners import dirty_step
from portbench.gen import point_sources
from portbench.reference import clean as clean_ref
from portbench.reference import imaging as reference


def wave_config(conf: dict, traffic: dict):
    from katsdpimager_tpu_torch.parallel import cube

    return cube.CubeConfig(
        pixels=conf["pixels"], num_pols=conf["num_pols"],
        kernel_width=conf["kernel_width"], oversample=conf["oversample"],
        w_planes=conf["w_planes"], w_slices=conf["w_slices"],
        chunks_per_slice=conf["chunks_per_slice"],
        chunk_size=conf["chunk_size"], rv=conf["tile_size"],
        ru=conf["tile_size"], majors=traffic["majors"],
        minor=traffic["minor"], patch=traffic["patch"],
        psf_core=traffic["psf_core"], border_pixels=traffic["border"],
        loop_gain=traffic["loop_gain"], major_gain=traffic["major_gain"],
        threshold_sigma=traffic["threshold_sigma"],
        weight_type=conf["weight_type"])


def inputs(conf: dict, traffic: dict, seed: int, device):
    """The draws with the sources' visibilities added, and the
    reference's channels."""
    from katsdpimager_tpu_torch.parallel import multichannel as mc

    cfg = dirty_step.step_config(conf)

    def fits(c, s, d):
        mc.chunk_channel(cfg, d.uv, d.sub_uv, d.w_plane, d.vis, d.weights)

    draws = dirty_step.draw(conf, traffic, seed, fits)
    pos, ratios = point_sources.draw(seed, pixels=conf["pixels"],
                                     patch=traffic["patch"])
    channels = []
    for c, freq in enumerate(dirty_step.frequencies(traffic)):
        ch = reference.Channel.of(reference.C_M_PER_S / freq, conf, device)
        rms = point_sources.dirty_rms(
            np.concatenate([d.vis for d in draws[c]]),
            np.concatenate([d.weights for d in draws[c]]))
        flux = ratios * rms
        per_pol = np.repeat(flux[:, None], conf["num_pols"], axis=1)
        for s, d in enumerate(draws[c]):
            pred = ch.predict(s, d.uv, d.sub_uv, d.w_plane, pos[:, 0],
                              pos[:, 1], per_pol).cpu().numpy()
            draws[c][s] = d._replace(
                vis=(d.vis + d.weights * pred).astype(np.complex64))
        channels.append(ch)
    return draws, channels


class _Stages:
    """The wrapper put in ``cube._clean_stage``'s place: it reads each
    stage's input at the sampled pixels, keeps each patch, and keeps the
    whole state of the stages of the wave marked ``full``."""

    def __init__(self, stage, idx, sync, rec, timed: bool):
        self.stage, self.idx, self.sync, self.rec = stage, idx, sync, rec
        self.timed = timed
        self.full = False
        self.wave: list = []

    def __call__(self, cfg, residual, model, patch):
        P = residual.shape[0]
        entry = {"in": residual.reshape(P, -1).index_select(1, self.idx),
                 "patch": patch.clone()}
        if self.full:
            entry.update(r_in=residual, m_in=model.clone())
        if self.timed:
            self.sync()
            t0 = time.perf_counter()
        out = self.stage(cfg, residual, model, patch)
        if self.timed:
            self.sync()
            self.rec.add_span("clean.stage", t0, time.perf_counter())
        if self.full:
            entry.update(r_out=out[0], m_out=out[1].clone(), cycles=out[3])
        self.wave.append(entry)
        return out


def run(cell, *, seed: int, seconds: float, trace: bool, device: str,
        control: bool = False) -> dict:
    """One run of the cell.  ``control`` (the readings tool only) also
    reads each number with the reference at TF32 in the program's place,
    as ``control``."""
    import torch

    from katsdpimager_tpu_torch.parallel import cube

    conf, traffic = cell.config, cell.traffic
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = wave_config(conf, traffic)
    C, N, P = traffic["channels"], cfg.pixels, cfg.num_pols
    draws, channels = inputs(conf, traffic, seed, device)
    batch, _, _ = dirty_step.program_batch(conf, traffic, seed, device,
                                           draws=draws)
    rows, cols = reference.sample_axes(seed, channels[0].taper,
                                       traffic["sample_axis"])
    idx = torch.as_tensor((rows[:, None] * N + cols[None, :]).ravel(),
                          device=device)
    rec = Recorder()
    stages = _Stages(cube._clean_stage, idx, sync, rec, timed=trace)
    waves: list = []

    def one_wave(full: bool):
        stages.full, stages.wave = full, []
        t0 = time.perf_counter()
        res = cube.wave_image(cfg, batch)
        waves.append({
            "stages": stages.wave,
            "out": res.residual.reshape(C, P, -1).index_select(2, idx),
            "count": (res.model != 0).sum(dim=(1, 2, 3)),
            "sum": res.model.to(torch.float64).sum(dim=(1, 2, 3)),
            "minor": res.minor})
        if trace:
            sync()
            rec.add_span("wave", t0, time.perf_counter())

    cube._clean_stage = stages
    try:
        one_wave(False)                              # warm-up
        waves.clear()
        rec.spans.clear()
        sampled = int(np.random.default_rng([seed, 0xC1EA]).integers(2))
        sync()
        t_open = time.perf_counter()
        while True:
            one_wave(len(waves) == sampled)
            if (time.perf_counter() - t_open >= seconds
                    and len(waves) > sampled):
                break
        sync()
        window = time.perf_counter() - t_open
    finally:
        cube._clean_stage = stages.stage
    tr = None
    if trace:
        rec.count("minor", int(sum(int(w["minor"].sum()) for w in waves)))
        with profiled(cuda, host=False) as events:
            t0 = time.perf_counter()
            cube.wave_image(cfg, batch)
            sync()
            traced = time.perf_counter() - t0
        with profiled(cuda, host=True) as host_events:
            cube.wave_image(cfg, batch)
            sync()
        tr = Trace(rec.spans, rec.counters, events, traced, host_events)
    metrics = {"wave_s_per_channel": window / (len(waves) * C)}
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    full = waves[sampled]
    del batch
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    limits = traffic["limits"]
    checks, bad = compare(cfg, traffic, draws, channels, waves, full, rows,
                          cols, device, control)
    failed = int(bad.sum())
    out = {"correct": failed == 0 and len(waves) > 0,
           "attempted": len(waves) * C, "failed": failed,
           "metrics": metrics, "trace": tr,
           "memory_peak_bytes": int(memory_peak), "t_open": t_open,
           "reference_s": time.perf_counter() - t_ref,
           "checks": {k: (v["program"], limits[k]) for k, v in
                      checks.items()}}
    if control:
        out["control"] = {k: v["control"] for k, v in checks.items()}
    return out


def _gap(got, want, scale):
    """The widest gap of ``got`` from ``want`` over ``scale``; a
    non-finite gap reads infinite."""
    import torch

    g = float((got.to(want.device, torch.float64)
               - want.to(torch.float64)).abs().max() / scale)
    return g if np.isfinite(g) else float("inf")


def compare(cfg, traffic, draws, channels, waves, full, rows, cols, device,
            control: bool):
    """Each number compared, the program's reading (and with ``control``
    the control's) at its worst over channels and waves, and a (waves,
    C) mask of the channels of waves that read over a limit."""
    import torch

    limits = traffic["limits"]
    C, P, majors = traffic["channels"], cfg.num_pols, cfg.majors
    N, h = cfg.pixels, cfg.patch // 2
    centre = np.arange(N // 2 - h, N // 2 - h + cfg.patch)
    names = ("psf_err", "dirty_err", "regrid_err", "clean_err")
    checks = {k: {"program": 0.0, "control": 0.0} for k in names}
    bad = np.zeros((len(waves), C), bool)
    kw = dict(border=cfg.border_pixels, loop_gain=cfg.loop_gain,
              major_gain=cfg.major_gain, sigma=cfg.threshold_sigma,
              minor=cfg.minor)

    def note(name, c, per_wave, ctl=None):
        per_wave = np.asarray(per_wave, float)
        checks[name]["program"] = max(checks[name]["program"],
                                      float(per_wave.max()))
        bad[:, c] |= ~(per_wave <= limits[name])
        if ctl is not None:
            checks[name]["control"] = max(checks[name]["control"], ctl)

    for c, ch in enumerate(channels):
        st = [[w["stages"][c * majors + m] for m in range(majors)]
              for w in waves]
        coords = [(d.uv, d.sub_uv, d.w_plane) for d in draws[c]]
        psf_slices = [xy + (d.weights.astype(np.complex64),)
                      for xy, d in zip(coords, draws[c])]

        def psf_patch(tf32=False):
            img = ch.image(psf_slices, centre, centre, tf32=tf32)
            return img, img[:, h, h].to(torch.float64)

        psf, peak = psf_patch()
        psf = psf / peak[:, None, None]
        ctl = None
        if control:
            low, low_peak = psf_patch(True)
            ctl = _gap(low / low_peak[:, None, None], psf, 1.0)
        note("psf_err", c, [_gap(s[0]["patch"], psf, 1.0) for s in st], ctl)
        scale = (1.0 / peak)[:, None, None]

        def image(slices, tf32=False):
            return (ch.image(slices, rows, cols, tf32=tf32) * scale).reshape(
                P, -1)

        def image_gaps(name, major, slices):
            ref = image(slices)
            top = float(ref.abs().max())
            note(name, c, [_gap(s[major]["in"], ref, top) for s in st],
                 _gap(image(slices, True), ref, top) if control else None)

        image_gaps("dirty_err", 0, [xy + (d.vis,)
                                    for xy, d in zip(coords, draws[c])])
        # The major cycle: the visibilities less the weighted degrid
        # prediction of the first stage's model, as the program left it.
        f0 = full["stages"][c * majors]
        m1 = f0["m_out"]
        where = torch.nonzero(m1[0] != 0 if P == 1 else (m1 != 0).any(0))
        ys, xs = where[:, 0], where[:, 1]
        comps = m1[:, ys, xs].transpose(0, 1)
        residual_slices = []
        for s, (xy, d) in enumerate(zip(coords, draws[c])):
            pred = ch.predict(s, *xy, ys, xs, comps).cpu().numpy()
            residual_slices.append(xy + (d.vis - d.weights * pred,))
        image_gaps("regrid_err", 1, residual_slices)

        # CLEAN, replayed from the program's own state.
        gaps, ctl = [], 0.0
        for m in range(majors):
            f = full["stages"][c * majors + m]
            top = float(f["r_in"].abs().max())
            want = clean_ref.stage(f["r_in"], f["m_in"], f["patch"], **kw)
            same = int(f["cycles"]) == want[2]
            mtop = float(want[1].abs().max()) or 1.0
            gaps.append(max(_gap(f["r_out"], want[0], top),
                            _gap(f["m_out"], want[1], mtop))
                        if same else float("inf"))
            if control:
                low = clean_ref.stage(f["r_in"], f["m_in"], f["patch"],
                                      tf32=True, **kw)
                ctl = max(ctl, _gap(low[0], want[0], top),
                          _gap(low[1], want[1], mtop))
        final_out = want[0].reshape(P, -1)[:, (rows[:, None] * N
                                               + cols[None, :]).ravel()]
        count = int((want[1] != 0).sum())
        total = float(want[1].sum())
        per_wave = []
        for w in waves:
            g = max(max(gaps), _gap(w["out"][c], final_out, top))
            if int(w["count"][c]) != count:
                g = float("inf")
            g = max(g, abs(float(w["sum"][c]) - total) / mtop)
            per_wave.append(g)
        note("clean_err", c, per_wave, ctl if control else None)
    return checks, bad
