"""Drive the PyTorch/CUDA port's dirty-image step and cube wave on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels (K1-K7) from ``katsdpimager_tpu_torch/csrc``
and the production batch (8 channels, 4096 px, K=60, oversample 8,
32 W planes, 4 W slices, 2^19 visibilities per slice, natural weights),
then:

- checks every kernel against its plain PyTorch version at the shapes of
  the main paths (channel 0, slice 0) and times both;
- runs the 8-channel dirty-image step through
  ``multichannel.single_channel_step`` (1 warm-up, 3 timed iterations)
  with the launch counters reset just before, and checks channel 0's
  dirty image against the all-plain step;
- adds 5 bright point sources to the batch (predicted through the degrid
  path) and runs the 8-channel cube wave once at full width
  (``cube.wave_image``: weights, PSF, 2 major cycles of grid, FFT, CLEAN
  and degrid-subtract; then the beam fit and ``cube.wave_restore``), with
  the counters reset just before, and checks its launch counts;
- checks K5 against its plain version on the grid of the wave's own
  channel-0 model, within the f32 bound of its sums;
- checks channel 0's wave against the all-plain wave, as configured
  (border 0) and again with CLEAN's interior kept inside the field.

Each phase prints one JSON line; the card's name and power limit, the
kernel table and, last, the ``ok`` line follow.  Any failure raises: the
exit code is then non-zero.

It imports no JAX.
"""

import dataclasses
import json
import subprocess
import sys
import time

import torch


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls,
    by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(plain, kernel, reps: int = 3):
    """(kernel ms, plain ms), warmed up, measured in turns plain, kernel,
    kernel, plain."""
    plain()
    kernel()
    torch.cuda.synchronize()
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def max_err(a, b) -> float:
    return (a - b).abs().max().item()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from katsdpimager_tpu_torch.ops import (_build, fourier, fused_degrid,
                                            fused_fft, fused_gridder,
                                            mxu_gridder)
    from katsdpimager_tpu_torch.parallel import cube
    from katsdpimager_tpu_torch.parallel import multichannel as mc

    card = card_line()
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": _build.lib_path()})

    cfg = mc.MultiChannelConfig(
        pixels=4096, num_pols=1, kernel_width=60, oversample=8,
        w_planes=32, w_slices=4, chunks_per_slice=8192, chunk_size=256,
        rv=64, ru=64, minor_cycles=0, weight_type="natural")
    num_channels = 8
    t0 = time.perf_counter()
    batch = mc.make_example_batch(cfg, num_channels, vis_per_slice=1 << 19,
                                  device=dev)
    torch.cuda.synchronize()
    num_vis = int(batch.valid.sum())
    emit({"phase": "batch", "seconds": time.perf_counter() - t0,
          "num_vis": num_vis, "n_chunks": batch.n_chunks.tolist()})

    # ---- per-kernel parity and times at channel 0, slice 0
    N, ts, K = cfg.pixels, cfg.rv, cfg.kernel_width
    nt2 = mxu_gridder.colour_tiles(N, ts)
    ext2 = nt2 * 2 * ts
    n = int(batch.n_chunks[0, 0])
    kern = batch.kernel[0]
    uv, sub, wp, anc, val, vis = (x[0, 0] for x in (
        batch.uv, batch.sub_uv, batch.w_plane, batch.anchor, batch.valid,
        batch.vis))
    iu, iv, su, sv = fused_gridder.tap_indices(kern, uv, sub, wp, anc,
                                               pixels=N, ts=ts)
    sre, sim = fused_gridder.samples(vis, val, None, None, anc, su, sv,
                                     kernel_width=K, ts=ts)
    slot = fused_gridder.chunk_slots(anc, n, ts=ts, nt2=nt2)
    table = fused_gridder.conj_table(kern)
    occ = fused_gridder.occupancy(slot, n, nt2)
    shape = (2, 2, cfg.num_pols, ext2, ext2)
    kr, ki = (torch.empty(shape, device=dev) for _ in range(2))
    pr, pi = (torch.empty(shape, device=dev) for _ in range(2))

    def k1_kernel():
        fused_gridder.grid_planes(slot, n, iu, iv, su, sv, sre, sim, table,
                                  kr, ki, ts=ts)

    def k1_plain():
        fused_gridder.grid_planes_plain(slot, n, iu, iv, su, sv, sre, sim,
                                        table, pr, pi, ts=ts)

    rows = []

    def record(name, source, replaces, err, tol, ms, plain_ms):
        ok = err <= tol
        emit({"phase": "kernel", "name": name, "max_abs_err": err,
              "tolerance": tol, "ms": ms, "plain_ms": plain_ms, "ok": ok})
        if not ok:
            raise AssertionError(f"{name}: error {err} > tolerance {tol}")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms})

    ms, plain_ms = timed_pair(k1_plain, k1_kernel)
    written = occ.repeat_interleave(2 * ts, -2).repeat_interleave(
        2 * ts, -1)[:, :, None]                     # (2, 2, 1, ext2, ext2)
    scale = max(pr.abs().where(written, 0.0).max().item(),
                pi.abs().where(written, 0.0).max().item())
    err = max((kr - pr).abs().where(written, 0.0).max().item(),
              (ki - pi).abs().where(written, 0.0).max().item())
    record("K1 fused gridder", "katsdpimager_tpu_torch/csrc/gridder.cu",
           "katsdpimager_tpu/ops/pallas_gridder.py:118", err, 2e-5 * scale,
           ms, plain_ms)

    out = {}

    def k2_kernel():
        out["k"] = fused_gridder.combine_planes(kr, ki, occ, pixels=N, ts=ts)

    def k2_plain():
        out["p"] = fused_gridder.combine_planes_plain(kr, ki, occ, pixels=N,
                                                      ts=ts)

    ms, plain_ms = timed_pair(k2_plain, k2_kernel)
    gr, gi = out["k"]
    if not (torch.equal(gr, out["p"][0]) and torch.equal(gi, out["p"][1])):
        raise AssertionError("K2 is not bitwise equal to its plain version")
    record("K2 colour combine", "katsdpimager_tpu_torch/csrc/gridder.cu",
           "katsdpimager_tpu/ops/pallas_gridder.py:570",
           max(max_err(gr, out["p"][0]), max_err(gi, out["p"][1])), 0.0,
           ms, plain_ms)

    def k3_kernel():
        out["k"] = fused_fft.cb_col_fft(gr, gi)

    def k3_plain():
        out["p"] = fused_fft.cb_col_fft_plain(gr, gi)

    ms, plain_ms = timed_pair(k3_plain, k3_kernel)
    (ar, ai), (par, pai) = out["k"], out["p"]
    scale = max(par.abs().max().item(), pai.abs().max().item())
    record("K3 checkerboard column DFT", "katsdpimager_tpu_torch/csrc/fft.cu",
           "katsdpimager_tpu/ops/pallas_fft.py:204",
           max(max_err(ar, par), max_err(ai, pai)), 1e-5 * scale,
           ms, plain_ms)

    taper = batch.taper1d[0]
    scal = fused_fft.scalars(batch.mid_w[0, 0], batch.pixel_size[0], dev)
    img_k = torch.zeros((cfg.num_pols, N, N), device=dev)
    img_p = torch.zeros_like(img_k)
    ms, plain_ms = timed_pair(
        lambda: fused_fft.epi_col_fft_plain(par, pai, img_p, taper, scal),
        lambda: fused_fft.epi_col_fft(par, pai, img_k, taper, scal))
    # Both accumulated the same layer the same number of times.  The
    # epilogue divides by taper^2, which amplifies either version's f32
    # DFT rounding by up to 1/min(taper^2) in the image corners
    # (doc/PERFORMANCE.md, "The 1e-4 image gate"); weighting the
    # difference by taper^2 / max(taper^2) undoes exactly that
    # amplification and leaves the kernel's own error.
    t2 = torch.outer(taper, taper)
    weight = (t2 / t2.max())[None]
    emit({"phase": "kernel_detail", "name": "K4",
          "max_abs_err_unweighted": max_err(img_k, img_p),
          "peak": img_p.abs().max().item()})
    record("K4 column DFT + imaging epilogue",
           "katsdpimager_tpu_torch/csrc/fft.cu",
           "katsdpimager_tpu/ops/pallas_fft.py:227",
           ((img_k - img_p).abs() * weight).max().item(),
           1e-5 * img_p.abs().max().item(), ms, plain_ms)
    # K6 and K7 on a model of 2000 components of random flux in the
    # central half of the image, with the production taper and the
    # slice's w; K5 on the grid that gives, for the occupied chunks of
    # channel 0, slice 0, against 1e-5 of its largest prediction.  A model
    # with power in the image corners is divided there by taper^2, up to
    # ~3000x, and the degridder's f32 sums cancel by as much: K5 is held
    # on the wave's own model, which has such components, after the wave
    # (k5_on_wave_model).
    gen = torch.Generator().manual_seed(1)
    model = torch.zeros((cfg.num_pols, N, N))
    yx = torch.randint(N // 4, N - N // 4, (2, 2000), generator=gen)
    model[:, yx[0], yx[1]] = torch.randn(2000, generator=gen)
    model = model.to(dev)
    ms, plain_ms = timed_pair(
        lambda: out.__setitem__("p", fused_fft.pre_col_fft_plain(
            model, taper, scal)),
        lambda: out.__setitem__("k", fused_fft.pre_col_fft(model, taper,
                                                           scal)))
    (ar, ai), (par, pai) = out["k"], out["p"]
    scale = max(par.abs().max().item(), pai.abs().max().item())
    record("K6 image prologue + column DFT",
           "katsdpimager_tpu_torch/csrc/fft.cu",
           "katsdpimager_tpu/ops/pallas_fft.py:343",
           max(max_err(ar, par), max_err(ai, pai)), 1e-5 * scale,
           ms, plain_ms)

    ms, plain_ms = timed_pair(
        lambda: out.__setitem__("p", fused_fft.cbout_col_fft_plain(par,
                                                                   pai)),
        lambda: out.__setitem__("k", fused_fft.cbout_col_fft(par, pai)))
    (gr, gi), (pgr, pgi) = out["k"], out["p"]
    scale = max(pgr.abs().max().item(), pgi.abs().max().item())
    record("K7 column DFT + output checkerboard",
           "katsdpimager_tpu_torch/csrc/fft.cu",
           "katsdpimager_tpu/ops/pallas_fft.py:380",
           max(max_err(gr, pgr), max_err(gi, pgi)), 1e-5 * scale,
           ms, plain_ms)

    av, au, diu, div, dsu, dsv = fused_degrid.degrid_taps(
        kern, uv, sub, wp, anc, pixels=N, ts=ts)
    dtab = fused_degrid.degrid_table(kern)
    dargs = (pgr, pgi, av, au, diu, div, dsu, dsv, dtab, n)
    ms, plain_ms = timed_pair(
        lambda: out.__setitem__("p", fused_degrid.degrid_planes_plain(
            *dargs, ts=ts)),
        lambda: out.__setitem__("k", fused_degrid.degrid_planes(*dargs,
                                                                ts=ts)))
    scale = out["p"].abs().max().item()
    record("K5 fused degridder", "katsdpimager_tpu_torch/csrc/degrid.cu",
           "katsdpimager_tpu/ops/pallas_gridder.py:706",
           max_err(out["k"], out["p"]), 1e-5 * scale, ms, plain_ms)
    del kr, ki, pr, pi, out, img_k, img_p, par, pai, ar, ai, gr, gi
    del pgr, pgi, model, dargs

    # ---- the step: 8 channels through single_channel_step
    step = mc.single_channel_step(cfg)

    def run_step():
        return [step(*mc.channel_args(batch, c))[0]
                for c in range(num_channels)]

    run_step()
    torch.cuda.synchronize()
    counters = (fused_gridder.grid_planes, fused_gridder.combine_planes,
                fused_fft.cb_col_fft, fused_fft.epi_col_fft)
    for fn in counters:
        fn.launches = 0
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        dirty = run_step()
    torch.cuda.synchronize()
    elapsed = (time.perf_counter() - t0) / iters
    launches = [fn.launches for fn in counters]
    nonempty = int((batch.n_chunks > 0).sum())
    emit({"phase": "step", "card": card, "num_vis": num_vis,
          "num_channels": num_channels, "iters": iters,
          "elapsed_s": elapsed, "mvis_per_s": num_vis / elapsed / 1e6,
          "ggaps": num_vis * cfg.kernel_width ** 2 * cfg.num_pols
          / elapsed / 1e9,
          "launches": dict(zip(("K1", "K2", "K3", "K4"), launches)),
          "nonempty_channel_slices": nonempty,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if min(launches) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if launches[0] != iters * nonempty:
        raise AssertionError(f"K1 launched {launches[0]} times, expected "
                             f"{iters} x {nonempty} non-empty slices")
    for row, count in zip(rows, launches):
        row["step_launches"] = count

    # ---- step parity: channel 0 against the all-plain step on the card
    got = dirty[0]
    ref = mc.single_channel_step(cfg, plain=True)(
        *mc.channel_args(batch, 0))[0]
    t2 = torch.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    peak = ref.abs().max().item()
    err = (got - ref).abs()[:, inside].max().item() / peak
    finite = all(bool(torch.isfinite(d).all()) for d in dirty)
    shapes = all(tuple(d.shape) == (cfg.num_pols, N, N) for d in dirty)
    emit({"phase": "step_parity", "max_err_inside_over_peak": err,
          "tolerance": 1e-4, "peak": peak, "finite": finite,
          "shapes_ok": shapes})
    if not (err <= 1e-4 and finite and shapes and peak > 0):
        raise AssertionError("step parity failed")

    del dirty, got, ref
    wave_phases(cfg, batch, num_channels, rows, card, mc, cube, fourier,
                fused_gridder, fused_fft, fused_degrid)

    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def wave_phases(mcfg, batch, num_channels, rows, card, mc, cube, fourier,
                fused_gridder, fused_fft, fused_degrid) -> None:
    """The 8-channel cube wave at full width, its launch counts, its
    restore, K5 on the wave's own model, and channel 0 against the
    all-plain wave (at border 0, and with CLEAN kept inside the field)."""
    cfg = cube.CubeConfig(
        pixels=mcfg.pixels, num_pols=mcfg.num_pols,
        kernel_width=mcfg.kernel_width, oversample=mcfg.oversample,
        w_planes=mcfg.w_planes, w_slices=mcfg.w_slices,
        chunks_per_slice=mcfg.chunks_per_slice, chunk_size=mcfg.chunk_size,
        rv=mcfg.rv, ru=mcfg.ru, majors=2, minor=10000, patch=65,
        psf_core=64, loop_gain=0.1, major_gain=0.85, threshold_sigma=5.0,
        weight_type="natural")
    t0 = time.perf_counter()
    batch, pos, flux = cube.with_point_sources(cfg, batch, seed=7)
    torch.cuda.synchronize()
    emit({"phase": "sources", "seconds": time.perf_counter() - t0,
          "positions_yx": pos.tolist(), "flux_ch0": flux[0].tolist()})

    # CLEAN's share of the wave: host clock around each CLEAN stage (the
    # stage reads its stop flag on the host once per batch of cycles).
    clean_s = [0.0]
    clean_stage = cube._clean_stage

    def timed_clean_stage(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = clean_stage(*args)
        torch.cuda.synchronize()
        clean_s[0] += time.perf_counter() - t
        return result

    cube._clean_stage = timed_clean_stage
    counters = (fused_gridder.grid_planes, fused_gridder.combine_planes,
                fused_fft.cb_col_fft, fused_fft.epi_col_fft,
                fused_degrid.degrid_planes, fused_fft.pre_col_fft,
                fused_fft.cbout_col_fft)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        res = cube.wave_image(cfg, batch)
        torch.cuda.synchronize()
    finally:
        cube._clean_stage = clean_stage
    elapsed = time.perf_counter() - t0
    launches = [fn.launches for fn in counters]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    minors = res.minor.tolist()
    nonempty = int((batch.n_chunks > 0).sum())
    names = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")
    emit({"phase": "wave", "card": card, "num_channels": num_channels,
          "elapsed_s": elapsed, "s_per_channel": elapsed / num_channels,
          "minor_cycles_per_channel": minors,
          "clean_s": clean_s[0],
          "clean_cycles_per_s": sum(minors) / clean_s[0],
          "noise": res.noise.tolist(),
          "launches": dict(zip(names, launches)),
          "nonempty_channel_slices": nonempty, "peak_mem_gb": peak_gb})
    want = (cfg.majors - 1) * nonempty
    if launches[4:] != [want] * 3:
        raise AssertionError(f"K5-K7 launched {launches[4:]} times, "
                             f"expected {want} each")
    if launches[0] != (1 + cfg.majors) * nonempty or min(minors) <= 0:
        raise AssertionError(f"wave launches {launches}, minor {minors}")
    for row, count in zip(rows, launches):
        row["launches"] = count

    # ---- restore: beam fits on the host, then the convolution + residual
    t0 = time.perf_counter()
    beam_m, beams = cube.fit_wave_beams(res.psf_core)
    restored = cube.wave_restore(cfg, res.model, res.residual, beam_m)
    torch.cuda.synchronize()
    at_src = restored[:, 0, pos[:, 0], pos[:, 1]].cpu().numpy()
    ratio = at_src / flux
    emit({"phase": "restore", "seconds": time.perf_counter() - t0,
          "beam_ch0": [beams[0].major, beams[0].minor, beams[0].theta],
          "restored_over_flux_min": float(ratio.min()),
          "restored_over_flux_max": float(ratio.max())})
    if not (bool(torch.isfinite(restored).all())
            and tuple(restored.shape) == tuple(res.model.shape)
            and 0.5 <= ratio.min() and ratio.max() <= 1.5):
        raise AssertionError("restore check failed")

    b0 = mc.ChannelBatch(*(x[:1] for x in batch))
    args = tuple(x[0] for x in b0[:11])
    kern, tap, ps, midw, uv, sub, wp, anc, val, _, vis = args
    k5_on_wave_model(cfg, res.model[0], b0, fourier, fused_degrid)

    # ---- wave parity: channel 0 against the all-plain wave on the card
    ref = cube.wave_image(cfg, b0, plain=True)
    dirty = cube._grid_slices(cfg, kern, None, uv, sub, wp, anc, val, vis,
                              tap, ps, midw, b0.n_chunks[0].tolist())
    dirty_peak = (dirty / ref.psf_peak[0][:, None, None]).abs().max().item()
    # Inside the anti-aliased field (taper^2 >= 0.2% of its peak).
    # Outside it, either version's f32 grid rounding, divided by taper^2
    # (up to ~1e4x at the image edge), exceeds the 5 sigma threshold, so
    # CLEAN's components there come from rounding noise and differ.
    t2 = torch.outer(tap, tap)
    inside = t2 >= 0.002 * t2.max()

    def parity(phase, border, got, want, everywhere):
        err_res = (got.residual[0] - want.residual[0]).abs()[:, inside].max()
        err_mod = (got.model[0] - want.model[0]).abs()[:, inside].max()
        err = max(err_res.item(), err_mod.item()) / dirty_peak
        comps, ref_comps = got.model[0] != 0, want.model[0] != 0
        where = torch.ones_like(inside) if everywhere else inside
        same = bool(torch.equal(comps[:, where], ref_comps[:, where]))
        minor = [int(got.minor[0]), int(want.minor[0])]
        finite = all(bool(torch.isfinite(x).all()) for x in
                     (got.residual, got.model, want.residual, want.model))
        emit({"phase": phase, "border_pixels": border,
              "max_err_inside_over_dirty_peak": err, "tolerance": 1e-4,
              "dirty_peak": dirty_peak,
              "components_inside": int(comps[:, inside].sum()),
              "components_outside": [int(comps[:, ~inside].sum()),
                                     int(ref_comps[:, ~inside].sum())],
              "same_component_positions": same,
              "compared": "everywhere" if everywhere else "inside the field",
              "finite": finite, "minor": minor,
              "minor_difference": minor[0] - minor[1]})
        ok = err <= 1e-4 and same and finite and dirty_peak > 0
        if everywhere:
            ok = ok and minor[0] == minor[1]
        if not ok:
            raise AssertionError(f"{phase} failed")

    # With border 0 (the configuration above), CLEAN may also pick
    # components outside the field, from rounding noise; compare positions
    # inside it.  The second witness keeps CLEAN's interior inside the
    # field: there every component position and the minor-cycle count
    # must be equal.
    parity("wave_parity", cfg.border_pixels, res, ref, everywhere=False)
    del ref
    cfg_in = dataclasses.replace(cfg, border_pixels=field_border(tap))
    parity("wave_parity_border", cfg_in.border_pixels,
           cube.wave_image(cfg_in, b0),
           cube.wave_image(cfg_in, b0, plain=True), everywhere=True)


def field_border(taper) -> int:
    """The smallest CLEAN border whose square interior lies inside the
    anti-aliased field, taper^2 >= 0.2% of its peak: at the interior's
    corners taper(b)^4 >= 0.002 taper_max^4, rounded up to 16 pixels."""
    r = (taper / taper.max()).double()
    ok = (r * r * r * r >= 0.002) & (r.flip(0) ** 4 >= 0.002)
    b = int(torch.nonzero(ok)[0])
    return -(-b // 16) * 16


def k5_on_wave_model(cfg, model, b0, fourier, fused_degrid) -> None:
    """K5 against its plain version on the grid of the wave's own
    channel-0 model (through K6 and K7), for channel 0, slice 0.

    CLEAN also puts components outside the field, where K6 divides by
    taper^2 (up to ~3000x), so the grid carries large terms that cancel in
    the prediction.  Two f32 sums of the same n = K^2 terms, in any
    order, differ by at most 2 (n + 4) u sum|terms| (u = 2^-24, the +4
    for the complex products): that bound, per visibility, is the gate.
    The line also gives the error against the largest prediction."""
    N, ts, K = cfg.pixels, cfg.rv, cfg.kernel_width
    kern, tap, ps, midw, uv, sub, wp, anc = (x[0] for x in b0[:8])
    n = int(b0.n_chunks[0, 0])
    gr, gi = fourier.image_to_grid_parts(model, tap, midw[0], ps)
    av, au, iu, iv, su, sv = fused_degrid.degrid_taps(
        kern, uv[0], sub[0], wp[0], anc[0], pixels=N, ts=ts)
    tab = fused_degrid.degrid_table(kern)
    taps = (av, au, iu, iv, su, sv)
    got = fused_degrid.degrid_planes(gr, gi, *taps, tab, n, ts=ts)
    want = fused_degrid.degrid_planes_plain(gr, gi, *taps, tab, n, ts=ts)
    mag = torch.complex(gr, gi).abs()
    terms = fused_degrid.degrid_planes_plain(
        mag, torch.zeros_like(mag), *taps,
        tab.abs().to(torch.complex64), n, ts=ts).real
    diff = got - want
    err = torch.maximum(diff.real.abs(), diff.imag.abs())
    unit = 2.0 ** -24 * terms
    bound = 2 * (K * K + 4) * unit
    scale = want.abs().max().item()
    live = terms > 0
    emit({"phase": "kernel_on_wave_model", "name": "K5",
          "max_abs_err": err.max().item(), "largest_prediction": scale,
          "err_over_largest_prediction": err.max().item() / scale,
          "max_sum_abs_terms_over_largest_prediction":
              terms.max().item() / scale,
          "max_err_in_units_of_u_sum_abs_terms":
              (err[live] / unit[live]).max().item(),
          "bound_in_those_units": 2 * (K * K + 4),
          "ok": bool((err <= bound).all())})
    if not bool((err <= bound).all()):
        raise AssertionError("K5 on the wave model exceeds the f32 bound")


if __name__ == "__main__":
    main()
