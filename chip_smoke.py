"""Drive the PyTorch/CUDA port on one GPU: its kernels, the dirty-image
step, the cube wave, the numerics probes and the per-channel CLI.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels (K1-K8 and the probes P1/P2) from
``katsdpimager_tpu_torch/csrc`` and the production batch (8 channels,
4096 px, K=60, oversample 8, 32 W planes, 4 W slices, 2^19 visibilities
per slice, natural weights), then:

- prints what ``ptxas -v`` reported for K1 and K8 (registers, spills,
  shared memory);
- checks every kernel against its plain PyTorch version at the shapes of
  the main paths (channel 0, slice 0; K8 at (1, 4096, 4096)) and times
  both, and K8 also against ``torch.fft.fft`` along dim -2, in turns;
  computes each kernel's roofline bound from its inputs (H100 SXM peaks);
  ``fft2`` (two K8 passes) against ``torch.fft.fft2``;
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
  (border 0) and again with CLEAN's interior kept inside the field;
- runs the probes P1 (A, B, C) and P2 (E, F): the selections and the
  recombine exact, the FP32 band dot within 1e-6, the TF32 one printed;
- runs the per-channel CLI path (``frontend.run``) on a simulated
  64-antenna, 1024-dump, 2-channel L-band observation with noise (in
  memory: the card's machine has no h5py, so ``--no-tmp-file``) at
  4096 px, K=60, 2 majors: channel 0 with the DFT-predict major cycle,
  channel 1 with ``--degrid``; checks the K1-K7 launch counts against the
  slice, block and major counts, the restored fluxes against the truth,
  and each channel against the all-plain run;
- profiles both channels: host seconds by stage, and the device's busy
  time and idle share under ``torch.profiler``.

Each phase prints one JSON line; the card's name and power limit, the
kernel table and, last, the ``ok`` line follow.  Any failure raises: the
exit code is then non-zero.

It imports no JAX.
"""

import dataclasses
import json
import math
import subprocess
import sys
import time

import torch


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at its
# 700 W limit): the least time a kernel could take is the larger of its
# bytes (each input read once, each output written once) over the memory
# rate and its operations over the rate of the unit that does them: FP32
# outside the tensor cores, TF32 or bf16 on them.
H100_SXM_HBM_BYTES_PER_S = 3.35e12
H100_SXM_FLOP_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}

#: Times of the designs K1 and K8 replace, as PERF.md records them for
#: PR 3 (call 3 for K1; calls 3-10 for K8) on "NVIDIA H100 80GB HBM3,
#: 700.00 W".
REPLACED_DESIGN_MS = {"K1": 5.204, "K8": (0.854, 0.901)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, **flops: float) -> dict:
    """``bound_ms`` and ``bound_by`` of a kernel that moves ``nbytes`` and
    does ``flops[unit]`` operations on each unit of
    :data:`H100_SXM_FLOP_PER_S` (``fp32=``, ``tf32=``, ``bf16=``), at the
    H100 SXM peaks."""
    t_bytes = nbytes / H100_SXM_HBM_BYTES_PER_S
    t_ops = sum(f / H100_SXM_FLOP_PER_S[unit] for unit, f in flops.items())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fft_flops(n: int, columns: int) -> float:
    """5 n log2 n per complex transform of length n, ``columns`` of them."""
    return 5.0 * n * math.log2(n) * columns


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


def timed_pair(plain, kernel, reps: int = 3, library=None):
    """(kernel ms, plain ms), warmed up, measured in turns plain, kernel,
    kernel, plain; with ``library``, (kernel ms, plain ms, library ms) in
    turns plain, kernel, library, library, kernel, plain."""
    fns = [plain, kernel] + ([library] if library else [])
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    ms = [0.0] * len(fns)
    for i in list(range(len(fns))) + list(reversed(range(len(fns)))):
        ms[i] += cuda_ms(fns[i], reps) / 2
    return (ms[1], ms[0], ms[2]) if library else (ms[1], ms[0])


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
    emit({"phase": "ptxas", "kernels": [
        k for k in _build.ptxas_report()
        if "grid_planes_kernelI" in k["function"]
        or "col_fft_k8_kernel" in k["function"]]})
    emit({"phase": "roofline", "card": card,
          "hbm_bytes_per_s": H100_SXM_HBM_BYTES_PER_S,
          "flop_per_s": H100_SXM_FLOP_PER_S,
          "peaks_of": "H100 SXM, NVIDIA data sheet, 700 W"})

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
    # K1 grids each chunk's first ``count`` slots: the planner's prefix
    # invariant, held on every chunk of the batch (its plain version
    # grids every valid slot, so a broken prefix also fails K1's parity).
    fused_gridder.check_valid_prefix(
        batch.valid, fused_gridder.valid_counts(batch.valid))

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
    count = fused_gridder.valid_counts(val)
    table = fused_gridder.conj_table(kern)
    occ = fused_gridder.occupancy(slot, n, nt2)
    shape = (2, 2, cfg.num_pols, ext2, ext2)
    kr, ki = (torch.empty(shape, device=dev) for _ in range(2))
    pr, pi = (torch.empty(shape, device=dev) for _ in range(2))

    def k1_kernel():
        fused_gridder.grid_planes(slot, n, count, iu, iv, su, sv, sre, sim,
                                  table, kr, ki, ts=ts)

    def k1_plain():
        fused_gridder.grid_planes_plain(slot, n, count, iu, iv, su, sv, sre,
                                        sim, table, pr, pi, ts=ts)

    rows = []

    def record(name, source, replaces, err, tol, ms, plain_ms, bnd,
               library_ms=None):
        ok = err <= tol
        emit({"phase": "kernel", "name": name, "max_abs_err": err,
              "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, **bnd, "card": card, "ok": ok})
        if not ok:
            raise AssertionError(f"{name}: error {err} > tolerance {tol}")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **bnd, "library_ms": library_ms})

    P = cfg.num_pols
    Mc = cfg.chunk_size
    n_valid = int(count[:n].sum())
    runs = int(occ.sum())
    window_bytes = runs * P * (2 * ts) ** 2 * 8       # re + im f32
    plane_bytes = P * N * N * 4                         # one f32 plane
    # K1's band product runs on the tensor cores in 3xTF32: three TF32
    # products for each of the 8 K^2 real operations of a visibility.
    k1_bound = bound(
        2 * n * 4 + n_valid * (4 * 4 + 2 * P * 4) + table.numel() * 8
        + window_bytes, tf32=3 * 8.0 * K * K * P * n_valid)
    emit({"phase": "kernel_detail", "name": "K1 work", "chunks": n,
          "slots": n * Mc, "valid_slots": n_valid,
          "valid_share": n_valid / (n * Mc), "runs": runs})
    ms, plain_ms = timed_pair(k1_plain, k1_kernel)
    written = occ.repeat_interleave(2 * ts, -2).repeat_interleave(
        2 * ts, -1)[:, :, None]                     # (2, 2, 1, ext2, ext2)
    scale = max(pr.abs().where(written, 0.0).max().item(),
                pi.abs().where(written, 0.0).max().item())
    err = max((kr - pr).abs().where(written, 0.0).max().item(),
              (ki - pi).abs().where(written, 0.0).max().item())
    record("K1 fused gridder", "katsdpimager_tpu_torch/csrc/gridder.cu",
           "katsdpimager_tpu/ops/pallas_gridder.py:118", err, 2e-5 * scale,
           ms, plain_ms, k1_bound)
    emit({"phase": "redesign", "name": "K1", "ms": ms,
          "replaced_design_ms_recorded": REPLACED_DESIGN_MS["K1"],
          "speedup_over_recorded": REPLACED_DESIGN_MS["K1"] / ms})

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
    # K2's accumulating form (the per-channel path's running grid), onto
    # the grid just made: bitwise equal to its plain version too.
    acc_k = fused_gridder.combine_planes(kr, ki, occ, pixels=N, ts=ts,
                                         out=(gr.clone(), gi.clone()))
    acc_p = fused_gridder.combine_planes_plain(kr, ki, occ, pixels=N, ts=ts,
                                               out=(gr.clone(), gi.clone()))
    same = all(torch.equal(a, b) for a, b in zip(acc_k, acc_p))
    emit({"phase": "kernel_detail", "name": "K2 accumulate",
          "bitwise_equal": same})
    if not same:
        raise AssertionError("K2's accumulating form is not bitwise equal "
                             "to its plain version")
    del acc_k, acc_p
    record("K2 colour combine", "katsdpimager_tpu_torch/csrc/gridder.cu",
           "katsdpimager_tpu/ops/pallas_gridder.py:570",
           max(max_err(gr, out["p"][0]), max_err(gi, out["p"][1])), 0.0,
           ms, plain_ms,
           bound(window_bytes + occ.numel() + 2 * plane_bytes))

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
           ms, plain_ms, bound(4 * plane_bytes, fp32=fft_flops(N, N * P)))

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
           1e-5 * img_p.abs().max().item(), ms, plain_ms,
           bound(4 * plane_bytes + N * 4, fp32=fft_flops(N, N * P)))
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
           ms, plain_ms,
           bound(3 * plane_bytes + N * 4, fp32=fft_flops(N, N * P)))

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
           ms, plain_ms, bound(4 * plane_bytes, fp32=fft_flops(N, N * P)))

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
    # Reads both grid planes and each valid slot's six taps, writes one
    # complex prediction per slot and polarization; K^2 complex MACs each.
    record("K5 fused degridder", "katsdpimager_tpu_torch/csrc/degrid.cu",
           "katsdpimager_tpu/ops/pallas_gridder.py:706",
           max_err(out["k"], out["p"]), 1e-5 * scale, ms, plain_ms,
           bound(2 * plane_bytes + n_valid * (6 * 4 + P * 8)
                 + dtab.numel() * dtab.element_size(),
                 fp32=8.0 * K * K * P * n_valid))
    del kr, ki, pr, pi, out, img_k, img_p, par, pai, ar, ai, gr, gi
    del pgr, pgi, model, dargs
    k8_phase(dev, record, rows, fused_fft)

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
    del batch
    probe_phase(dev, rows)
    imager_phase(dev, card, rows)

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
    by_name = {row["name"].split()[0]: row for row in rows}
    for name, count in zip(names, launches):
        by_name[name]["launches"] = count

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


def k8_phase(dev, record, rows, fused_fft) -> None:
    """K8 at (1, 4096, 4096), sign -1 and +1, against its plain version
    within 1e-6 of the largest output, timed in turns with it and with
    ``torch.fft.fft`` along dim -2 of the complex input (built outside
    the timed calls); then ``fft2`` (two K8 passes) against
    ``torch.fft.fft2``, with the K8 counter reset just before."""
    gen = torch.Generator().manual_seed(8)
    shape = (1, 4096, 4096)
    xr = torch.randn(shape, generator=gen).to(dev)
    xi = torch.randn(shape, generator=gen).to(dev)
    xc = torch.complex(xr, xi)
    B, N, M = shape
    k8_bound = bound(4 * B * N * M * 4, fp32=fft_flops(N, B * M))
    out = {}
    for sign in (-1, 1):
        ms, plain_ms, library_ms = timed_pair(
            lambda: out.__setitem__("p", fused_fft.col_fft_plain(xr, xi,
                                                                 sign)),
            lambda: out.__setitem__("k", fused_fft.col_fft(xr, xi, sign)),
            reps=50,
            library=(lambda: torch.fft.fft(xc, dim=-2)) if sign == -1
            else (lambda: torch.fft.ifft(xc, dim=-2, norm="forward")))
        (kr, ki), (pr, pi) = out["k"], out["p"]
        scale = max(pr.abs().max().item(), pi.abs().max().item())
        err = max(max_err(kr, pr), max_err(ki, pi))
        emit({"phase": "kernel_detail", "name": "K8", "sign": sign,
              "shape": list(shape), "max_abs_err": err,
              "err_over_max": err / scale, "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms,
              "no_slower_than_library": ms <= library_ms})
        if sign == -1:
            row = (err, 1e-6 * scale, ms, plain_ms, k8_bound, library_ms)
        elif not err <= 1e-6 * scale:
            raise AssertionError(f"K8 sign +1: error {err} > 1e-6 x {scale}")
    del out, kr, ki, pr, pi
    fused_fft.col_fft.launches = 0
    y = fused_fft.fft2(xc, -1)
    torch.cuda.synchronize()
    launches = fused_fft.col_fft.launches
    ms, plain_ms = timed_pair(lambda: torch.fft.fft2(xc),
                              lambda: fused_fft.fft2(xc, -1))
    ref = torch.fft.fft2(xc)
    err = (y - ref).abs().max().item() / ref.abs().max().item()
    emit({"phase": "fft2", "shape": list(shape), "err_over_max": err,
          "tolerance": 1e-5, "ms": ms, "torch_fft2_ms": plain_ms,
          "launches": launches})
    if not (err <= 1e-5 and launches == 2):
        raise AssertionError(f"fft2: error {err}, K8 launches {launches}")
    record("K8 column DFT", "katsdpimager_tpu_torch/csrc/fft.cu",
           "katsdpimager_tpu/ops/pallas_fft.py:126", *row)
    rows[-1]["launches"] = launches
    emit({"phase": "redesign", "name": "K8", "ms": row[2],
          "replaced_design_ms_recorded": REPLACED_DESIGN_MS["K8"],
          "library_ms": row[5]})


def probe_phase(dev, rows) -> None:
    """P1 (A, B, C) and P2 (E, F): the probes' own entry, with their
    counters reset just before; A, B, E and F exactly 0, C in FP32 within
    1e-6 relative of a float64 product, C in TF32 printed.  Then every
    probe kernel against its plain version on the same inputs, and their
    times."""
    from katsdpimager_tpu_torch import probes

    for fn in probes.P1 + probes.P2:
        fn.launches = 0
    errs = probes.run(dev)
    torch.cuda.synchronize()
    launches = {"P1": sum(fn.launches for fn in probes.P1),
                "P2": sum(fn.launches for fn in probes.P2)}
    exact = ("A", "B", "E", "F_hi", "F_mid", "F_lo")
    ok = (all(errs[k] == 0.0 for k in exact)
          and errs["C_stacked"] <= 1e-6 and errs["C_separate"] <= 1e-6)
    emit({"phase": "probe", "rel_err": errs, "exact_must_be_0": exact,
          "c_fp32_tolerance": 1e-6, "launches": launches, "ok": ok})
    if not ok or min(launches.values()) <= 0:
        raise AssertionError(f"probes failed: {errs}, launches {launches}")

    # Kernel against plain on the same inputs: the selections and the
    # recombine exactly; the FP32 dot within 2e-6 of its largest value
    # (two f32 sums of 256 products in other orders); the TF32 dot within
    # 1e-4 (tensor cores accumulate in their own order and rounding).
    d = probes.inputs(dev)
    tol = {"C_stacked": 2e-6, "C_separate": 2e-6, "C_tf32": 1e-4}
    for probe, replaces in (("P1", "scripts/mosaic_num_probe.py:64"),
                            ("P2", "scripts/mosaic_num_probe2.py:90")):
        worst, worst_tol = 0.0, 0.0
        group = [c for c in probes.cases(d) if c[1] == probe]
        for name, _, kernel, plain in group:
            got, want = kernel(), plain()
            err = max_err(got, want)
            t = tol.get(name, 0.0) * want.abs().max().item()
            emit({"phase": "kernel_detail", "name": f"{probe} {name}",
                  "max_abs_err": err, "tolerance": t})
            if not err <= t:
                raise AssertionError(f"{probe} {name}: {err} > {t}")
            if err - t >= worst - worst_tol:
                worst, worst_tol = err, t
        ms, plain_ms = timed_pair(lambda: [c[3]() for c in group],
                                  lambda: [c[2]() for c in group], reps=10)
        # Bytes: the group's distinct inputs read once, every output
        # written once.  Operations: each probe's dot on the unit that
        # runs it, 2 x its contracted length per output (the selections
        # are one-hot products over the W table rows, A over all three
        # bf16 thirds; E has no dot).
        used = ("idx", "tab", "table", "av", "bu", "a", "b", "c", "d") \
            if probe == "P1" else ("idx", "tab")
        outs = {name: plain() for name, _, _, plain in group}
        mk, w = d["av"].shape[0], d["table"].shape[0]
        dots = {"A": ("bf16", 3 * w), "F": ("bf16", w), "B": ("fp32", w),
                "C_stacked": ("fp32", mk), "C_separate": ("fp32", mk),
                "C_tf32": ("tf32", mk)}
        ops = {}
        for name, o in outs.items():
            if name in dots:
                unit, length = dots[name]
                ops[unit] = ops.get(unit, 0.0) + 2.0 * length * o.numel()
        bnd = bound(sum(d[k].numel() * d[k].element_size() for k in used)
                    + sum(o.numel() * o.element_size() for o in outs.values()),
                    **ops)
        emit({"phase": "kernel", "name": probe, "max_abs_err": worst,
              "tolerance": worst_tol, "ms": ms, "plain_ms": plain_ms,
              **bnd, "ok": True})
        rows.append({"name": f"{probe} f32-exactness probes", "route": "cuda",
                     "source": "katsdpimager_tpu_torch/csrc/probe.cu",
                     "replaces": replaces, "launches": launches[probe],
                     "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                     **bnd, "library_ms": None})


def sim_dataset(num_antennas: int, num_dumps: int, num_channels: int,
                noise_jy: float, seed: int = 1):
    """An in-memory dataset, which needs no h5py: the port's simulator
    (``simulate.random_array`` within 4 km,
    ``simulate_vis`` of ``DEFAULT_SOURCES`` over hour angles +-0.5 rad)
    behind a small ``loader_core.LoaderBase``."""
    import math

    import numpy as np

    from katsdpimager_tpu_torch import loader_core, polarization, simulate

    ants = simulate.random_array(num_antennas, 4000.0, seed=seed)
    # 909.5 and 1016.5 MHz for two channels.  Their 11 and 10 W slices keep
    # the default --w-step within the preprocessor's 1024 W planes per
    # slice; from 1070 MHz on, 9 slices need 1093.
    freqs = 856e6 + 107e6 * (np.arange(num_channels) + 0.5)
    uvw, vis = simulate.simulate_vis(
        ants, math.radians(-30.7), simulate.DEFAULT_PHASE_CENTRE, freqs,
        simulate.DEFAULT_SOURCES, np.linspace(-0.5, 0.5, num_dumps),
        noise_jy=noise_jy, seed=seed + 1)
    longest = float(np.linalg.norm(uvw, axis=1).max() * 1.01)

    class SimDataset(loader_core.LoaderBase):
        def __init__(self):
            super().__init__("simulated", [])

        def antenna_diameter(self):
            return 13.5

        def longest_baseline(self):
            return longest

        def num_channels(self):
            return num_channels

        def frequency(self, channel):
            return float(freqs[channel])

        def band(self):
            return "L"

        def phase_centre(self):
            return simulate.DEFAULT_PHASE_CENTRE

        def polarizations(self):
            return [polarization.STOKES_XX, polarization.STOKES_XY,
                    polarization.STOKES_YX, polarization.STOKES_YY]

        def data_iter(self, start_channel, stop_channel, max_chunk_vis=None):
            total = len(uvw)
            nc = stop_channel - start_channel
            step = (total if max_chunk_vis is None
                    else max(1, max_chunk_vis // max(nc, 1)))
            for s in range(0, total, step):
                e = min(total, s + step)
                v = vis[start_channel:stop_channel, s:e]
                yield {"uvw": uvw[s:e], "vis": v,
                       "weights": np.ones(v.shape, np.float32),
                       "progress": e, "total": total}

    return SimDataset(), len(uvw)


def truth_peaks(image_p, beam, image):
    """test_e2e's flux check: at each default source, the restored image's
    5 x 5 maximum over the truth's (the sources' I fluxes convolved with
    the fitted beam, evaluated at their fractional positions)."""
    import numpy as np

    from katsdpimager_tpu_torch import simulate

    N = image_p.pixels
    cs = beam.covariance_sqrt()
    icov = np.linalg.inv(cs @ cs.T)
    ra0, dec0 = simulate.DEFAULT_PHASE_CENTRE
    pos = []
    for src in simulate.DEFAULT_SOURCES:
        l, m, _ = simulate.lmn(np.array([src.ra]), np.array([src.dec]),
                               ra0, dec0)
        pos.append((N // 2 + m[0] / image_p.pixel_size,
                    N // 2 + l[0] / image_p.pixel_size))
    out = []
    for (py, px) in pos:
        iy, ix = int(round(py)), int(round(px))
        yy, xx = np.mgrid[iy - 2:iy + 3, ix - 2:ix + 3].astype(np.float64)
        truth = np.zeros(yy.shape)
        for src, (sy, sx) in zip(simulate.DEFAULT_SOURCES, pos):
            dy, dx = yy - sy, xx - sx
            truth += src.flux_iquv[0] * np.exp(
                -0.5 * (icov[0, 0] * dy ** 2 + 2 * icov[0, 1] * dy * dx
                        + icov[1, 1] * dx ** 2))
        got = float(image[0, iy - 2:iy + 3, ix - 2:ix + 3].max())
        out.append((got, float(truth.max())))
    return out


def imager_phase(dev, card, rows) -> None:
    """The per-channel CLI path (``frontend.run``) at full width on a
    simulated 2-channel L-band observation with noise: channel 0 with the
    default DFT-predict major cycle, channel 1 with ``--degrid``.  Each
    run resets the kernel counters just before and checks them against
    the slice, block and major counts; the restored fluxes against the
    truth; and the images against the same run on the all-plain path."""
    import math

    import numpy as np

    from katsdpimager_tpu_torch import frontend, imaging
    from katsdpimager_tpu_torch.ops import (fused_degrid, fused_fft,
                                            fused_gridder)

    num_antennas, num_dumps, vis_block = 64, 1024, 1 << 17
    t0 = time.perf_counter()
    dataset, num_rows = sim_dataset(num_antennas, num_dumps, 2, noise_jy=1.0)
    emit({"phase": "imager_data", "seconds": time.perf_counter() - t0,
          "antennas": num_antennas, "dumps": num_dumps,
          "rows_per_channel": num_rows,
          "frequencies_hz": [dataset.frequency(c) for c in range(2)]})
    counters = (fused_gridder.grid_planes, fused_gridder.combine_planes,
                fused_fft.cb_col_fft, fused_fft.epi_col_fft,
                fused_degrid.degrid_planes, fused_fft.pre_col_fft,
                fused_fft.cbout_col_fft)
    names = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")

    def run(channel, degrid, plain):
        args = imager_args(channel, degrid, vis_block)
        cap = {"clean_s": 0.0}

        class Capture(frontend.Writer):
            def needs_fits_image(self, name):
                return name in ("dirty", "model", "residuals", "clean")

            def needs_fits_grid(self, name):
                return False

            def write_fits_image(self, name, description, ds, image, ip,
                                 ch, beam=None, bunit=None):
                cap[name] = np.array(image)

            def write_fits_grid(self, *args, **kwargs):
                pass

            def statistics(self, ds, ch, **kwargs):
                cap["stats"] = kwargs

        # Wrap the collector (for the slice lengths the counts follow) and
        # the CLEAN cycles (host clock, synchronised, for CLEAN's share).
        pre, cycles = frontend.preprocess_visibilities, \
            imaging.Imaging.clean_cycles

        def capture_pre(*a, **k):
            cap["collector"] = pre(*a, **k)
            return cap["collector"]

        def timed_cycles(self, *a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = cycles(self, *a)
            cap["clean_s"] += time.perf_counter() - t
            return result

        frontend.preprocess_visibilities = capture_pre
        imaging.Imaging.clean_cycles = timed_cycles
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        t = time.perf_counter()
        try:
            frontend.run(args, dataset, Capture(), device=dev, plain=plain)
            torch.cuda.synchronize()
        finally:
            frontend.preprocess_visibilities = pre
            imaging.Imaging.clean_cycles = cycles
        cap["seconds"] = time.perf_counter() - t
        cap["launches"] = [fn.launches for fn in counters]
        reader = cap.pop("collector").reader()
        lens = [reader.len(0, s) for s in range(reader.num_w_slices(0))]
        cap["blocks"] = sum(-(-n // vis_block) for n in lens)
        cap["nonempty"] = sum(n > 0 for n in lens)
        return cap

    for channel, degrid in ((0, False), (1, True)):
        got = run(channel, degrid, plain=False)
        stats = got["stats"]
        major = stats["major"]
        passes = 1 + major
        degrids = major - 1 if degrid else 0
        want = [passes * got["blocks"]] * 2 + [passes * got["nonempty"]] * 2 \
            + [degrids * got["blocks"]] + [degrids * got["nonempty"]] * 2
        peaks = truth_peaks(stats["image_parameters"],
                            stats["restoring_beam"], got["clean"])
        flux_ok = all(math.isclose(g, t, rel_tol=0.1) for g, t in peaks)
        emit({"phase": "imager", "card": card, "channel": channel,
              "major_cycle": "degrid" if degrid else "DFT predict",
              "seconds": got["seconds"], "clean_s": got["clean_s"],
              "compressed_vis": stats["compressed_vis"],
              "minor": stats["minor"], "major": major,
              "peak": stats["peak"], "totals": stats["totals"],
              "noise": stats["noise"],
              "psf_patch": list(stats["psf_patch_size"]),
              "w_slices": stats["grid_parameters"].w_slices,
              "nonempty_slices": got["nonempty"], "blocks": got["blocks"],
              "launches": dict(zip(names, got["launches"])),
              "expected_launches": dict(zip(names, want)),
              "restored_vs_truth": peaks, "flux_within_10pct": flux_ok})
        if got["launches"] != want or not flux_ok:
            raise AssertionError(f"imager channel {channel}: launches "
                                 f"{got['launches']} (expected {want}), "
                                 f"fluxes {peaks}")
        by_name = {row["name"].split()[0]: row for row in rows}
        for name, count in zip(names, got["launches"]):
            by_name[name].setdefault("imager_launches", []).append(count)

        imager_parity(channel, got, run(channel, degrid, plain=True))

    imager_profile(dev, dataset, vis_block)


def imager_args(channel: int, degrid: bool, vis_block: int):
    """The CLI's arguments for one channel of the simulated observation
    at full width (the default W spacing)."""
    from katsdpimager_tpu_torch import arguments
    from katsdpimager_tpu_torch import imager

    argv = ["simulated", "unused_%c.fits", "--pixels", "4096",
            "--kernel-width", "60", "--stokes", "I", "--major", "2",
            "--no-tmp-file", "--vis-block", str(vis_block),
            "-c", str(channel), "-C", str(channel + 1)]
    return imager.get_parser().parse_args(
        argv + (["--degrid"] if degrid else []),
        namespace=arguments.SmartNamespace())


def device_busy_ms(prof) -> tuple:
    """(busy ms, ms by kernel name) of a ``torch.profiler`` run: the union
    of the device's kernel, copy and memset intervals in its trace.  The
    profiler also shows each ``record_function`` range on the device
    (``gpu_user_annotation``); those are not device work and are left
    out."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans, by_name = [], {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in ("kernel", "gpu_memcpy",
                                                     "gpu_memset"):
            spans.append((ev["ts"], ev["ts"] + ev["dur"]))
            name = ev["name"][:60]
            by_name[name] = by_name.get(name, 0.0) + ev["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy / 1e3, by_name


def imager_profile(dev, dataset, vis_block: int) -> None:
    """Where a per-channel run's time goes, for channel 0 (DFT predict)
    and channel 1 (``--degrid``), warm, writing only the restored image
    (as the CLI does by default).  Three runs of each: one plain, on the
    host clock; one with each stage wrapped in a synchronize on both sides
    (host seconds by stage, inclusive); one under ``torch.profiler``, for
    the device's busy time.  The idle share is one less the busy time over
    the plain run's seconds."""
    import functools

    from katsdpimager_tpu_torch import frontend, imaging
    from katsdpimager_tpu_torch.ops import beam

    stages = [(imaging.Imaging, name) for name in (
        "__init__", "_slice_plan", "grid_slice", "grid_to_image",
        "degrid_slice", "model_to_grid", "model_to_predict", "model_predict",
        "psf_patch", "extract_psf_core", "noise_est", "clean_reset",
        "clean_cycles", "clean_finish", "get_buffer", "finalize_weights",
        "scale_dirty", "convolve_model_with_beam")]
    stages += [(frontend, "preprocess_visibilities"), (beam, "fit_beam")]
    nested = {"_slice_plan"}          # inside grid_slice and degrid_slice
    seconds, calls = {}, {}

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
                calls[name] = calls.get(name, 0) + 1
        return wrapper

    class CleanOnly(frontend.Writer):
        def needs_fits_image(self, name):
            return name == "clean"

        def needs_fits_grid(self, name):
            return False

        def write_fits_image(self, *args, **kwargs):
            pass

        def write_fits_grid(self, *args, **kwargs):
            pass

    def run(args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        frontend.run(args, dataset, CleanOnly(), device=dev)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    for channel, degrid in ((0, False), (1, True)):
        args = imager_args(channel, degrid, vis_block)
        wall = run(args)
        seconds.clear()
        calls.clear()
        originals = [(owner, name, getattr(owner, name))
                     for owner, name in stages]
        for owner, name, fn in originals:
            setattr(owner, name, timed(name, fn))
        try:
            staged = run(args)
        finally:
            for owner, name, fn in originals:
                setattr(owner, name, fn)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            profiled = run(args)
        busy_ms, by_name = device_busy_ms(prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        outer = sum(v for k, v in seconds.items() if k not in nested)
        emit({"phase": "imager_profile", "channel": channel,
              "major_cycle": "degrid" if degrid else "DFT predict",
              "seconds": wall, "staged_seconds": staged,
              "stage_s": dict(sorted(seconds.items(), key=lambda kv: -kv[1])),
              "stage_calls": calls,
              "outside_stages_s": staged - outer,
              "profiled_seconds": profiled, "device_busy_ms": busy_ms,
              "idle_share": 1 - busy_ms / 1e3 / wall,
              "top_device_ms": top})
        if not busy_ms > 0:
            raise AssertionError("the profiler saw no device work")


def imager_parity(channel, got, ref) -> None:
    """The kernels' run against the all-plain run of the same channel:
    images within 1e-4 of the dirty peak inside the anti-aliased field
    (taper^2 >= 0.2% of its peak) and the same CLEAN component positions
    there; the minor-count difference is printed."""
    import numpy as np

    from katsdpimager_tpu_torch.ops import wkernel

    ip, gp = got["stats"]["image_parameters"], got["stats"]["grid_parameters"]
    taper = wkernel.taper(ip.pixels, gp.fixed.antialias_width,
                          gp.fixed.oversample,
                          wkernel.default_beta(gp.fixed.antialias_width))
    t2 = np.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    dirty_peak = float(np.abs(ref["dirty"]).max())
    errs = {name: float(np.abs(got[name] - ref[name])[:, inside].max())
            / dirty_peak for name in ("dirty", "model", "residuals", "clean")}
    same = bool(np.array_equal((got["model"] != 0)[:, inside],
                               (ref["model"] != 0)[:, inside]))
    minor = [got["stats"]["minor"], ref["stats"]["minor"]]
    finite = all(np.isfinite(x[name]).all() for x in (got, ref)
                 for name in ("dirty", "model", "residuals", "clean"))
    ok = max(errs.values()) <= 1e-4 and same and finite and dirty_peak > 0
    emit({"phase": "imager_parity", "channel": channel,
          "max_err_inside_over_dirty_peak": errs, "tolerance": 1e-4,
          "dirty_peak": dirty_peak,
          "components_inside": int((got["model"] != 0)[:, inside].sum()),
          "same_component_positions_inside": same, "finite": finite,
          "minor": minor, "minor_difference": minor[0] - minor[1],
          "plain_seconds": ref["seconds"], "ok": ok})
    if not ok:
        raise AssertionError(f"imager parity failed on channel {channel}")


if __name__ == "__main__":
    main()
