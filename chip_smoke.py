"""Drive the PyTorch/CUDA port on one GPU: its kernels, the dirty-image
step, the cube wave, the numerics probes, the per-channel CLI, the batch
pipeline, K1 at every tile size and on long anchor runs, the exact
predict, the float64 routes, the profile dumps and the mesh (ranks
sharing the card).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

(``chip_smoke.py --rank-worker ...`` is one rank of the ``distributed``
phase, which starts it through ``torchrun`` and with ``--coordinator``.)

It builds the port's CUDA kernels (K1-K8, K23 and the probes P1/P2) from
``katsdpimager_tpu_torch/csrc`` and the production batch (8 channels,
4096 px, K=60, oversample 8, 32 W planes, 4 W slices, 2^19 visibilities
per slice, natural weights), then:

- prints what ``ptxas -v`` reported for K1, K3, K4, K5 (its instance for
  the production K), K6, K7, K8 and K23 (registers, spills, stack frame,
  shared memory), and K1's accumulation schedule with its instances'
  registers (one ``ptxas`` count shared by the CTA's producer and
  consumer threads) and, at the production slice, the items and batches
  its workers report taking in a launch of their own (``K1 work``, also
  on ``k1_accumulation``);
- checks every kernel against its plain PyTorch version at the shapes of
  the main paths (channel 0, slice 0; K8 at (1, 4096, 4096)) and times
  both, and the column DFTs (K3, K4, K6, K7, K8) also against
  ``torch.fft.ifft`` or ``torch.fft.fft`` along dim -2, in turns;
  computes each kernel's roofline bound from its inputs (H100 SXM peaks);
  ``fft2`` (two K8 passes) against ``torch.fft.fft2``; K23 bitwise K3 on
  K2's grid, and (``k23_turns``) at the production batch's four slices
  of channel 0, P = 1 and 4, with NaN in the unwritten colour-plane
  blocks: bitwise again, and 20 launches of each in turns against K2
  then K3, with its byte bound from the occupied blocks;
- ``k4_slices``: K4 taking a channel's slices (``cfg.w_slices``, P = 1
  and 4) in one launch against one launch a slice, bitwise, and 20 of
  each in turns, with the byte bound a channel of each; where an
  uncommitted copy of the parent's ``csrc/fft.cu`` lies at
  :data:`PARENT_FFT_SOURCE`, one slice against the parent's K4, bitwise
  and in turns;
- runs the 8-channel dirty-image step through
  ``multichannel.single_channel_step`` (1 warm-up, 3 timed iterations)
  with the launch counters reset just before (K1 and K23 once a
  non-empty slice, K4 once a channel, taking every non-empty slice, K2
  and K3 never), and checks channel 0's
  dirty image against the all-plain step; then profiles one more step
  (the device's busy time and idle share, the top kernels by device
  time, and the host's seconds to enqueue it);
- checks the weight grid's kernel (``csrc/weights.cu``) on channel 0:
  within 1e-6 of each cell of its plain version, bitwise the float32
  serial fold and a second launch, timed against its plain version and
  ``index_put_`` over every slot (padding to cells of its own); then
  runs the 8-channel step under uniform weights, with the kernel's
  launch counter reset just before (one launch a channel), and checks
  channel 0 against the all-plain uniform step;
- runs the dirty step and a cube wave at 1000 px (no power of two: the
  grid <-> image transforms take ``torch.fft`` by rule, K3 and K23 never
  launch) against their all-plain runs;
- adds 5 bright point sources to the batch (predicted through the degrid
  path) and runs the 8-channel cube wave once at full width
  (``cube.wave_image``: weights, PSF, 2 major cycles of grid, FFT, CLEAN
  and degrid-subtract; then the beam fit and ``cube.wave_restore``), with
  the counters reset just before, and checks its launch counts; then
  profiles one more wave (the device's busy time, idle share and K5's
  share of the busy time);
- checks K5 against its plain version on the grid of the wave's own
  channel-0 model, within the f32 bound of its sums;
- checks channel 0's wave against the all-plain wave, as configured
  (border 0) and again with CLEAN's interior kept inside the field;
- runs the probes P1 (A, B, C) and P2 (E, F) on the tensor cores: the
  selections and the recombine exact, the 3xTF32 band dot (stacked, and
  the four blocks in one launch) within 1e-6, the one-pass TF32 dot above
  1e-5; each kernel's device microseconds under ``torch.profiler``;
- runs the per-channel CLI path (``frontend.run``) on a simulated
  64-antenna, 1024-dump, 2-channel L-band observation with noise (in
  memory: the card's machine has no h5py, so ``--no-tmp-file``) at
  4096 px, K=60, 2 majors: channel 0 with the DFT-predict major cycle,
  channel 1 with ``--degrid``; checks the K1-K7 launch counts against the
  slice, block and major counts, the restored fluxes against the truth,
  and each channel against the all-plain run;
- profiles both channels: host seconds by stage, and the device's busy
  time and idle share under ``torch.profiler``;
- runs the batch pipeline (``pipeline.run`` with ``--cube``, one channel
  per wave) on the same observation at the same width, with
  ``--primary-beam meerkat`` and ``--subtract`` of the 1.5 Jy off-centre
  source: both channels complete, the subtracted source gone, the
  centre source within 10%, the restored images against the all-plain
  run, K1-K7 launch counts against slices x passes, a rerun that skips
  both waves; each wave's host, blocked and device seconds, and the
  device's busy time and idle share of one profiled wave;
- ``tiles``: K1 and K2 against their plain versions at ts 8, 16, 33, 50,
  96, 128 and 256, each with K = ts + 1 (K <= 256) and a smaller K, on
  direct inputs at 2048 px (K1 within 2e-5 of the largest written value
  and within 1e-6 of the peak of a float64 run of its plain version, K2
  bitwise), with times, bounds and shares; then the paths that take
  those tile sizes against their all-plain runs inside the field: the
  CLI at 400 px, K = 16 (ts 50) and at 4096 px, K = 96 (ts 96), both
  ``--degrid`` on channel 1, and ``pipeline --cube`` at 4096 px, K = 96
  (ts 128), one channel and one major (cut from 2; ``--w-step 2`` at
  K = 96, where the default needs more than 1024 W planes per slice);
- ``exact``: channel 0 with ``KTPU_PREDICT_EXACT=1`` against the default
  route (restored images, components) and both routes' ``model_predict``
  seconds;
- ``double``: channel 1 (``--degrid``) at ``--precision double`` against
  its float32 run: float64, finite, within the 1e-4 gate inside the
  field with the same components, K1 and K5 launched;
- ``profile``: channel 0 through ``imager.run`` with ``--write-profile``
  and ``--write-device-profile``: the frontend's stages named, K1-K4 with
  nonzero device time, the five largest device ops;
- ``k1_long_runs`` (right after K1's row, which also holds K1 at the
  production slice to 1e-6 of the peak of a float64 run of its plain
  version): K1 at ts 64, K 60 and ts 32, K 30 on anchor runs of 4, 32 and
  128 full chunks, within 1e-6 of the peak of a float64 run of its plain
  version; K1's production time, and on 128-chunk runs, in turns against
  the parent's kernel where an uncommitted copy of it lies at
  :data:`PARENT_K1_SOURCE` (``tiles`` times every case against it too,
  and ``k1_parent_bitwise`` holds K1 bitwise equal to it at the
  production slice, the long runs and every ``tiles`` case);
- ``cube_double``: ``pipeline --cube --precision double`` on channel 0 at
  4096 px, K 60, 2 majors against its float32 run (the dirty image within
  1e-4 of the dirty peak inside the field, the same components);
- ``k1_image`` (after ``step_parity``): channel 0 of the step imaged at
  float64 throughout (K1's plain version at float64) against the float32
  step and the double route (K1's float32 planes), and with the parent's
  K1 where its copy was built (printed);
- ``device_plan`` (after ``route``): the device chunk planner at the
  production slice, bitwise equal to the host planner's plan, K1 + K2
  planes from both plans bitwise equal, the drop past ``nc``; the device
  planner's, host planner's and plan upload's times;
- ``distributed``: ``pipeline --cube`` on 2 ranks sharing the card
  (``torchrun``, gloo) at (chan 2, vis 1) and (chan 1, vis 2) against the
  1-rank run, (chan 2, vis 1) again in the ``--coordinator`` form (the
  host layout through the rendezvous store, bitwise the ``torchrun``
  run), and the bench-shape step at vis 2 against the unsharded step;
  seconds a channel and all-reduce seconds.

Each phase prints one JSON line; the card's name and power limit, the
kernel table and, last, the ``ok`` line follow.  Any failure raises: the
exit code is then non-zero.

It imports no JAX.
"""

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import torch

from katsdpimager_tpu_torch.device import plain_versions


def versions(plain: bool):
    """A block in which every kernel wrapper runs its plain version where
    ``plain`` (the all-plain reference), else one that changes nothing."""
    return plain_versions() if plain else contextlib.nullcontext()


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at its
# 700 W limit): the least time a kernel could take is the larger of its
# bytes (each input read once, each output written once) over the memory
# rate and its operations over the rate of the unit that does them: FP32
# outside the tensor cores, TF32 or bf16 on them.
H100_SXM_HBM_BYTES_PER_S = 3.35e12
H100_SXM_FLOP_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}

#: Times of the designs that K1, K8, K3, K4, K6, K7, K5 and the probes P1
#: and P2 (each group of its wrappers, host time included) replace, on
#: "NVIDIA H100 80GB HBM3, 700.00 W", as PERF.md records them (the kernel
#: table's earlier designs).
REPLACED_DESIGN_MS = {"K1": 5.204, "K8": (0.854, 0.901), "K3": 0.608,
                      "K4": 0.938, "K6": (0.610, 0.675), "K7": (0.894, 0.980),
                      "K5": (6.45, 6.47), "P1": (0.317, 0.429),
                      "P2": (0.072, 0.092)}


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


def k23_present(occ, pixels: int, ts: int) -> int:
    """The colour-plane values K2 and K23 read for each polarization: for
    each plane (a, b), the pixels of the N x N grid that its occupied
    blocks cover (the plane placed at (a ts, b ts), as K2 places it)."""
    total = 0
    for a in range(2):
        for b in range(2):
            m = occ[a, b].repeat_interleave(2 * ts, 0).repeat_interleave(
                2 * ts, 1)
            total += int(m[:pixels - a * ts, :pixels - b * ts].sum())
    return total


def k23_bound(occ, pixels: int, ts: int, P: int) -> dict:
    """K23's :func:`bound`: the occupied blocks' values in the grid (8 B
    each, re + im) and the occupancy bytes read once, the transposed
    (P, N, N) pair written once; the column DFTs' flops."""
    return bound(8 * P * k23_present(occ, pixels, ts) + occ.numel()
                 + 8 * P * pixels * pixels,
                 fp32=fft_flops(pixels, pixels * P))


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


def redesign_line(name: str, ms: float, library_ms=None) -> None:
    """A redesigned kernel's time against the design it replaced (as
    PERF.md records it; the least of a recorded range) and, where there
    is one, against its library call in this run."""
    old = REPLACED_DESIGN_MS[name]
    line = {"phase": "redesign", "name": name, "ms": ms,
            "replaced_design_ms_recorded": old,
            "speedup_over_recorded": min(old if isinstance(old, tuple)
                                         else (old,)) / ms}
    if library_ms is not None:
        line.update(library_ms=library_ms,
                    no_slower_than_library=ms <= library_ms)
    emit(line)


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
    parent_build = start_parent_build(PARENT_K1_SOURCE)
    parent_fft_build = start_parent_build(PARENT_FFT_SOURCE)
    _build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": _build.lib_path()})
    cfg = bench_config()
    # K5 is built for 1-16 taps per lane (ceil(K / 16)); the production K
    # runs one instance.
    k5_instance = "degrid_planes_kernelILi%dE" % (
        (cfg.kernel_width + 15) // 16)
    emit({"phase": "ptxas", "kernels": [
        k for k in _build.ptxas_report()
        if any(name in k["function"] for name in (
            "18grid_planes_kernelI", "col_fft_k8_kernel",
            "cb_col_fft_kernel", "epi_col_fft_kernel", "pre_col_fft_kernel",
            "cbout_col_fft_kernel", "combine_cb_col_fft_kernel",
            k5_instance))]})
    emit({"phase": "roofline", "card": card,
          "hbm_bytes_per_s": H100_SXM_HBM_BYTES_PER_S,
          "flop_per_s": H100_SXM_FLOP_PER_S,
          "peaks_of": "H100 SXM, NVIDIA data sheet, 700 W"})

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
               library_ms=None, library=None, extra=None, extra_ok=True,
               detail=None):
        ok = err <= tol and extra_ok
        emit({"phase": "kernel", "name": name, "max_abs_err": err,
              "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "library": library, **bnd,
              **(extra or {}), **(detail or {}), "card": card, "ok": ok})
        if not ok:
            raise AssertionError(f"{name}: error {err} > tolerance {tol} "
                                 f"or {extra}")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     **bnd, "library_ms": library_ms, **(extra or {})})

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
    k1_args = (slot, n, count, iu, iv, su, sv, sre, sim, table)
    work = k1_work(k1_args, kr.shape, ts, runs)
    emit({"phase": "kernel_detail", "name": "K1 work", "chunks": n,
          "slots": n * Mc, "valid_slots": n_valid,
          "valid_share": n_valid / (n * Mc), "runs": runs, **work})
    if not work["ok"]:
        raise AssertionError(f"K1's workers took other work: {work}")
    ms, plain_ms = timed_pair(k1_plain, k1_kernel)
    written = occ.repeat_interleave(2 * ts, -2).repeat_interleave(
        2 * ts, -1)[:, :, None]                     # (2, 2, 1, ext2, ext2)
    scale = max(pr.abs().where(written, 0.0).max().item(),
                pi.abs().where(written, 0.0).max().item())
    err = max((kr - pr).abs().where(written, 0.0).max().item(),
              (ki - pi).abs().where(written, 0.0).max().item())
    vs64 = k1_vs_float64(k1_args, ts, written, kernel=(kr, ki),
                         plain=(pr, pi))
    record("K1 fused gridder", "katsdpimager_tpu_torch/csrc/gridder.cu",
           "katsdpimager_tpu/ops/pallas_gridder.py:118", err, 2e-5 * scale,
           ms, plain_ms, k1_bound,
           extra={"err_vs_float64_over_peak": vs64,
                  "float64_tolerance": K1_FLOAT64_TOL},
           extra_ok=vs64["kernel"] <= K1_FLOAT64_TOL,
           detail={"work_items": work["work_items"],
                   "registers_every_thread":
                       k1_ptxas(_build, ts)["registers"]})
    redesign_line("K1", ms)
    emit({"phase": "kernel_detail", "name": "K1 runs",
          **run_lengths(slot, n, count)})
    k1_accumulation_line(_build, fused_gridder, work)
    parent = parent_k1(parent_build)
    k1_bitwise("production", parent, k1_args, kr.shape, ts)
    k1_long_runs_phase(dev, card, (k1_args, kr, ki, ts), parent)

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

    # The column DFTs' library call: torch.fft along dim -2 of a complex
    # (P, N, N) plane built outside the timed call, the DFT alone
    # (without the checkerboard, transpose, prologue or epilogue).
    inverse_dft = "torch.fft.ifft(x, dim=-2, norm='forward'), the DFT alone"
    forward_dft = "torch.fft.fft(x, dim=-2), the DFT alone"

    def k3_kernel():
        out["k"] = fused_fft.cb_col_fft(gr, gi)

    def k3_plain():
        out["p"] = fused_fft.cb_col_fft_plain(gr, gi)

    xc = torch.complex(gr, gi)
    ms, plain_ms, library_ms = timed_pair(
        k3_plain, k3_kernel, reps=20,
        library=lambda: torch.fft.ifft(xc, dim=-2, norm="forward"))
    (ar, ai), (par, pai) = out["k"], out["p"]
    scale = max(par.abs().max().item(), pai.abs().max().item())
    record("K3 checkerboard column DFT",
           "katsdpimager_tpu_torch/csrc/fft.cu",
           "katsdpimager_tpu/ops/pallas_fft.py:204",
           max(max_err(ar, par), max_err(ai, pai)), 1e-5 * scale,
           ms, plain_ms, bound(4 * plane_bytes, fp32=fft_flops(N, N * P)),
           library_ms, inverse_dft)
    redesign_line("K3", ms, library_ms)

    # K23, the slice loop's route: bitwise K3 on K2's grid (ar, ai), its
    # plain version within 1e-5 of the peak.  It reads the colour planes'
    # values that land in the grid from occupied blocks, once.
    def k23_kernel():
        out["k"] = fused_fft.combine_cb_col_fft(kr, ki, occ, pixels=N, ts=ts)

    def k23_plain():
        out["p"] = fused_fft.combine_cb_col_fft_plain(kr, ki, occ, pixels=N,
                                                      ts=ts)

    ms, plain_ms = timed_pair(k23_plain, k23_kernel, reps=20)
    (yr, yi), (pyr, pyi) = out["k"], out["p"]
    scale = max(pyr.abs().max().item(), pyi.abs().max().item())
    plain_err = max(max_err(yr, pyr), max_err(yi, pyi))
    record("K23 colour combine + checkerboard column DFT",
           "katsdpimager_tpu_torch/csrc/fft.cu",
           "katsdpimager_tpu/ops/pallas_gridder.py:570 + "
           "katsdpimager_tpu/ops/pallas_fft.py:204",
           max(max_err(yr, ar), max_err(yi, ai)), 0.0, ms, plain_ms,
           k23_bound(occ, N, ts, P),
           extra={"bitwise_k3_on_k2": bool(
               torch.equal(yr.view(torch.int32), ar.view(torch.int32))
               and torch.equal(yi.view(torch.int32), ai.view(torch.int32))),
               "plain_max_err": plain_err, "plain_tolerance": 1e-5 * scale},
           extra_ok=plain_err <= 1e-5 * scale)
    del yr, yi, pyr, pyi

    taper = batch.taper1d[0]
    scal = fused_fft.scalars(batch.mid_w[0, 0], batch.pixel_size[0], dev)
    img_k = torch.zeros((cfg.num_pols, N, N), device=dev)
    img_p = torch.zeros_like(img_k)
    xc = torch.complex(par, pai)
    ms, plain_ms, library_ms = timed_pair(
        lambda: fused_fft.epi_col_fft_plain(par, pai, img_p, taper, scal),
        lambda: fused_fft.epi_col_fft(par, pai, img_k, taper, scal),
        reps=20, library=lambda: torch.fft.ifft(xc, dim=-2, norm="forward"))
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
           bound(4 * plane_bytes + N * 4, fp32=fft_flops(N, N * P)),
           library_ms, inverse_dft)
    redesign_line("K4", ms, library_ms)
    k4_slices_phase(card, cfg, batch, fused_fft, parent_k4(parent_fft_build))
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
    xc = torch.complex(model, torch.zeros_like(model))
    ms, plain_ms, library_ms = timed_pair(
        lambda: out.__setitem__("p", fused_fft.pre_col_fft_plain(
            model, taper, scal)),
        lambda: out.__setitem__("k", fused_fft.pre_col_fft(model, taper,
                                                           scal)),
        reps=20, library=lambda: torch.fft.fft(xc, dim=-2))
    (ar, ai), (par, pai) = out["k"], out["p"]
    scale = max(par.abs().max().item(), pai.abs().max().item())
    record("K6 image prologue + column DFT",
           "katsdpimager_tpu_torch/csrc/fft.cu",
           "katsdpimager_tpu/ops/pallas_fft.py:343",
           max(max_err(ar, par), max_err(ai, pai)), 1e-5 * scale,
           ms, plain_ms,
           bound(3 * plane_bytes + N * 4, fp32=fft_flops(N, N * P)),
           library_ms, forward_dft)
    redesign_line("K6", ms, library_ms)

    xc = torch.complex(par, pai)
    ms, plain_ms, library_ms = timed_pair(
        lambda: out.__setitem__("p", fused_fft.cbout_col_fft_plain(par,
                                                                   pai)),
        lambda: out.__setitem__("k", fused_fft.cbout_col_fft(par, pai)),
        reps=20, library=lambda: torch.fft.fft(xc, dim=-2))
    (gr, gi), (pgr, pgi) = out["k"], out["p"]
    scale = max(pgr.abs().max().item(), pgi.abs().max().item())
    record("K7 column DFT + output checkerboard",
           "katsdpimager_tpu_torch/csrc/fft.cu",
           "katsdpimager_tpu/ops/pallas_fft.py:380",
           max(max_err(gr, pgr), max_err(gi, pgi)), 1e-5 * scale,
           ms, plain_ms, bound(4 * plane_bytes, fp32=fft_flops(N, N * P)),
           library_ms, forward_dft)
    redesign_line("K7", ms, library_ms)

    av, au, diu, div, dsu, dsv = fused_degrid.degrid_taps(
        kern, uv, sub, wp, anc, pixels=N, ts=ts)
    dtab = fused_degrid.degrid_table(kern)
    dargs = (pgr, pgi, av, au, count, diu, div, dsu, dsv, dtab, n)
    ms, plain_ms = timed_pair(
        lambda: out.__setitem__("p", fused_degrid.degrid_planes_plain(
            *dargs, ts=ts)),
        lambda: out.__setitem__("k", fused_degrid.degrid_planes(*dargs,
                                                                ts=ts)))
    scale = out["p"].abs().max().item()
    # Every slot is compared: the slots past a chunk's valid count, and the
    # chunks past n, are zero in both.  K5 reads both grid planes and each
    # valid slot's six taps, writes one complex prediction per slot and
    # polarization; K^2 complex MACs each.
    record("K5 fused degridder", "katsdpimager_tpu_torch/csrc/degrid.cu",
           "katsdpimager_tpu/ops/pallas_gridder.py:706",
           max_err(out["k"], out["p"]), 1e-5 * scale, ms, plain_ms,
           bound(2 * plane_bytes + n_valid * (6 * 4 + P * 8)
                 + dtab.numel() * dtab.element_size(),
                 fp32=8.0 * K * K * P * n_valid))
    redesign_line("K5", ms)
    del kr, ki, pr, pi, out, img_k, img_p, par, pai, ar, ai, gr, gi
    del pgr, pgi, model, dargs, xc
    k8_phase(dev, record, rows, fused_fft)
    k23_turns_phase(card, cfg, batch, fused_fft, fused_gridder)

    # ---- the step: 8 channels through single_channel_step
    step = mc.single_channel_step(cfg)

    def run_step():
        return [step(*mc.channel_args(batch, c))[0]
                for c in range(num_channels)]

    run_step()
    torch.cuda.synchronize()
    counters = (fused_gridder.grid_planes, fused_gridder.combine_planes,
                fused_fft.cb_col_fft, fused_fft.epi_col_fft,
                fused_fft.combine_cb_col_fft)
    for fn in counters:
        fn.launches = 0
    fused_fft.epi_col_fft.slices = 0
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        dirty = run_step()
    torch.cuda.synchronize()
    elapsed = (time.perf_counter() - t0) / iters
    launches = [fn.launches for fn in counters]
    nonempty = int((batch.n_chunks > 0).sum())
    channels = int((batch.n_chunks > 0).any(dim=1).sum())
    emit({"phase": "step", "card": card, "num_vis": num_vis,
          "num_channels": num_channels, "iters": iters,
          "elapsed_s": elapsed, "mvis_per_s": num_vis / elapsed / 1e6,
          "ggaps": num_vis * cfg.kernel_width ** 2 * cfg.num_pols
          / elapsed / 1e9,
          "launches": dict(zip(("K1", "K2", "K3", "K4", "K23"), launches)),
          "epi_col_fft.launches": fused_fft.epi_col_fft.launches,
          "epi_col_fft.slices": fused_fft.epi_col_fft.slices,
          "nonempty_channel_slices": nonempty,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    # The slice loop takes K23 in place of K2 then K3, and K4 once a
    # channel over its non-empty slices.
    want = [iters * nonempty, 0, 0, iters * channels, iters * nonempty]
    if (nonempty <= 0 or launches != want
            or fused_fft.epi_col_fft.slices != iters * nonempty):
        raise AssertionError(
            f"K1, K2, K3, K4, K23 launched {launches} times, K4 over "
            f"{fused_fft.epi_col_fft.slices} slices, expected {want} and "
            f"{iters * nonempty} ({iters} x {nonempty} non-empty slices, "
            f"{channels} channels)")
    by_name = {row["name"].split()[0]: row for row in rows}
    for name, count in zip(("K1", "K2", "K3", "K4", "K23"), launches):
        by_name[name]["step_launches"] = count

    # ---- step parity: channel 0 against the all-plain step on the card
    got = dirty[0]
    with plain_versions():
        ref = mc.single_channel_step(cfg)(*mc.channel_args(batch, 0))[0]
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
    weights_phase(dev, card, record, rows, mc, batch, num_channels, inside)
    k1_image_phase(card, cfg, batch, inside, mc, parent)

    # ---- where the step's time goes: one step under torch.profiler (the
    # device's busy time and idle share against the timed steps above),
    # and the host's seconds until the step's last launch returned.
    def profiled_step():
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_step()
            enqueued = time.perf_counter() - t0
            torch.cuda.synchronize()
        return device_busy_ms(prof) + (enqueued,)

    busy_ms, by_name, enqueued = profiled_step()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    line = {"phase": "step_profile", "card": card, "step_s": elapsed,
            "device_busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / 1e3 / elapsed,
            "host_enqueue_s_profiled": enqueued, "top_device_ms": top}
    if parent is not None:
        # the same step with the parent's K1, for its device busy time
        with k1_swapped(parent):
            run_step()
            pbusy, pby_name, _ = profiled_step()
        line.update(parent_k1_device_busy_ms=pbusy,
                    parent_k1_top_device_ms=sorted(
                        pby_name.items(), key=lambda kv: -kv[1])[:3])
    emit(line)
    if not busy_ms > 0:
        raise AssertionError("the profiler saw no device work in the step")

    wave_phases(cfg, batch, num_channels, rows, card, mc, cube, fourier,
                fused_gridder, fused_fft, fused_degrid)
    route_phase(dev, mc, cube, fused_fft)
    device_plan_phase(dev, card, cfg, batch, rows)
    del batch
    probe_phase(dev, rows)
    dataset, runs = imager_phase(dev, card, rows)
    pipeline_phase(dev, card, rows)
    tiles_phase(dev, card, parent)
    tiles_runs_phase(dev, card, dataset, IMAGER_VIS_BLOCK)
    exact_phase(dev, card, dataset, IMAGER_VIS_BLOCK)
    double_phase(dev, card, dataset, IMAGER_VIS_BLOCK, runs[1])
    profile_phase(dev, card, dataset, IMAGER_VIS_BLOCK)
    cube_double_phase(dev, card, dataset, IMAGER_VIS_BLOCK, parent)
    distributed_phase(dev, card, dataset, IMAGER_VIS_BLOCK)

    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


def k23_turns_phase(card, cfg, batch, fused_fft, fused_gridder) -> None:
    """K23 at the production batch's four slices of channel 0, at P = 1
    and at P = 4 (the slice's visibilities in every polarization), on
    colour planes whose unwritten blocks hold NaN: bitwise equal to K3 on
    K2's grid, and 20 single launches of each, timed by CUDA events, in
    turns (K23 first in even turns, K2 then K3 first in odd ones), with
    K23's byte bound from the slice's occupied blocks.  One line per P."""
    N, ts = cfg.pixels, cfg.rv
    turns = 20
    for P in (1, 4):
        slices = []
        for s in range(cfg.w_slices):
            n = int(batch.n_chunks[0, s])
            vis = batch.vis[0, s].repeat(1, 1, P).contiguous()
            accr, acci, occ = fused_gridder.grid_chunks_planes(
                batch.kernel[0], None, batch.uv[0, s], batch.sub_uv[0, s],
                batch.w_plane[0, s], vis, batch.anchor[0, s],
                batch.valid[0, s], None, n, pixels=N, ts=ts)
            written = occ.repeat_interleave(2 * ts, -2).repeat_interleave(
                2 * ts, -1)[:, :, None]
            for plane in (accr, acci):
                plane.masked_fill_(~written, float("nan"))
            del written

            def k23():
                return fused_fft.combine_cb_col_fft(accr, acci, occ,
                                                    pixels=N, ts=ts)

            def k2_k3():
                return fused_fft.cb_col_fft(*fused_gridder.combine_planes(
                    accr, acci, occ, pixels=N, ts=ts))

            got, want = k23(), k2_k3()
            torch.cuda.synchronize()
            same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                       for g, w in zip(got, want))
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            del got, want
            ms = {"k23": [], "k2_k3": []}
            for t in range(turns):
                order = (("k23", k23), ("k2_k3", k2_k3))
                for name, fn in order if t % 2 == 0 else order[::-1]:
                    ms[name].append(cuda_ms(fn, 1))
            bnd = k23_bound(occ, N, ts, P)
            slices.append({
                "slice": s, "chunks": n, "occupied_blocks": int(occ.sum()),
                "bitwise_k3_on_k2": same, "finite": finite,
                "k23_ms_median": statistics.median(ms["k23"]),
                "k2_k3_ms_median": statistics.median(ms["k2_k3"]),
                "k23_ms": ms["k23"], "k2_k3_ms": ms["k2_k3"],
                "k23_faster_turns": sum(a < b for a, b in zip(
                    ms["k23"], ms["k2_k3"])),
                **bnd, "share": bnd["bound_ms"]
                / statistics.median(ms["k23"])})
            del accr, acci, occ
            if not (same and finite):
                emit({"phase": "k23_turns", "P": P, "slices": slices})
                raise AssertionError(f"K23 at P {P}, slice {s} is not "
                                     f"bitwise K3 on K2's grid")
        emit({"phase": "k23_turns", "card": card, "P": P, "turns": turns,
              "slices": slices})


def k4_slices_phase(card, cfg, batch, fused_fft, parent) -> None:
    """K4 taking channel 0's ``cfg.w_slices`` slices (random transposed
    pairs, the channel's mid-w values and pixel size, its taper) in one
    launch against one launch a slice, at P = 1 and 4: bitwise from a zero
    image and from a random one, and 20 turns of each, timed by CUDA
    events over 5 back-to-back calls (so that the wrappers' host time
    hides behind the device's), beside the byte bound a channel of each
    route ((2 S + 2) planes against 4 S).  With the parent's K4
    (``parent``), one slice bitwise equal to it and 20 turns of each, the
    same way.  One line a P."""
    N, S = cfg.pixels, cfg.w_slices
    dev = batch.taper1d.device
    taper = batch.taper1d[0]
    scal = torch.stack([fused_fft.scalars(batch.mid_w[0, s],
                                          batch.pixel_size[0], dev)
                        for s in range(S)])
    gen = torch.Generator(device=dev).manual_seed(4)
    turns = 20
    for P in (1, 4):
        xr, xi = (torch.randn((S, P, N, N), device=dev, generator=gen)
                  for _ in range(2))
        start = torch.randn((P, N, N), device=dev, generator=gen)

        def one(img):
            return fused_fft.epi_col_fft(xr, xi, img, taper, scal)

        def per_slice(img):
            for s in range(S):
                fused_fft.epi_col_fft(xr[s], xi[s], img, taper, scal[s])
            return img

        same = True
        for img0 in (torch.zeros_like(start), start):
            a, b = one(img0.clone()), per_slice(img0.clone())
            same = same and torch.equal(a.view(torch.int32),
                                        b.view(torch.int32))
        img = start.clone()
        ms = {"one": [], "per_slice": []}
        for t in range(turns):
            order = (("one", one), ("per_slice", per_slice))
            for name, fn in order if t % 2 == 0 else order[::-1]:
                ms[name].append(cuda_ms(lambda: fn(img), 5))
        plane = P * N * N * 4
        one_bnd = bound((2 * S + 2) * plane, fp32=fft_flops(N, N * P * S))
        per_bnd = bound(4 * S * plane, fp32=fft_flops(N, N * P * S))
        one_ms = statistics.median(ms["one"])
        line = {"phase": "k4_slices", "card": card, "P": P, "S": S,
                "N": N, "turns": turns, "bitwise_per_slice": same,
                "one_launch_ms_median": one_ms,
                "per_slice_ms_median": statistics.median(ms["per_slice"]),
                "one_launch_faster_turns": sum(
                    a < b for a, b in zip(ms["one"], ms["per_slice"])),
                "one_launch_bound_ms": one_bnd["bound_ms"],
                "one_launch_share": one_bnd["bound_ms"] / one_ms,
                "per_slice_bound_ms": per_bnd["bound_ms"],
                "per_slice_share": per_bnd["bound_ms"]
                / statistics.median(ms["per_slice"]),
                "one_launch_ms": ms["one"], "per_slice_ms": ms["per_slice"]}
        if parent is not None:
            a, b = start.clone(), start.clone()
            fused_fft.epi_col_fft(xr[0], xi[0], a, taper, scal[0])
            parent(xr[0], xi[0], b, taper, scal[0])
            torch.cuda.synchronize()
            pms = {"k4": [], "parent": []}
            fns = (("k4", lambda: fused_fft.epi_col_fft(
                xr[0], xi[0], img, taper, scal[0])),
                   ("parent", lambda: parent(xr[0], xi[0], img, taper,
                                             scal[0])))
            for t in range(turns):
                for name, fn in fns if t % 2 == 0 else fns[::-1]:
                    pms[name].append(cuda_ms(fn, 5))
            k4_s1, parent_s1 = (statistics.median(pms[k])
                                for k in ("k4", "parent"))
            line.update(one_slice_bitwise_parent=torch.equal(
                a.view(torch.int32), b.view(torch.int32)),
                one_slice_ms_median=k4_s1,
                parent_one_slice_ms_median=parent_s1,
                one_slice_no_slower=k4_s1 <= parent_s1,
                one_slice_ms=pms["k4"], parent_one_slice_ms=pms["parent"])
            same = same and line["one_slice_bitwise_parent"]
        emit(line)
        del xr, xi, start, img
        if not same:
            raise AssertionError(f"K4 over {S} slices at P {P} is not "
                                 f"bitwise one launch a slice (or one "
                                 f"slice the parent's K4)")


def weights_phase(dev, card, record, rows, mc, batch, num_channels,
                  inside) -> None:
    """The weight grid's kernel (``csrc/weights.cu``) on channel 0 of the
    production batch (4 slices of 2^19 visibilities in 8192 chunks of
    256; 4096 px, ts 64, K 60): within 1e-6 of each cell of its plain
    version (``index_put_`` over the valid slots), bitwise equal to the
    float32 serial fold of the valid slots in slot order (numpy's
    ``add.at``) and to a second launch; its time, the plain version's
    and, as the one-call PyTorch yardstick, ``index_put_`` with
    accumulation over every slot with each padding slot sent to its own
    cell past N^2 (so no cell has a long run), in turns, and its device
    microseconds alone (``kernel_us``: the wrapper launches nothing
    else); its bound by bytes (the valid slots' uv and weights read once,
    the grid written once).  Then the main path: the ``num_channels``
    channels through ``single_channel_step`` under uniform weights (1
    warm-up, then one timed step with ``weight_grid.launches`` reset just
    before: one launch a channel, the row's ``launches``), and channel 0
    against the all-plain uniform step (within 1e-4 of its peak inside
    the field, as the natural step)."""
    import numpy as np

    cfg = bench_config()
    N, ts, K = cfg.pixels, cfg.rv, cfg.kernel_width
    uv, valid, weights, anchor = (x[0] for x in (
        batch.uv, batch.valid, batch.weights, batch.anchor))
    P = weights.shape[-1]
    kw = dict(anchor=anchor, ts=ts, kernel_width=K)
    out = {}

    def kernel():
        out["k"] = mc.weight_grid(P, N, uv, valid, weights, **kw)

    def plain():
        with plain_versions():
            out["p"] = mc.weight_grid(P, N, uv, valid, weights, **kw)

    flat_valid = valid.reshape(-1)
    slots = flat_valid.numel()
    cell = uv.reshape(-1, 2).long() + N // 2
    idx = torch.where(flat_valid, cell[:, 1] * N + cell[:, 0],
                      N * N + torch.arange(slots, device=dev))
    flat_w = weights.reshape(-1, P)

    def library():
        g = torch.zeros((P, N * N + slots), device=dev)
        for p in range(P):
            g[p].index_put_((idx,), flat_w[:, p], accumulate=True)
        out["l"] = g

    ms, plain_ms, library_ms = timed_pair(plain, kernel, library=library)
    k, pl = out["k"], out["p"]
    again = mc.weight_grid(P, N, uv, valid, weights, **kw)
    lib_same = torch.equal(out["l"][:, :N * N].view(P, N, N), pl)
    nz = pl != 0
    zeros_ok = bool((k[~nz] == 0).all())
    err = ((k - pl).abs()[nz] / pl[nz].abs()).max().item() if zeros_ok \
        else float("inf")
    keep = valid.cpu().numpy().reshape(-1)
    c = cell.cpu().numpy()[keep]
    w = flat_w.cpu().numpy()[keep]
    fold = np.zeros((P, N, N), np.float32)
    for p in range(P):
        np.add.at(fold[p], (c[:, 1], c[:, 0]), w[:, p])
    serial = bool(np.array_equal(k.cpu().numpy(), fold))
    twice = torch.equal(k.view(torch.int32), again.view(torch.int32))
    plain_same = torch.equal(k, pl)
    n_valid = int(keep.sum())
    device = kernel_us(kernel, 20)
    del out, k, pl, again, nz, idx, cell, flat_valid, fold

    ucfg = dataclasses.replace(cfg, weight_type="uniform")
    step = mc.single_channel_step(ucfg)
    args = [mc.channel_args(batch, ch) for ch in range(num_channels)]
    for a in args:                                 # warm-up
        step(*a)
    torch.cuda.synchronize()
    mc.weight_grid.launches = 0
    t0 = time.perf_counter()
    dirty = [step(*a)[0] for a in args]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = mc.weight_grid.launches
    with plain_versions():
        ref = mc.single_channel_step(ucfg)(*args[0])[0]
    peak = ref.abs().max().item()
    step_err = (dirty[0] - ref).abs()[:, inside].max().item() / peak
    finite = all(bool(torch.isfinite(d).all()) for d in dirty)
    num_vis = int(batch.valid.sum())
    emit({"phase": "uniform_step", "card": card,
          "num_channels": num_channels, "elapsed_s": elapsed,
          "mvis_per_s": num_vis / elapsed / 1e6,
          "weight_grid_launches": launches,
          "max_err_inside_over_peak": step_err, "tolerance": 1e-4,
          "peak": peak, "finite": finite})
    if launches != num_channels:
        raise AssertionError(f"the uniform step launched the weight grid "
                             f"{launches} times, expected {num_channels}")
    if not (step_err <= 1e-4 and finite and peak > 0):
        raise AssertionError("uniform step parity failed")
    del dirty, ref

    record("weights grid", "katsdpimager_tpu_torch/csrc/weights.cu",
           "none (XLA scatter-add, katsdpimager_tpu/parallel/"
           "multichannel.py:124-130)", err, 1e-6, ms, plain_ms,
           bound(n_valid * (8 + 4 * P) + P * N * N * 4),
           library_ms=library_ms,
           library="index_put_(accumulate=True) over every slot, each "
                   "padding slot to its own cell past N^2",
           extra={"bitwise_serial_fold": serial,
                  "bitwise_two_launches": twice,
                  "plain_bitwise": plain_same,
                  "library_bitwise_plain": lib_same},
           extra_ok=serial and twice,
           detail={"slots": slots, "valid_slots": n_valid,
                   "uniform_step_launches": launches,
                   "device_us": device})
    rows[-1]["launches"] = launches


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
    counters = kernel_counters()
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
    names = KERNEL_NAMES
    emit({"phase": "wave", "card": card, "num_channels": num_channels,
          "elapsed_s": elapsed, "s_per_channel": elapsed / num_channels,
          "minor_cycles_per_channel": minors,
          "clean_s": clean_s[0],
          "clean_cycles_per_s": sum(minors) / clean_s[0],
          "noise": res.noise.tolist(),
          "launches": dict(zip(names, launches)),
          "nonempty_channel_slices": nonempty, "peak_mem_gb": peak_gb})
    want = (cfg.majors - 1) * nonempty
    if launches[4:7] != [want] * 3:
        raise AssertionError(f"K5-K7 launched {launches[4:7]} times, "
                             f"expected {want} each")
    # the PSF and each major's dirty image: K1 and K23 a slice, K4 a
    # channel, the slice loop never K2 or K3
    grids = (1 + cfg.majors) * nonempty
    images = (1 + cfg.majors) * int((batch.n_chunks > 0).any(dim=1).sum())
    if (launches[0] != grids or launches[3] != images
            or launches[7] != grids or launches[1:3] != [0, 0]
            or min(minors) <= 0):
        raise AssertionError(f"wave launches {launches}, minor {minors}")
    by_name = {row["name"].split()[0]: row for row in rows}
    for name, count in zip(names, launches):
        by_name[name]["launches"] = count

    # ---- where the wave's time goes: one more wave under torch.profiler
    # (device activity only: CLEAN's host ops would swell the trace), its
    # device busy time and idle share against the timed wave above.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cube.wave_image(cfg, batch)
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    busy_ms, by_kernel = device_busy_ms(prof)
    k5_ms = sum(t for name, t in by_kernel.items()
                if "degrid_planes_kernel" in name)
    emit({"phase": "wave_profile", "card": card, "wave_s": elapsed,
          "profiled_s": profiled, "device_busy_ms": busy_ms,
          "idle_share": 1 - busy_ms / 1e3 / elapsed,
          "k5_device_ms": k5_ms, "k5_share_of_busy": k5_ms / busy_ms,
          "top_device_ms": sorted(by_kernel.items(),
                                  key=lambda kv: -kv[1])[:10]})
    if not busy_ms > 0:
        raise AssertionError("the profiler saw no device work in the wave")

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
    k5_on_wave_model(cfg, res.model[0], b0, fourier, fused_gridder,
                     fused_degrid)

    # ---- wave parity: channel 0 against the all-plain wave on the card
    with plain_versions():
        ref = cube.wave_image(cfg, b0)
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
    got = cube.wave_image(cfg_in, b0)
    with plain_versions():
        ref = cube.wave_image(cfg_in, b0)
    parity("wave_parity_border", cfg_in.border_pixels, got, ref,
           everywhere=True)


def route_phase(dev, mc, cube, fused_fft) -> None:
    """The dirty step and a cube wave at 1000 px, where the grid <-> image
    transforms take ``torch.fft`` by ``fourier.use_fused_fft``'s rule (no
    power of two), against their all-plain runs: within 1e-4 of the peak
    inside the field (the wave: the same component positions there), K3,
    K6 and K23 launched no time."""
    small = dict(pixels=1000, num_pols=1, kernel_width=16, oversample=8,
                 w_planes=8, w_slices=2, chunks_per_slice=512,
                 chunk_size=128, rv=32, ru=32)
    mcfg = mc.MultiChannelConfig(**small, weight_type="natural")
    batch = mc.make_example_batch(mcfg, 1, seed=3, device=dev)
    taper = batch.taper1d[0]
    t2 = torch.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    fused_fft.cb_col_fft.launches = fused_fft.pre_col_fft.launches = 0
    fused_fft.combine_cb_col_fft.launches = 0
    args = mc.channel_args(batch, 0)
    got = mc.single_channel_step(mcfg)(*args)[0]
    with plain_versions():
        ref = mc.single_channel_step(mcfg)(*args)[0]
    step_err = (got - ref).abs()[:, inside].max().item() \
        / ref.abs().max().item()
    cfg = cube.CubeConfig(**small, majors=2, minor=500, patch=33,
                          psf_core=32)
    batch, _, flux = cube.with_point_sources(cfg, batch, seed=1)
    wave = cube.wave_image(cfg, batch)
    with plain_versions():
        wave_ref = cube.wave_image(cfg, batch)
    wave_err = max((a - b).abs()[..., inside].max().item() for a, b in (
        (wave.model, wave_ref.model), (wave.residual, wave_ref.residual))) \
        / float(flux.max())
    same = bool(torch.equal((wave.model != 0)[..., inside],
                            (wave_ref.model != 0)[..., inside]))
    finite = all(bool(torch.isfinite(x).all()) for x in (
        got, wave.model, wave.residual))
    launches = {"K3": fused_fft.cb_col_fft.launches,
                "K6": fused_fft.pre_col_fft.launches,
                "K23": fused_fft.combine_cb_col_fft.launches}
    emit({"phase": "route", "pixels": 1000,
          "step_max_err_inside_over_peak": step_err,
          "wave_max_err_inside_over_peak_flux": wave_err, "tolerance": 1e-4,
          "wave_same_component_positions": same,
          "wave_components_inside": int((wave.model != 0)[..., inside].sum()),
          "finite": finite, "launches": launches})
    if not (step_err <= 1e-4 and wave_err <= 1e-4 and same and finite
            and launches == {"K3": 0, "K6": 0, "K23": 0}):
        raise AssertionError("route phase failed")


def field_border(taper) -> int:
    """The smallest CLEAN border whose square interior lies inside the
    anti-aliased field, taper^2 >= 0.2% of its peak: at the interior's
    corners taper(b)^4 >= 0.002 taper_max^4, rounded up to 16 pixels."""
    r = (taper / taper.max()).double()
    ok = (r * r * r * r >= 0.002) & (r.flip(0) ** 4 >= 0.002)
    b = int(torch.nonzero(ok)[0])
    return -(-b // 16) * 16


def k5_on_wave_model(cfg, model, b0, fourier, fused_gridder,
                     fused_degrid) -> None:
    """K5 against its plain version on the grid of the wave's own
    channel-0 model (through K6 and K7), for channel 0, slice 0.

    CLEAN also puts components outside the field, where K6 divides by
    taper^2 (up to ~3000x), so the grid carries large terms that cancel in
    the prediction.  Two f32 sums of the same n = K^2 terms, in any
    order, differ by at most 2 (n + 4) u sum|terms| (u = 2^-24, the +4
    for the complex products): that bound, per visibility, is the gate.
    The line also gives the error against the largest prediction."""
    N, ts, K = cfg.pixels, cfg.rv, cfg.kernel_width
    kern, tap, ps, midw, uv, sub, wp, anc, val = (x[0] for x in b0[:9])
    n = int(b0.n_chunks[0, 0])
    gr, gi = fourier.image_to_grid_parts(model, tap, midw[0], ps)
    av, au, iu, iv, su, sv = fused_degrid.degrid_taps(
        kern, uv[0], sub[0], wp[0], anc[0], pixels=N, ts=ts)
    tab = fused_degrid.degrid_table(kern)
    # Every slot is compared: past each chunk's valid count both are zero.
    taps = (av, au, fused_gridder.valid_counts(val[0]), iu, iv, su, sv)
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
           "katsdpimager_tpu/ops/pallas_fft.py:126", *row,
           "torch.fft.fft(x, dim=-2)")
    rows[-1]["launches"] = launches
    redesign_line("K8", row[2], row[5])


#: Each probe kernel's inputs (keys of ``probes.inputs``) and its dot: the
#: unit that runs it, its passes and the contraction each pass sums over
#: ("W": the table's rows, "Mk": the band's); E has no dot.  A's three
#: passes are its three bf16 thirds; B's and C's three are the TF32
#: products of their splits (B: one-hot . hi, mid, lo; C: lo hi, hi lo,
#: hi hi); C_tf32 is one TF32 pass.
PROBE_WORK = {
    "A": (("idx", "tab"), ("bf16", 3, "W")),
    "B": (("idx", "table"), ("tf32", 3, "W")),
    "C_stacked": (("av", "bu"), ("tf32", 3, "Mk")),
    "C_separate": (("a", "b", "c", "d"), ("tf32", 3, "Mk")),
    "C_tf32": (("av", "bu"), ("tf32", 1, "Mk")),
    "E": (("tab",), None),
    "F": (("idx", "tab"), ("bf16", 1, "W")),
}


def probe_bound(d, outs) -> dict:
    """:func:`bound` of the probe kernels named in ``outs`` (name ->
    output) run as one group on the inputs ``d`` of ``probes.inputs``:
    the group's distinct inputs read once and every output written once;
    each dot, 2 x its contraction x its passes per output, on the unit of
    :data:`PROBE_WORK`."""
    length = {"W": d["table"].shape[0], "Mk": d["av"].shape[0]}
    used, ops = set(), {}
    for name, out in outs.items():
        keys, dot = PROBE_WORK[name]
        used.update(keys)
        if dot is not None:
            unit, passes, over = dot
            ops[unit] = (ops.get(unit, 0.0)
                         + 2.0 * passes * length[over] * out.numel())
    nbytes = (sum(d[k].numel() * d[k].element_size() for k in used)
              + sum(o.numel() * o.element_size() for o in outs.values()))
    return bound(nbytes, **ops)


def kernel_us(fn, reps: int) -> dict:
    """Device microseconds of a kernel over ``reps`` calls of ``fn`` under
    ``torch.profiler``, from the kernel intervals of its trace (without
    the host's time between launches): their median, least and largest,
    and the kernels seen.  The profiler can miss a few kernels right
    after it starts (48 of 50 on an H100), and late in a long process it
    has read a mean at half a kernel's time: hence the median."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = sorted(ev["dur"] for ev in trace_events(prof)
                  if ev.get("ph") == "X" and ev.get("cat") == "kernel")
    if not durs:
        return {"us": 0.0, "us_min": 0.0, "us_max": 0.0, "seen": 0}
    return {"us": statistics.median(durs), "us_min": durs[0],
            "us_max": durs[-1], "seen": len(durs)}


def probe_phase(dev, rows) -> None:
    """P1 (A, B, C) and P2 (E, F): the probes' own entry, with their
    counters reset just before; A, B, E and F exactly 0, C by 3xTF32
    (K1's split and accumulation) within 1e-6 relative of a float64
    product and above 0, C in one TF32 pass above 1e-5; at most 5 P1 and
    2 P2 launches, every
    kernel launched.  Then every probe kernel against its plain version on the
    same inputs, its device microseconds (one launch a call) beside its
    bound, and each group's time against the design it replaced."""
    from katsdpimager_tpu_torch import probes

    for fn in probes.P1 + probes.P2:
        fn.launches = 0
    errs = probes.run(dev)
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in probes.P1 + probes.P2}
    launches = {"P1": sum(fn.launches for fn in probes.P1),
                "P2": sum(fn.launches for fn in probes.P2)}
    exact = ("A", "B", "E", "F_hi", "F_mid", "F_lo")
    ok = (all(errs[k] == 0.0 for k in exact)
          and 0.0 < errs["C_stacked"] <= 1e-6
          and 0.0 < errs["C_separate"] <= 1e-6 and errs["C_tf32"] > 1e-5
          and min(counts.values()) > 0 and launches["P1"] <= 5
          and launches["P2"] <= 2)
    emit({"phase": "probe", "rel_err": errs, "exact_must_be_0": exact,
          "c_3xtf32_tolerance": 1e-6, "c_tf32_must_exceed": 1e-5,
          "launches": launches, "launches_by_wrapper": counts, "ok": ok})
    if not ok:
        raise AssertionError(f"probes failed: {errs}, launches {counts}")

    # Kernel against plain on the same inputs: the selections and the
    # recombine exactly; the 3xTF32 dot within 2e-6 of its largest value
    # (sums of 256 f32 products in other orders, the kernel's tensor-core
    # partial sums truncated); the TF32 dot within 1e-4.
    d = probes.inputs(dev)
    tol = {"C_stacked": 2e-6, "C_separate": 2e-6, "C_tf32": 1e-4}
    for probe, replaces in (("P1", "scripts/mosaic_num_probe.py:64"),
                            ("P2", "scripts/mosaic_num_probe2.py:90")):
        worst, worst_tol = 0.0, 0.0
        group = [c for c in probes.cases(d) if c[1] == probe]
        outs, device_us = {}, {}
        for name, _, kernel, plain in group:
            got, want = kernel(), plain()
            outs[name] = want
            err = max_err(got, want)
            t = tol.get(name, 0.0) * want.abs().max().item()
            us = kernel_us(kernel, 50)
            seen = us["seen"]
            device_us[name] = us["us"]
            own = probe_bound(d, {name: want})
            emit({"phase": "kernel_detail", "name": f"{probe} {name}",
                  "max_abs_err": err, "tolerance": t,
                  "device_us": us["us"], "device_us_min": us["us_min"],
                  "device_us_max": us["us_max"], "kernels_seen": seen,
                  "bound_us": own["bound_ms"] * 1e3,
                  "bound_by": own["bound_by"]})
            if not err <= t:
                raise AssertionError(f"{probe} {name}: {err} > {t}")
            # One kernel a call (the profiler may miss the first few).
            if not 0 < seen <= 50:
                raise AssertionError(f"{probe} {name}: {seen} kernels in 50 "
                                     "calls")
            if err - t >= worst - worst_tol:
                worst, worst_tol = err, t
        ms, plain_ms = timed_pair(lambda: [c[3]() for c in group],
                                  lambda: [c[2]() for c in group], reps=10)
        bnd = probe_bound(d, outs)
        emit({"phase": "kernel", "name": probe, "max_abs_err": worst,
              "tolerance": worst_tol, "ms": ms, "plain_ms": plain_ms,
              "device_us": device_us,
              "device_us_total": sum(device_us.values()), **bnd, "ok": True})
        redesign_line(probe, ms)
        rows.append({"name": f"{probe} f32-exactness probes", "route": "cuda",
                     "source": "katsdpimager_tpu_torch/csrc/probe.cu",
                     "replaces": replaces, "launches": launches[probe],
                     "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                     **bnd, "library_ms": None, "device_us": device_us})


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


#: Visibilities per block of the CLI runs (``--vis-block``).
IMAGER_VIS_BLOCK = 1 << 17

#: The imaging kernels' names, in the order of :func:`kernel_counters`.
KERNEL_NAMES = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K23")


def kernel_counters():
    """The wrappers of K1-K7 and K23, whose ``launches`` count their
    launches."""
    from katsdpimager_tpu_torch.ops import (fused_degrid, fused_fft,
                                            fused_gridder)

    return (fused_gridder.grid_planes, fused_gridder.combine_planes,
            fused_fft.cb_col_fft, fused_fft.epi_col_fft,
            fused_degrid.degrid_planes, fused_fft.pre_col_fft,
            fused_fft.cbout_col_fft, fused_fft.combine_cb_col_fft)


def cli_run(dataset, args, dev, *, plain=False, timed=("clean_cycles",)):
    """One per-channel CLI run (``frontend.run``) of ``dataset`` on
    ``dev``, with the kernels' counters set to 0 just before it.  Returns
    the dirty, model, residual and restored images, the statistics, the
    seconds, the launches of K1-K7, the seconds of each ``Imaging``
    method in ``timed`` (synchronised on both sides; a key ``<name>_s``),
    and the W slices' blocks and non-empty count (the counts follow
    them)."""
    import numpy as np

    from katsdpimager_tpu_torch import frontend, imaging

    cap = {f"{name}_s": 0.0 for name in timed}

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
    # the timed stages (host clock, synchronised).
    pre = frontend.preprocess_visibilities
    originals = {name: getattr(imaging.Imaging, name) for name in timed}

    def capture_pre(*a, **k):
        cap["collector"] = pre(*a, **k)
        return cap["collector"]

    def timer(name, fn):
        def wrapper(self, *a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = fn(self, *a)
            torch.cuda.synchronize()
            cap[f"{name}_s"] += time.perf_counter() - t
            return result
        return wrapper

    frontend.preprocess_visibilities = capture_pre
    for name, fn in originals.items():
        setattr(imaging.Imaging, name, timer(name, fn))
    counters = kernel_counters()
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t = time.perf_counter()
    try:
        with versions(plain):
            frontend.run(args, dataset, Capture(), device=dev)
        torch.cuda.synchronize()
    finally:
        frontend.preprocess_visibilities = pre
        for name, fn in originals.items():
            setattr(imaging.Imaging, name, fn)
    cap["seconds"] = time.perf_counter() - t
    cap["launches"] = [fn.launches for fn in counters]
    reader = cap.pop("collector").reader()     # one channel, at 0
    lens = [reader.len(0, s) for s in range(reader.num_w_slices(0))]
    cap["blocks"] = sum(-(-n // args.vis_block) for n in lens)
    cap["nonempty"] = sum(n > 0 for n in lens)
    return cap


def imager_phase(dev, card, rows):
    """The per-channel CLI path (``frontend.run``) at full width on a
    simulated 2-channel L-band observation with noise: channel 0 with the
    default DFT-predict major cycle, channel 1 with ``--degrid``.  Each
    run resets the kernel counters just before and checks them against
    the slice, block and major counts; the restored fluxes against the
    truth; and the images against the same run on the all-plain path.
    Returns the dataset and each channel's run with the kernels."""
    import math

    num_antennas, num_dumps, vis_block = 64, 1024, IMAGER_VIS_BLOCK
    t0 = time.perf_counter()
    dataset, num_rows = sim_dataset(num_antennas, num_dumps, 2, noise_jy=1.0)
    emit({"phase": "imager_data", "seconds": time.perf_counter() - t0,
          "antennas": num_antennas, "dumps": num_dumps,
          "rows_per_channel": num_rows,
          "frequencies_hz": [dataset.frequency(c) for c in range(2)]})
    names = KERNEL_NAMES

    def run(channel, degrid, plain):
        return cli_run(dataset, imager_args(channel, degrid, vis_block), dev,
                       plain=plain)

    runs = {}
    for channel, degrid in ((0, False), (1, True)):
        got = run(channel, degrid, plain=False)
        stats = got["stats"]
        major = stats["major"]
        passes = 1 + major
        degrids = major - 1 if degrid else 0
        # the CLI's running grid: K2 then K3, never K23
        want = [passes * got["blocks"]] * 2 + [passes * got["nonempty"]] * 2 \
            + [degrids * got["blocks"]] + [degrids * got["nonempty"]] * 2 \
            + [0]
        peaks = truth_peaks(stats["image_parameters"],
                            stats["restoring_beam"], got["clean"])
        flux_ok = all(math.isclose(g, t, rel_tol=0.1) for g, t in peaks)
        emit({"phase": "imager", "card": card, "channel": channel,
              "major_cycle": "degrid" if degrid else "DFT predict",
              "seconds": got["seconds"], "clean_s": got["clean_cycles_s"],
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
        runs[channel] = got

    imager_profile(dev, dataset, vis_block)
    return dataset, runs


def pipeline_phase(dev, card, rows) -> None:
    """The batch pipeline's ``--cube`` route (``pipeline.run``) at full
    width on the simulated 2-channel observation: 4096 px, K = 60, 2
    majors, the MeerKAT primary beam, and the off-centre 1.5 Jy source
    subtracted from a text sky model.  Two waves of one channel each, so
    the worker preprocesses and packs wave 2 while wave 1 runs.  The run
    with the kernels (timed, counted and not instrumented); then the
    all-plain run (instrumented: the dirty peaks and non-empty slices),
    a rerun into the first run's directory (both waves skipped) and one
    profiled wave (not instrumented)."""
    import math
    import os
    import tempfile

    import numpy as np

    from katsdpimager_tpu_torch import (arguments, cube_frontend, io,
                                        pipeline, simulate)
    from katsdpimager_tpu_torch.ops import wkernel
    from katsdpimager_tpu_torch.parallel import cube

    num_antennas, num_dumps = 64, 1024
    dataset, num_rows = sim_dataset(num_antennas, num_dumps, 2,
                                    noise_jy=1.0)
    src = simulate.DEFAULT_SOURCES[1]
    counters = kernel_counters()
    names = KERNEL_NAMES

    with tempfile.TemporaryDirectory() as tmp:
        lsm = os.path.join(tmp, "subtract.txt")
        with open(lsm, "w") as f:
            f.write(f"{math.degrees(src.ra)!r} {math.degrees(src.dec)!r} "
                    f"{src.flux_iquv[0]!r} 0 0 0\n")

        def run(name, plain=False, channels=(0, 2), probe=False):
            """One ``pipeline.run`` into ``tmp/name``, with the kernels'
            counters set to 0 just before it.  Only a ``probe`` run (the
            all-plain one, which is not what the timings report) is
            wrapped, to read each wave's non-empty slices and CLEAN's
            input images (one device sync per CLEAN stage); the others
            run the pipeline as a user does, and their images are read
            back from the FITS files after the clock stops."""
            out = os.path.join(tmp, name)
            argv = ["simulated", out, "--cube", "--pixels", "4096",
                    "--kernel-width", "60", "--stokes", "I", "--major", "2",
                    "--no-tmp-file", "--vis-block", "131072",
                    "--no-thumbnails", "--primary-beam", "meerkat",
                    "--subtract", lsm, "-c", str(channels[0]), "-C",
                    str(channels[1])]
            args = pipeline.get_parser().parse_args(
                argv, namespace=arguments.SmartNamespace())
            writer = pipeline.PipelineWriter(out, thumbnails=False)
            cap = {"nonempty": [], "clean_inputs": []}
            to_batch, clean_stage = (cube_frontend.batch_from_arrays,
                                     cube._clean_stage)

            def capture_batch(*a, **k):
                batch = to_batch(*a, **k)
                cap["nonempty"].append(int((batch.n_chunks[0] > 0).sum()))
                return batch

            def capture_clean(cfg, residual, *a):
                cap["clean_inputs"].append(residual.abs().max().item())
                return clean_stage(cfg, residual, *a)

            if probe:
                cube_frontend.batch_from_arrays = capture_batch
                cube._clean_stage = capture_clean
            torch.cuda.synchronize()
            for fn in counters:
                fn.launches = 0
            t = time.perf_counter()
            try:
                with versions(plain):
                    cap["timings"] = pipeline.run(args, dataset, writer,
                                                  device=dev)
                torch.cuda.synchronize()
            finally:
                cube_frontend.batch_from_arrays = to_batch
                cube._clean_stage = clean_stage
            cap["seconds"] = time.perf_counter() - t
            cap["launches"] = [fn.launches for fn in counters]
            # Each channel's first CLEAN input is its dirty image (2
            # majors, one channel per wave).
            cap["dirty_peaks"] = cap["clean_inputs"][::2]
            with open(os.path.join(out, "state.json")) as f:
                cap["state"] = json.load(f)
            cap["images"] = {}
            for c in range(*channels):
                path = os.path.join(out, f"image_{c:05d}_clean.fits")
                if os.path.exists(path):
                    # The writer stores (1, P, N, N) with RA reversed.
                    header, data = io.read_fits(path)
                    cap["images"][c] = np.ascontiguousarray(
                        data[0, :, :, ::-1], np.float32)
                    cap["header"] = header
            return cap

        got = run("kernels")
        ref = run("plain", plain=True, probe=True)
        resume = run("kernels")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            profiled = run("profiled", channels=(0, 1))
        busy_ms, by_kernel = device_busy_ms(prof)

    state = got["state"]
    complete = [state.get(f"status/{c}") == "complete" for c in range(2)]
    minor = [[state[f"stats/{c}"]["minor"], ref["state"][f"stats/{c}"][
        "minor"]] for c in range(2)]
    N = got["header"]["NAXIS1"]
    pixel_size = math.sin(math.radians(got["header"]["CDELT2"]))
    taper = wkernel.taper(N, 7.0, 8, wkernel.default_beta(7.0))
    t2 = np.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    ra0, dec0 = simulate.DEFAULT_PHASE_CENTRE

    def peak_at(image, s):
        l, m, _ = simulate.lmn(np.array([s.ra]), np.array([s.dec]), ra0,
                               dec0)
        iy = int(round(N // 2 + m[0] / pixel_size))
        ix = int(round(N // 2 + l[0] / pixel_size))
        return float(np.nanmax(image[0, iy - 2:iy + 3, ix - 2:ix + 3]))

    centre = simulate.DEFAULT_SOURCES[0]
    subtracted = [peak_at(got["images"][c], src) / src.flux_iquv[0]
                  for c in range(2)]
    centre_ratio = [peak_at(got["images"][c], centre) / centre.flux_iquv[0]
                    for c in range(2)]
    errs, nan_same, finite = [], True, True
    for c in range(2):
        a, b = got["images"][c], ref["images"][c]
        nan_same = nan_same and bool(np.array_equal(np.isnan(a),
                                                    np.isnan(b)))
        both = inside & ~np.isnan(b[0])
        finite = finite and bool(np.isfinite(a[0][both]).all())
        errs.append(float(np.abs(a[0] - b[0])[both].max())
                    / ref["dirty_peaks"][c])
    # Per channel: the PSF and 2 majors grid each non-empty slice (K1 and
    # K23, and K4 once an image; the wave's slice loop never launches K2
    # or K3), the second major degrids each (K5-K7).  The slices are
    # counted in the plain run: the same host packer on the same data.
    per_channel = [[3 * n, 0, 0, 3 * (n > 0), n, n, n, 3 * n]
                   for n in ref["nonempty"]]
    want = [sum(w[k] for w in per_channel) for k in range(len(names))]
    launches = dict(zip(names, got["launches"]))
    wall = profiled["timings"][0]["device_write_s"]
    checks = {
        "both_channels_complete": all(complete),
        "subtracted_below_0.2": max(subtracted) < 0.2,
        "centre_within_10pct": all(abs(r - 1) <= 0.1 for r in centre_ratio),
        "plain_parity_1e-4": max(errs) <= 1e-4 and nan_same and finite,
        "equal_minor_counts": all(m[0] == m[1] for m in minor),
        "resume_skips_both_waves": resume["timings"] == [],
        "launches_match": got["launches"] == want,
    }
    emit({"phase": "pipeline", "card": card, "route": "--cube",
          "pixels": N, "channels": 2, "rows_per_channel": num_rows,
          "waves": len(got["timings"]),
          "nonempty_slices_per_channel": ref["nonempty"],
          "subtracted_source_5x5_max_over_flux": subtracted,
          "centre_source_5x5_max_over_flux": centre_ratio,
          "max_err_inside_over_dirty_peak": errs, "tolerance": 1e-4,
          "dirty_peaks": ref["dirty_peaks"], "minor_kernels_plain": minor,
          "launches": launches, "expected_launches": dict(zip(names, want)),
          "expected_per_channel": [dict(zip(names, w)) for w in per_channel],
          **checks})
    emit({"phase": "pipeline_timing", "card": card,
          "waves": [{k: v for k, v in w.items()} for w in got["timings"]],
          "s_per_channel": got["seconds"] / 2, "seconds": got["seconds"],
          "plain_seconds": ref["seconds"], "resume_seconds":
          resume["seconds"], "profiled_wave": profiled["timings"][0],
          "device_busy_ms": busy_ms,
          "idle_share_of_device_write": 1 - busy_ms / 1e3 / wall,
          "top_device_ms": sorted(by_kernel.items(),
                                  key=lambda kv: -kv[1])[:8]})
    if not all(checks.values()) or not busy_ms > 0:
        raise AssertionError(f"pipeline phase failed: {checks}")
    by_name = {row["name"].split()[0]: row for row in rows}
    for name, n in launches.items():
        by_name[name]["pipeline_launches"] = n


def imager_args(channel: int, degrid: bool, vis_block: int, extra=()):
    """The CLI's arguments for one channel of the simulated observation
    at full width (the default W spacing); ``extra`` arguments come last
    and override."""
    from katsdpimager_tpu_torch import arguments
    from katsdpimager_tpu_torch import imager

    argv = ["simulated", "unused_%c.fits", "--pixels", "4096",
            "--kernel-width", "60", "--stokes", "I", "--major", "2",
            "--no-tmp-file", "--vis-block", str(vis_block),
            "-c", str(channel), "-C", str(channel + 1)]
    return imager.get_parser().parse_args(
        argv + (["--degrid"] if degrid else []) + list(extra),
        namespace=arguments.SmartNamespace())


def trace_events(prof) -> list:
    """The events of a ``torch.profiler`` run's chrome trace."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_busy_ms(prof) -> tuple:
    """(busy ms, ms by kernel name) of a ``torch.profiler`` run: the union
    of the device's kernel, copy and memset intervals in its trace.  The
    profiler also shows each ``record_function`` range on the device
    (``gpu_user_annotation``); those are not device work and are left
    out."""
    spans, by_name = [], {}
    for ev in trace_events(prof):
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


IMAGES = ("dirty", "model", "residuals", "clean")


def imager_parity(channel, got, ref, *, phase="imager_parity",
                  ref_name="plain", tolerance=1e-4, gated=IMAGES,
                  **extra) -> dict:
    """The kernels' run against the all-plain run of the same channel
    (or against ``ref``, named ``ref_name``): the ``gated`` images within
    ``tolerance`` (None: not gated) of the dirty peak inside the
    anti-aliased field (taper^2 >= 0.2% of its peak) and the same CLEAN
    component positions there; the minor-count difference is printed
    with ``extra``.  Raises unless it holds; returns the line printed."""
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
    ok = ((tolerance is None
           or max(errs[name] for name in gated) <= tolerance)
          and same and finite and dirty_peak > 0)
    line = {"phase": phase, "channel": channel,
            "max_err_inside_over_dirty_peak": errs, "tolerance": tolerance,
            "gated": list(gated),
            "dirty_peak": dirty_peak,
            "components_inside": int((got["model"] != 0)[:, inside].sum()),
            "same_component_positions_inside": same, "finite": finite,
            "minor": minor, "minor_difference": minor[0] - minor[1],
            "seconds": got["seconds"], f"{ref_name}_seconds": ref["seconds"],
            **extra, "ok": ok}
    emit(line)
    if not ok:
        raise AssertionError(f"{phase} failed on channel {channel}")
    return line


#: K1's tile sizes beyond the production 64 and the 256 px 32, each with
#: K = ts + 1 (K <= 256) and a smaller K: the per-channel planner's
#: 8-31 (below 256 px), 33-63 (264-504 px) and ts = K > 64, the cube's
#: 128 and 256.
TILE_CASES = [(8, 9), (8, 5), (16, 17), (16, 12), (33, 34), (33, 20),
              (50, 51), (50, 30), (96, 97), (96, 60), (128, 129),
              (128, 100), (256, 256), (256, 200)]


def k1_inputs(dev, seed, *, ts, K, pixels, P=1, max_runs=600, Mc=256,
              WO=256, run_chunks=None):
    """Direct K1 inputs at tile size ``ts``: up to ``max_runs`` runs of
    1-4 chunks (or of ``run_chunks`` each) on distinct colour-plane slots
    of a ``pixels`` grid, every chunk full but each run's last (0-256
    valid slots), taps and shifts anywhere in range, random samples and
    kernel rows."""
    import numpy as np

    from katsdpimager_tpu_torch.ops import mxu_gridder

    rng = np.random.default_rng(seed)
    nt2 = mxu_gridder.colour_tiles(pixels, ts)
    runs = min(max_runs, 4 * nt2 * nt2)
    lengths = (rng.integers(1, 5, size=runs) if run_chunks is None
               else np.full(runs, run_chunks))
    slot = np.repeat(rng.choice(4 * nt2 * nt2, size=runs, replace=False),
                     lengths).astype(np.int32)
    NC = len(slot)
    count = np.full(NC, Mc, np.int32)
    count[np.cumsum(lengths) - 1] = rng.integers(0, Mc + 1, size=runs)
    iu, iv = (rng.integers(0, WO, size=(NC, Mc)).astype(np.int32)
              for _ in range(2))
    su, sv = (rng.integers(0, ts, size=(NC, Mc)).astype(np.int32)
              for _ in range(2))
    live = np.arange(Mc)[None, None, :] < count[:, None, None]
    sre, sim = (np.where(live, rng.normal(size=(NC, P, Mc)), 0.0).astype(
        np.float32) for _ in range(2))
    table = (rng.normal(size=(WO, K))
             + 1j * rng.normal(size=(WO, K))).astype(np.complex64)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in
         (slot, count, iu, iv, su, sv, sre, sim, table)]
    return t, nt2


def tiles_phase(dev, card, parent) -> None:
    """K1 and K2 at every tile size of :data:`TILE_CASES` against their
    plain versions on direct inputs at 2048 px: K1 within 2e-5 of the
    largest written value, K2 bitwise; times in turns, with the bound
    computed as the kernel table's K1 and K2 rows compute it.  K1, here
    and at ts 32 and 64, within :data:`K1_FLOAT64_TOL` of the peak of a
    float64 run of its plain version (the plain version's own float32
    error printed beside it).  Where the parent's K1 was built
    (``parent``), K1's time in turns against it and the two bitwise
    equal; then the ``k1_parent_bitwise`` line."""
    from katsdpimager_tpu_torch.ops import fused_gridder

    N, P = 2048, 1
    for ts, K in TILE_CASES + [(32, 33), (64, 65)]:
        (slot, count, iu, iv, su, sv, sre, sim, table), nt2 = k1_inputs(
            dev, ts * 1000 + K, ts=ts, K=K, pixels=N, P=P)
        n = slot.shape[0]
        ext2 = nt2 * 2 * ts
        shape = (2, 2, P, ext2, ext2)
        kr, ki, pr, pi = (torch.empty(shape, device=dev) for _ in range(4))
        args = (slot, n, count, iu, iv, su, sv, sre, sim, table)
        occ = fused_gridder.occupancy(slot, n, nt2)
        k1_ms, k1_plain_ms = timed_pair(
            lambda: fused_gridder.grid_planes_plain(*args, pr, pi, ts=ts),
            lambda: fused_gridder.grid_planes(*args, kr, ki, ts=ts))
        written = occ.repeat_interleave(2 * ts, -2).repeat_interleave(
            2 * ts, -1)[:, :, None]
        scale = max(pr.abs().where(written, 0.0).max().item(),
                    pi.abs().where(written, 0.0).max().item())
        k1_err = max((kr - pr).abs().where(written, 0.0).max().item(),
                     (ki - pi).abs().where(written, 0.0).max().item())
        vs64 = k1_vs_float64(args, ts, written, kernel=(kr, ki),
                             plain=(pr, pi))
        n_valid = int(count.sum())
        runs = int(occ.sum())
        window_bytes = runs * P * (2 * ts) ** 2 * 8
        k1_bound = bound(
            2 * n * 4 + n_valid * (4 * 4 + 2 * P * 4) + table.numel() * 8
            + window_bytes, tf32=3 * 8.0 * K * K * P * n_valid)
        out = {}
        k2_ms, k2_plain_ms = timed_pair(
            lambda: out.update(p=fused_gridder.combine_planes_plain(
                kr, ki, occ, pixels=N, ts=ts)),
            lambda: out.update(k=fused_gridder.combine_planes(
                kr, ki, occ, pixels=N, ts=ts)))
        k2_same = all(torch.equal(a, b) for a, b in zip(out["k"], out["p"]))
        # K2 reads the written blocks' cells that land in the N x N grid
        # (at ts 256 the blocks reach far past it), re and im.
        k2_read = sum(int(written[a, b, 0, :N - a * ts, :N - b * ts].sum())
                      for a in range(2) for b in range(2)) * 8 * P
        k2_bound = bound(k2_read + occ.numel() + 2 * P * N * N * 4)
        ok = (k1_err <= 2e-5 * scale and scale > 0 and k2_same
              and vs64["kernel"] <= K1_FLOAT64_TOL)
        k1_bitwise(f"tiles ts {ts} K {K}", parent, args, shape, ts)
        emit({"phase": "tiles", "card": card, "ts": ts, "K": K,
              "pixels": N, "chunks": n, "valid_slots": n_valid,
              "runs": runs,
              "k1": {"ms": k1_ms, "plain_ms": k1_plain_ms, **k1_bound,
                     "share": k1_bound["bound_ms"] / k1_ms,
                     "max_abs_err": k1_err, "tolerance": 2e-5 * scale,
                     "err_vs_float64_over_peak": vs64,
                     "float64_tolerance": K1_FLOAT64_TOL,
                     **k1_turns(parent, args, kr, ki, ts)},
              "k2": {"ms": k2_ms, "plain_ms": k2_plain_ms, **k2_bound,
                     "share": k2_bound["bound_ms"] / k2_ms,
                     "bitwise_equal": k2_same},
              "ok": ok})
        if not ok:
            raise AssertionError(f"tiles: K1/K2 at ts {ts}, K {K} failed")
        del kr, ki, pr, pi, out
    k1_parent_bitwise_line(parent)


#: An uncommitted copy of the parent's ``csrc/gridder.cu``, built and
#: timed beside K1 in turns by :func:`k1_long_runs_phase` where it exists
#: (a design comparison: the path lies in a git-ignored directory).
PARENT_K1_SOURCE = "_archive/k1_parent/gridder.cu"

#: An uncommitted copy of the parent's ``csrc/fft.cu`` (with its
#: ``col_fft_tile.cuh``), whose K4 :func:`k4_slices_phase` holds one slice
#: to, where it exists.
PARENT_FFT_SOURCE = "_archive/fft_parent/fft.cu"


def start_parent_build(source):
    """Start ``nvcc`` on ``source``, an uncommitted copy of a parent's
    kernel source, into a shared library beside it, with the port's
    flags; returns ``(process, library)``, or None where the copy is
    absent."""
    import os

    from katsdpimager_tpu_torch.ops import _build

    if not os.path.exists(source):
        return None
    where = os.path.dirname(source)
    lib = os.path.join(where, "libparent_%s.so" % os.path.splitext(
        os.path.basename(source))[0])
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.COMPILE_FLAGS,
           "-I", where, "-shared", "-o", lib, source]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), lib


def parent_k4(build):
    """The parent copy's one-slice K4 as ``fn(ar_t, ai_t, imageT, taper,
    scal)`` (the parent's ``ktt_epi_col_fft`` argument list), or None
    without the copy; prints its ptxas report."""
    import ctypes
    import os

    from katsdpimager_tpu_torch.ops import _build, fused_fft

    if build is None:
        return None
    proc, lib_path = build
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {PARENT_FFT_SOURCE}:\n{err}")
    emit({"phase": "ptxas_parent_k4", "kernels": [
        k for k in _build.ptxas_report(err)
        if "epi_col_fft_kernel" in k["function"]]})
    fn = ctypes.CDLL(os.path.abspath(lib_path)).ktt_epi_col_fft
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(ar_t, ai_t, imageT, taper, scal):
        P, n, _ = imageT.shape
        tw = fused_fft.twiddles_full(n, imageT.device)
        _build.check(fn(ar_t.data_ptr(), ai_t.data_ptr(), tw.data_ptr(),
                        taper.data_ptr(), scal.data_ptr(), imageT.data_ptr(),
                        P, n, _build.stream_of(imageT)),
                     "parent ktt_epi_col_fft")
    return run


def parent_k1(build):
    """The parent copy's ``ktt_grid_planes`` (the same argument list) as
    ``fn(slot, n, count, iu, iv, su, sv, sre, sim, table, accr, acci,
    ts)``, or None without the copy; prints its ptxas report."""
    import ctypes
    import os

    from katsdpimager_tpu_torch.ops import _build, fused_gridder

    if build is None:
        return None
    proc, lib_path = build
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {PARENT_K1_SOURCE}:\n{err}")
    emit({"phase": "ptxas_parent_k1", "kernels": [
        k for k in _build.ptxas_report(err)
        if "18grid_planes_kernelI" in k["function"]]})
    lib = ctypes.CDLL(os.path.abspath(lib_path))
    fn = lib.ktt_grid_planes
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P_, I_] + [P_] * 11 + [I_] * 6 + [P_]
    fn.restype = ctypes.c_int

    def run(slot, n, count, iu, iv, su, sv, sre, sim, table, accr, acci, ts):
        NC, Mc = iu.shape
        tabs = fused_gridder.split_table(table)
        _build.check(fn(slot.data_ptr(), n, count.data_ptr(), iu.data_ptr(),
                        iv.data_ptr(), su.data_ptr(), sv.data_ptr(),
                        sre.data_ptr(), sim.data_ptr(), table.data_ptr(),
                        tabs.data_ptr(), accr.data_ptr(), acci.data_ptr(), NC,
                        Mc, sre.shape[1], table.shape[1], ts,
                        accr.shape[-1] // (2 * ts), _build.stream_of(accr)),
                     "parent ktt_grid_planes")
    return run


#: Chunks per anchor run in :func:`k1_long_runs_phase`, and how many runs
#: of each length it grids (full chunks of 256 valid slots: runs of 128,
#: 1024 and 4096 k-steps of 8, 4 to 64 segments of K1's totals).
LONG_RUN_CASES = ((4, 600), (32, 128), (128, 48))


def k1_long_runs_phase(dev, card, production, parent) -> None:
    """K1 at ts 64, K 60 and ts 32, K 30 on direct inputs whose anchor
    runs hold 4, 32 and 128 full chunks (2048 px): within
    :data:`K1_FLOAT64_TOL` of the peak of a float64 run of its plain
    version over the written blocks (the plain version's own float32
    error printed beside it).  Then
    K1's time at the production slice (``production``: its arguments),
    and on the 128-chunk runs at ts 64, in turns against the parent's
    kernel where its copy was built (``parent``), parent, change, change,
    parent."""
    from katsdpimager_tpu_torch.ops import fused_gridder

    N, P = 2048, 1
    worst = 0.0
    for ts, K in ((64, 60), (32, 30)):
        for run_chunks, max_runs in LONG_RUN_CASES:
            (slot, count, iu, iv, su, sv, sre, sim, table), nt2 = k1_inputs(
                dev, 7000 + ts + run_chunks, ts=ts, K=K, pixels=N, P=P,
                max_runs=max_runs, run_chunks=run_chunks)
            n = slot.shape[0]
            ext2 = nt2 * 2 * ts
            shape = (2, 2, P, ext2, ext2)
            kr, ki, pr, pi = (torch.zeros(shape, device=dev)
                              for _ in range(4))
            args = (slot, n, count, iu, iv, su, sv, sre, sim, table)
            fused_gridder.grid_planes(*args, kr, ki, ts=ts)
            fused_gridder.grid_planes_plain(*args, pr, pi, ts=ts)
            occ = fused_gridder.occupancy(slot, n, nt2)
            written = occ.repeat_interleave(2 * ts, -2).repeat_interleave(
                2 * ts, -1)[:, :, None]
            vs64 = k1_vs_float64(args, ts, written, kernel=(kr, ki),
                                 plain=(pr, pi))
            k1_bitwise(f"long runs ts {ts} x {run_chunks}", parent, args,
                       shape, ts)
            line = {"phase": "k1_long_runs", "card": card, "ts": ts, "K": K,
                    "pixels": N, "chunks_per_run": run_chunks, "chunks": n,
                    **run_lengths(slot, n, count),
                    "err_vs_float64_over_peak": vs64,
                    "tolerance": K1_FLOAT64_TOL}
            if ts == 64 and run_chunks == LONG_RUN_CASES[-1][0]:
                line.update(k1_turns(parent, args, kr, ki, ts))
            line["ok"] = vs64["kernel"] <= K1_FLOAT64_TOL
            emit(line)
            worst = max(worst, vs64["kernel"])
            if not line["ok"]:
                raise AssertionError(f"k1_long_runs at ts {ts}, runs of "
                                     f"{run_chunks} chunks failed")
            del kr, ki, pr, pi
    args, kr, ki, ts = production
    emit({"phase": "k1_long_runs", "card": card,
          "case": "production slice (channel 0, slice 0)",
          **k1_turns(parent, args, kr, ki, ts),
          "worst_err_vs_float64_over_peak": worst})


def run_lengths(slot, n: int, count) -> dict:
    """The first ``n`` chunks' anchor runs by length in K1's batches
    (``ceil(count / BATCH)`` summed over a run's chunks): runs, batches,
    the longest run's, and K1's promotions (a run's stretches of
    ``PROMOTE_STEPS`` batches)."""
    from katsdpimager_tpu_torch.ops import fused_gridder

    s = slot[:n].long()
    first = torch.ones(n, dtype=torch.bool, device=s.device)
    first[1:] = s[1:] != s[:-1]
    run = torch.cumsum(first.long(), 0) - 1
    batches = torch.zeros(int(first.sum()), dtype=torch.long,
                          device=s.device).index_add_(
        0, run, -(-count[:n].long() // fused_gridder.BATCH))
    steps = fused_gridder.PROMOTE_STEPS
    return {"runs": batches.numel(), "batches": int(batches.sum()),
            "longest_run_batches": int(batches.max()),
            "promotions": int((-(-batches // steps)).sum())}


#: K1's gate against float64: its planes within this much of the peak of
#: a float64 run of its plain version on the same inputs (the JAX
#: gridder's class: 1.6-2.2e-7, ``doc/PERFORMANCE.md``).
K1_FLOAT64_TOL = 1e-6


def k1_vs_float64(args, ts: int, written, **planes) -> dict:
    """The largest error of each of ``planes`` (name: (re, im) float32)
    over the written blocks, over the peak of a float64 run of the plain
    K1 on ``args`` (its arguments up to the planes)."""
    from katsdpimager_tpu_torch.ops import fused_gridder

    slot, n, count, iu, iv, su, sv, sre, sim, table = args
    shape = planes[next(iter(planes))][0].shape
    r64, i64 = (torch.zeros(shape, dtype=torch.float64, device=sre.device)
                for _ in range(2))
    fused_gridder.grid_planes_plain(
        slot, n, count, iu, iv, su, sv, sre.double(), sim.double(),
        table.to(torch.complex128), r64, i64, ts=ts)
    scale = max(r64.abs().max().item(), i64.abs().max().item())
    return {name: max((a.double() - r64).abs().where(written, 0.0).max(),
                      (b.double() - i64).abs().where(written, 0.0).max()
                      ).item() / scale
            for name, (a, b) in planes.items()}


def k1_accumulation_line(_build, fused_gridder, work) -> None:
    """K1's accumulation schedule, its work at the production slice as
    its workers reported it (``work``, :func:`k1_work`) and each
    instance's registers, spills and static shared memory (``ptxas -v``:
    one register count for all the CTA's threads, producer and consumers
    alike, as the kernel sets no ``setmaxnreg``)."""
    instances = []
    for ts in (64, 50, 32, 16):      # (BN, kPad) = (128, 0), (128, 1),
        inst = k1_instance(ts)       # (64, 0), (64, 1)
        row = k1_ptxas(_build, ts)
        instances.append({"bn": inst["bn"], "pad": inst["pad"],
                          "lanes": inst["lanes"],
                          "registers_every_thread": row["registers"],
                          **{k: row[k] for k in ("spill_stores",
                                                 "spill_loads",
                                                 "stack_bytes",
                                                 "static_smem_bytes")}})
    emit({"phase": "k1_accumulation",
          "schedule": "3xTF32 wgmma m64n64k8 into one accumulator set (re, "
                      "im) a consumer warpgroup, afresh every batch "
                      "(PROMOTE_STEPS k-steps of 8), then IEEE adds into a "
                      "segment's FP32 totals in registers and every SEGMENT "
                      "batches, and at the run's end, into the run's totals "
                      "in its block of the planes",
          "promote_steps": fused_gridder.PROMOTE_STEPS,
          "batch": fused_gridder.BATCH, "segment": fused_gridder.SEGMENT,
          "accumulator_sets": 1, "work": work, "instances": instances})


def k1_turns(parent, args, kr, ki, ts) -> dict:
    """K1's milliseconds on ``args`` and, with ``parent``, the parent
    copy's, in turns (parent, change, change, parent; 20 launches each)."""
    from katsdpimager_tpu_torch.ops import fused_gridder

    def change():
        fused_gridder.grid_planes(*args, kr, ki, ts=ts)

    if parent is None:
        change()
        torch.cuda.synchronize()
        return {"k1_ms": cuda_ms(change, 20), "parent_k1_ms": None,
                "parent": "no copy at " + PARENT_K1_SOURCE}
    pr, pi = torch.empty_like(kr), torch.empty_like(ki)
    ms, parent_ms = timed_pair(lambda: parent(*args, pr, pi, ts), change,
                               reps=20)
    return {"k1_ms": ms, "parent_k1_ms": parent_ms,
            "change_over_parent": ms / parent_ms}


#: Whether K1 and the parent's copy gave bitwise equal planes, by case
#: (``k1_bitwise``), for the ``k1_parent_bitwise`` line.
K1_BITWISE = {}


def k1_bitwise(case, parent, args, shape, ts) -> None:
    """Grid ``args`` with K1 and with the parent's copy into planes that
    start as NaN and note whether every bit agrees (nothing without the
    copy)."""
    from katsdpimager_tpu_torch.ops import fused_gridder

    if parent is None:
        return
    dev = args[0].device
    kr, ki, pr, pi = (torch.full(shape, float("nan"), device=dev)
                      for _ in range(4))
    fused_gridder.grid_planes(*args, kr, ki, ts=ts)
    parent(*args, pr, pi, ts)
    K1_BITWISE[case] = all(torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                           for a, b in ((kr, pr), (ki, pi)))


def k1_parent_bitwise_line(parent) -> None:
    """The ``k1_parent_bitwise`` line: K1 bitwise equal to the parent's
    copy at the production slice, the long runs and every ``tiles`` case
    (the same IEEE adds in the same order: the run's totals moved from
    registers into the planes); fails where a case differs."""
    if parent is None:
        emit({"phase": "k1_parent_bitwise",
              "parent": "no copy at " + PARENT_K1_SOURCE})
        return
    same = all(K1_BITWISE.values())
    emit({"phase": "k1_parent_bitwise", "cases": K1_BITWISE,
          "bitwise_equal": same, "ok": same})
    if not same:
        raise AssertionError("K1 is not bitwise equal to the parent's "
                             "copy: " + str(K1_BITWISE))


def k1_ptxas(_build, ts) -> dict:
    """``ptxas -v``'s report of K1's instance at tile size ``ts``."""
    inst = k1_instance(ts)
    name = "18grid_planes_kernelILi%dELb%dE" % (inst["bn"], inst["pad"])
    return next(r for r in _build.ptxas_report() if name in r["function"])


def k1_instance(ts) -> dict:
    """K1's instance at tile size ``ts``, as ``ktt_grid_planes`` picks it:
    the window padded to ``wp`` (``pad``: past 2 ts), cut into ``tiles``
    of 64 rows by ``bn`` columns, and the ``lanes`` (workers) of a CTA
    (:func:`k1_work` holds this to what the kernel reports)."""
    wp = 64 * -(-2 * ts // 64)
    bn = 128 if wp % 128 == 0 else 64
    return {"wp": wp, "bn": bn, "pad": wp > 2 * ts,
            "lanes": 1 if bn == 128 else 2,
            "tiles": (wp // 64) * (wp // bn)}


def k1_work(args, shape, ts, runs) -> dict:
    """K1's work at ``args``, as its workers report it in a launch of its
    own (``grid_planes(..., stats=...)``): the items (pass, anchor run)
    and batches of 16 valid slots each worker took.  ``ok`` where the
    workers are the instance's lanes of one CTA an SM, and took every
    pass (polarization, tile) of each of the ``runs`` runs once with its
    batches."""
    from katsdpimager_tpu_torch.ops import fused_gridder

    dev = args[0].device
    n, count, P = args[1], args[2], args[7].shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stats = torch.full((2 * sms, 2), -1, dtype=torch.int32, device=dev)
    kr, ki = (torch.empty(shape, device=dev) for _ in range(2))
    fused_gridder.grid_planes(*args, kr, ki, ts=ts, stats=stats)
    inst = k1_instance(ts)
    workers = inst["lanes"] * sms
    got = stats.cpu()
    items, batches = got[:workers, 0], got[:workers, 1]
    passes = P * inst["tiles"]
    b = fused_gridder.BATCH
    want_batches = passes * int(((count[:n] + b - 1) // b).sum())
    ok = (int(items.sum()) == passes * runs
          and int(batches.sum()) == want_batches
          and bool((items >= 0).all()) and bool((got[workers:] == -1).all()))
    return {"work_items": int(items.sum()), "work_items_expected":
            passes * runs, "batches": int(batches.sum()),
            "batches_expected": want_batches, "ctas": sms,
            "workers": workers, "lanes": inst["lanes"],
            "tiles_per_run": inst["tiles"],
            "heaviest_worker_batches": int(batches.max()),
            "mean_worker_batches": float(batches.double().mean()),
            "heaviest_worker_items": int(items.max()), "ok": ok}


#: ``--w-step`` of the K = 96 runs: with K = 96 a W slice spans more W,
#: and the default step of 1 cell needs more than the preprocessor's 1024
#: W planes per slice at 4096 px.
W_STEP_K96 = "2"


def tiles_runs_phase(dev, card, dataset, vis_block: int) -> None:
    """The paths that take K1 at tile sizes other than 32 and 64, on the
    CLI's observation, each against its all-plain run inside the field:
    the CLI at 400 px, K = 16 (ts = 50; ``--degrid``: K1, K2 and K5, the
    transforms in torch.fft by rule), the CLI at 4096 px, K = 96 (ts = 96,
    ``--degrid``: K1-K7) and ``pipeline --cube`` at 4096 px, K = 96 (ts =
    128), one channel and one major (K1-K4)."""
    import os
    import tempfile

    import numpy as np

    from katsdpimager_tpu_torch import arguments, io, pipeline
    from katsdpimager_tpu_torch.ops import mxu_gridder, wkernel

    for pixels, K, want_k3 in ((400, 16, False), (4096, 96, True)):
        ts = mxu_gridder.tile_size(pixels, K)
        extra = ["--pixels", str(pixels), "--kernel-width", str(K),
                 "--w-step", W_STEP_K96 if K == 96 else "1"]
        got = cli_run(dataset, imager_args(1, True, vis_block, extra), dev)
        ref = cli_run(dataset, imager_args(1, True, vis_block, extra), dev,
                      plain=True)
        launches = dict(zip(KERNEL_NAMES, got["launches"]))
        ran = (launches["K1"] > 0 and launches["K5"] > 0
               and (launches["K3"] > 0) == want_k3)
        imager_parity(1, got, ref, phase="tiles_cli", pixels=pixels,
                      kernel_width=K, ts=ts, launches=launches,
                      kernels_ran=ran)
        if not ran:
            raise AssertionError(f"tiles_cli at {pixels} px, K {K}: "
                                 f"launches {launches}")

    with tempfile.TemporaryDirectory() as tmp:
        def run(name, plain):
            out = os.path.join(tmp, name)
            argv = ["simulated", out, "--cube", "--pixels", "4096",
                    "--kernel-width", "96", "--w-step", W_STEP_K96,
                    "--stokes", "I", "--major", "1",
                    "--no-tmp-file", "--vis-block", str(vis_block),
                    "--no-thumbnails", "-c", "0", "-C", "1"]
            args = pipeline.get_parser().parse_args(
                argv, namespace=arguments.SmartNamespace())
            counters = kernel_counters()
            torch.cuda.synchronize()
            for fn in counters:
                fn.launches = 0
            t = time.perf_counter()
            with versions(plain):
                pipeline.run(args, dataset,
                             pipeline.PipelineWriter(out, thumbnails=False),
                             device=dev)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            _, data = io.read_fits(os.path.join(out,
                                                "image_00000_clean.fits"))
            with open(os.path.join(out, "state.json")) as f:
                state = json.load(f)
            return (np.asarray(data[0], np.float64), state, seconds,
                    dict(zip(KERNEL_NAMES, [fn.launches for fn in counters])))

        got, st, seconds, launches = run("kernels", False)
        ref, ref_st, ref_seconds, _ = run("plain", True)
    taper = wkernel.taper(4096, 7.0, 8, wkernel.default_beta(7.0))
    t2 = np.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    peak = float(np.abs(ref[0]).max())
    err = float(np.abs(got[0] - ref[0])[inside].max()) / peak
    minor = [st["stats/0"]["minor"], ref_st["stats/0"]["minor"]]
    ok = (err <= 1e-4 and bool(np.isfinite(got[0][inside]).all())
          and st["status/0"] == "complete" and launches["K1"] > 0
          and launches["K4"] > 0 and minor[0] == minor[1])
    emit({"phase": "tiles_pipeline", "card": card, "route": "--cube",
          "pixels": 4096, "kernel_width": 96, "ts": 128, "majors": 1,
          "max_err_inside_over_restored_peak": err, "tolerance": 1e-4,
          "restored_peak": peak, "minor": minor, "seconds": seconds,
          "plain_seconds": ref_seconds, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError("tiles_pipeline failed")


def exact_phase(dev, card, dataset, vis_block: int) -> None:
    """Channel 0 of the imager phase (the DFT-predict major cycle) with
    ``KTPU_PREDICT_EXACT=1`` and again with the default route: the
    restored images and CLEAN components against each other inside the
    field (the same positions and minor counts; the images' difference
    printed, not gated: it is the default route's float32 phase error,
    see below), and both routes' ``model_predict`` seconds.  Then both
    predicts of the exact run's components, on 2^20 visibilities drawn
    over the channel's grid, against a float64 DFT: the exact one within
    2e-6 of its largest value (tests/test_predict.py's tolerance) and no
    further from it than the DFT route."""
    import os

    import numpy as np

    from katsdpimager_tpu_torch.ops import predict

    timed = ("clean_cycles", "model_predict")
    os.environ["KTPU_PREDICT_EXACT"] = "1"
    try:
        exact = cli_run(dataset, imager_args(0, False, vis_block), dev,
                        timed=timed)
    finally:
        del os.environ["KTPU_PREDICT_EXACT"]
    default = cli_run(dataset, imager_args(0, False, vis_block), dev,
                      timed=timed)

    ip = exact["stats"]["image_parameters"]
    gp = exact["stats"]["grid_parameters"]
    N, O, W = ip.pixels, gp.fixed.oversample, gp.w_planes
    lmn, flux, xi, yi = predict.extract_sky_image(
        ip, gp, exact["model"].astype(np.float32), return_pixels=True)
    uv_scale, w_scale, w_bias = predict.uvw_scale_bias(ip, gp)
    rng = np.random.default_rng(9)
    n = 1 << 20
    half = N // 2 - gp.fixed.kernel_width
    uv = rng.integers(-half, half, size=(n, 2)).astype(np.int16)
    sub = rng.integers(0, O, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, W, size=n).astype(np.int16)
    u64, v64 = ((uv[:, i] * O + sub[:, i] + 0.5) * uv_scale for i in (0, 1))
    w64 = wp * w_scale + w_bias
    l64, m64 = xi * float(ip.pixel_size), yi * float(ip.pixel_size)
    n64 = np.sqrt(1 - l64 * l64 - m64 * m64) - 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    phase = (-2 * np.pi) * (t(u64)[:, None] * t(l64)[None]
                            + t(v64)[:, None] * t(m64)[None]
                            + t(w64)[:, None] * t(n64)[None])
    want = torch.polar(torch.ones_like(phase), phase) @ t(
        flux.astype(np.float64)).to(torch.complex128)
    zero = torch.zeros((n, flux.shape[1]), dtype=torch.complex64,
                       device=dev)
    ones = torch.ones((n, flux.shape[1]), dtype=torch.float32, device=dev)
    got_exact = -predict.predict_subtract_exact(
        t(xi), t(yi), t(lmn[:, 2]), t(flux), t(uv), t(sub), zero, ones,
        t(wp), float(np.float32(w_scale)), float(np.float32(w_bias)),
        pixels=N, oversample=O, w_planes=W)
    got_dft = -predict.predict_subtract(
        t(lmn), t(flux), t(uv), t(sub), t(wp), zero, ones, uv_scale,
        w_scale, float(np.float32(w_bias)), oversample=O)
    scale = want.abs().max().item()
    err_exact = (got_exact - want).abs().max().item() / scale
    err_dft = (got_dft - want).abs().max().item() / scale
    accurate = err_exact <= 2e-6 and err_exact <= err_dft
    imager_parity(0, exact, default, phase="exact", ref_name="default",
                  tolerance=None, card=card,
                  model_predict_s=exact["model_predict_s"],
                  default_model_predict_s=default["model_predict_s"],
                  components=int(len(xi)),
                  predict_vs_float64={"visibilities": n, "exact": err_exact,
                                      "dft": err_dft, "tolerance": 2e-6},
                  exact_accurate=accurate)
    if not accurate:
        raise AssertionError(f"exact predict: {err_exact} of the float64 "
                             f"DFT (the DFT route {err_dft})")


def double_phase(dev, card, dataset, vis_block: int, single) -> None:
    """Channel 1 of the imager phase (``--degrid``) with ``--precision
    double`` on the card, against the same channel's float32 run
    (``single``): float64 images, finite, the dirty image within the 1e-4
    gate of the float32 run inside the field, the same components and
    minor counts; K1 and K5 launched (the transforms and the colour-plane
    add run in torch).  The model, residual and restored images are
    printed, not gated: CLEAN's components drift apart between a float32
    and a float64 run, in the JAX package as much as here
    (tests/test_torch_imager.py::test_single_and_double_differ_as_in_jax),
    more with the image's size."""
    import numpy as np

    got = cli_run(dataset, imager_args(1, True, vis_block,
                                       ["--precision", "double"]), dev)
    launches = dict(zip(KERNEL_NAMES, got["launches"]))
    f64 = all(got[name].dtype == np.float64
              for name in ("dirty", "model", "residuals", "clean"))
    finite = all(np.isfinite(got[name]).all()
                 for name in ("dirty", "model", "residuals", "clean"))
    ran = launches["K1"] > 0 and launches["K5"] > 0
    minor_equal = got["stats"]["minor"] == single["stats"]["minor"]
    imager_parity(1, got, single, phase="double", ref_name="single",
                  gated=("dirty",), card=card, launches=launches,
                  float64=f64,
                  finite_everywhere=finite, kernels_ran=ran,
                  minor_equal=minor_equal)
    if not (f64 and finite and ran and minor_equal):
        raise AssertionError(f"double: float64 {f64}, finite {finite}, "
                             f"launches {launches}, minor equal "
                             f"{minor_equal}")


def profile_phase(dev, card, dataset, vis_block: int) -> None:
    """One CLI channel (channel 0) through ``imager.run`` with both
    profile dumps: the flamegraph names the frontend's stages and the
    device profile names K1-K4 with nonzero time; the five largest
    device ops."""
    import os
    import re
    import tempfile

    from katsdpimager_tpu_torch import frontend, imager

    class CleanOnly(frontend.Writer):
        def needs_fits_image(self, name):
            return False

        def needs_fits_grid(self, name):
            return False

        def write_fits_image(self, *args, **kwargs):
            pass

        def write_fits_grid(self, *args, **kwargs):
            pass

    kernels = {"K1": "grid_planes_kernel", "K2": "combine_planes_kernel",
               "K3": "cb_col_fft_kernel", "K4": "epi_col_fft_kernel"}
    stages = ("preprocess_visibilities", "process_channel;make_weights",
              "process_channel;make_dirty")
    with tempfile.TemporaryDirectory() as tmp:
        args = imager_args(0, False, vis_block)
        args.write_profile = os.path.join(tmp, "profile.txt")
        args.write_device_profile = os.path.join(tmp, "device.txt")
        t = time.perf_counter()
        imager.run(args, dataset, CleanOnly(), device=dev)
        seconds = time.perf_counter() - t
        with open(args.write_profile) as f:
            host = [ln.rsplit(" ", 1) for ln in f.read().splitlines()]
        with open(args.write_device_profile) as f:
            device = [ln.rsplit(" ", 1) for ln in f.read().splitlines()]
    host_stacks = {stack for stack, _ in host}
    kernel_us = {name: sum(int(us) for op, us in device
                           if re.search(r"\b%s\b" % fn, op))
                 for name, fn in kernels.items()}
    checks = {"stages_named": all(st in host_stacks for st in stages),
              "k1_k4_nonzero": all(us > 0 for us in kernel_us.values())}
    emit({"phase": "profile", "card": card, "seconds": seconds,
          "host_lines": len(host), "device_lines": len(device),
          "kernel_us": kernel_us,
          "top_device_us": [[op[:80], int(us)] for op, us in device[:5]],
          **checks})
    if not all(checks.values()):
        raise AssertionError(f"profile phase failed: {checks}")



def pipeline_args(argv):
    """``pipeline``'s arguments for the simulated observation
    (``"simulated"``: the dataset is in memory)."""
    from katsdpimager_tpu_torch import arguments, pipeline

    return pipeline.get_parser().parse_args(
        ["simulated"] + argv, namespace=arguments.SmartNamespace())


def cube_argv(out, vis_block: int, channels=(0, 1), extra=()):
    """``pipeline --cube`` at full width on the simulated observation: 4096
    px, K = 60, 2 majors, a fixed CLEAN patch of 65 (a 2-rank wave then
    compares with waves of one channel at any patch need)."""
    return [out, "--cube", "--pixels", "4096", "--kernel-width", "60",
            "--stokes", "I", "--major", "2", "--no-tmp-file", "--vis-block",
            str(vis_block), "--no-thumbnails", "--cube-psf-patch", "65",
            "-c", str(channels[0]), "-C", str(channels[1]), *extra]


def cube_double_phase(dev, card, dataset, vis_block: int,
                      parent=None) -> None:
    """``pipeline --cube --precision double`` on channel 0 of the CLI's
    observation (4096 px, K = 60, 2 majors; cut to one channel) against
    the same run at float32 on the card: the dirty image (CLEAN's first
    input) within 1e-4 of the float32 run's dirty peak inside the field,
    the same CLEAN components there, float64 images, K1 and K5 launched;
    the restored images' and models' differences printed, not gated
    (CLEAN's components drift between float32 and float64 runs, in the
    JAX package as much: tests/test_torch_imager.py), and both runs'
    seconds.  With the parent's K1 (``parent``), its dirty images' error
    is printed beside (K1 fills float32 planes at both precisions, so this
    comparison does not see K1's own error: ``k1_image`` does)."""
    import os
    import tempfile

    import numpy as np

    from katsdpimager_tpu_torch import io, pipeline
    from katsdpimager_tpu_torch.ops import wkernel
    from katsdpimager_tpu_torch.parallel import cube

    counters = kernel_counters()

    def run(tmp, name, extra):
        out = os.path.join(tmp, name)
        args = pipeline_args(cube_argv(out, vis_block, (0, 1), extra))
        cap = {"inputs": [], "models": []}
        clean_stage = cube._clean_stage

        def capture(cfg, residual, *a):
            cap["inputs"].append(residual.cpu().numpy())
            result = clean_stage(cfg, residual, *a)
            cap["models"].append(result[1].cpu().numpy())
            return result

        cube._clean_stage = capture
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        t = time.perf_counter()
        try:
            pipeline.run(args, dataset,
                         pipeline.PipelineWriter(out, thumbnails=False),
                         device=dev)
            torch.cuda.synchronize()
        finally:
            cube._clean_stage = clean_stage
        cap["seconds"] = time.perf_counter() - t
        cap["launches"] = dict(zip(KERNEL_NAMES,
                                   [fn.launches for fn in counters]))
        header, data = io.read_fits(os.path.join(
            out, "image_00000_clean.fits"))
        cap["restored"], cap["bitpix"] = np.asarray(data)[0, 0], \
            header["BITPIX"]
        with open(os.path.join(out, "state.json")) as f:
            cap["state"] = json.load(f)
        return cap

    with tempfile.TemporaryDirectory() as tmp:
        single = run(tmp, "single", [])
        double = run(tmp, "double", ["--precision", "double"])
        if parent is not None:
            with k1_swapped(parent):
                parents = [run(tmp, "parent_" + name, extra)["inputs"][0]
                           for name, extra in (
                               ("single", []),
                               ("double", ["--precision", "double"]))]
    N = single["restored"].shape[-1]
    taper = wkernel.taper(N, 7.0, 8, wkernel.default_beta(7.0))
    t2 = np.outer(taper, taper)
    inside = t2 >= 0.002 * t2.max()
    dirty_s, dirty_d = single["inputs"][0], double["inputs"][0]
    peak = float(np.abs(dirty_s).max())
    dirty_err = float(np.abs(dirty_d - dirty_s)[:, inside].max()) / peak
    parent_err = None if parent is None else float(np.abs(
        parents[1] - parents[0])[:, inside].max()) / float(
            np.abs(parents[0]).max())
    model_s, model_d = single["models"][-1], double["models"][-1]
    same = bool(np.array_equal((model_s != 0)[:, inside],
                               (model_d != 0)[:, inside]))
    restored_err = float(np.abs(double["restored"] - single["restored"])[
        inside].max()) / peak
    model_err = float(np.abs(model_d - model_s)[:, inside].max()) / peak
    minor = [double["state"]["stats/0"]["minor"],
             single["state"]["stats/0"]["minor"]]
    f64 = (dirty_d.dtype == model_d.dtype == np.float64
           and double["bitpix"] == -64)
    finite = bool(np.isfinite(double["restored"][inside]).all()
                  and np.isfinite(dirty_d).all())
    ran = double["launches"]["K1"] > 0 and double["launches"]["K5"] > 0
    ok = dirty_err <= 1e-4 and same and f64 and finite and ran
    emit({"phase": "cube_double", "card": card, "pixels": N,
          "kernel_width": 60, "majors": 2, "channels": 1,
          "dirty_max_err_inside_over_dirty_peak": dirty_err,
          "parent_k1_dirty_max_err_inside_over_dirty_peak": parent_err,
          "tolerance": 1e-4, "dirty_peak": peak,
          "same_component_positions_inside": same,
          "components_inside": int((model_d != 0)[:, inside].sum()),
          "minor_double_single": minor,
          "restored_max_err_inside_over_dirty_peak_not_gated": restored_err,
          "model_max_err_inside_over_dirty_peak_not_gated": model_err,
          "float64": f64, "finite": finite, "seconds": double["seconds"],
          "single_seconds": single["seconds"],
          "launches": double["launches"],
          "single_launches": single["launches"], "ok": ok})
    if not ok:
        raise AssertionError("cube_double failed")


@contextlib.contextmanager
def k1_swapped(run):
    """K1's wrapper replaced, for the block, by ``run`` (the parent copy's
    ``ktt_grid_planes``, :func:`parent_k1`), with its own launch count."""
    from katsdpimager_tpu_torch.ops import fused_gridder

    saved = fused_gridder.grid_planes

    def swapped(*args, ts):
        run(*args, ts)
        swapped.launches += 1

    swapped.launches = 0
    fused_gridder.grid_planes = swapped
    try:
        yield
    finally:
        fused_gridder.grid_planes = saved


def float64_grid_slice(kernel, density, plan_uv, plan_sub, plan_wp,
                       plan_vis, plan_anchor, plan_valid, n_chunks, *,
                       pixels: int, ts: int, dw_chunks=None, out=None):
    """``fused_gridder.grid_slice`` onto float64 grid planes ``out`` at
    float64 throughout, for natural weights: K1's plain version on
    float64 samples into float64 colour planes, each occupied block added
    onto the float64 grid."""
    from katsdpimager_tpu_torch.ops import fused_gridder, mxu_gridder

    if density is not None or dw_chunks is not None or out is None:
        raise NotImplementedError("natural weights onto given planes only")
    grid = out
    nt2 = mxu_gridder.colour_tiles(pixels, ts)
    iu, iv, su, sv = fused_gridder.tap_indices(
        kernel, plan_uv, plan_sub, plan_wp, plan_anchor, pixels=pixels,
        ts=ts)
    sample = (plan_vis.to(torch.complex128)
              * plan_valid[..., None]).transpose(-1, -2)
    slot = fused_gridder.chunk_slots(plan_anchor, n_chunks, ts=ts, nt2=nt2)
    P = plan_vis.shape[-1]
    ext2 = nt2 * 2 * ts
    planes = [torch.zeros((2, 2, P, ext2, ext2), dtype=torch.float64,
                          device=plan_vis.device) for _ in range(2)]
    fused_gridder.grid_planes_plain(
        slot, n_chunks, fused_gridder.valid_counts(plan_valid), iu, iv, su,
        sv, sample.real.contiguous(), sample.imag.contiguous(),
        fused_gridder.conj_table(kernel).to(torch.complex128), *planes,
        ts=ts)
    occ = fused_gridder.occupancy(slot, n_chunks, nt2)
    for plane, g in zip(planes, grid):
        for a in range(2):
            for b in range(2):
                m = occ[a, b].repeat_interleave(2 * ts, 0).repeat_interleave(
                    2 * ts, 1)
                g[:, a * ts:, b * ts:] += torch.where(m, plane[a, b], 0.0)[
                    :, :pixels - a * ts, :pixels - b * ts]
    return grid


def k1_image_phase(card, cfg, batch, inside, mc, parent) -> None:
    """K1's error as the dirty image sees it: channel 0 of the step's
    batch imaged at float64 throughout (K1's plain version at float64,
    :func:`float64_grid_slice`, then the double route: grids, transforms
    and taper at float64) as the reference; against it, the float32 step
    and the double route as the port runs it (K1's float32 planes, the
    rest at float64: K1's own share), over the reference's peak inside
    the field; with the parent's K1 (``parent``) beside.  Printed, not
    gated: the batch is noise, whose dirty peak is low (the step's gate
    against its plain version is ``step_parity``'s)."""
    from katsdpimager_tpu_torch.ops import fused_gridder

    db = batch._replace(taper1d=batch.taper1d.double(),
                        pixel_size=batch.pixel_size.double(),
                        mid_w=batch.mid_w.double(),
                        vis=batch.vis.to(torch.complex128))
    step = mc.single_channel_step(cfg)

    def image(b):
        return step(*mc.channel_args(b, 0))[0].double()

    saved = fused_gridder.grid_slice
    fused_gridder.grid_slice = float64_grid_slice
    try:
        ref = image(db)
    finally:
        fused_gridder.grid_slice = saved
    peak = ref.abs().max().item()

    def errors():
        return {name: (image(b) - ref).abs()[:, inside].max().item() / peak
                for name, b in (("step_float32", batch),
                                ("double_route_k1_float32", db))}

    line = {"phase": "k1_image", "card": card, "channel": 0,
            "float64_peak": peak, "err_inside_over_float64_peak": errors()}
    if parent is not None:
        with k1_swapped(parent):
            line["parent_k1_err_inside_over_float64_peak"] = errors()
    emit(line)


#: Seconds a torchrun launch of the distributed phase may take.
TORCHRUN_TIMEOUT_S = 600


def torchrun(nproc: int, argv, timeout: float = TORCHRUN_TIMEOUT_S) -> float:
    """Run ``chip_smoke.py --rank-worker *argv`` on ``nproc`` ranks through
    ``python -m torch.distributed.run`` (gloo: the ranks share the card),
    in a session of its own that is killed whole if it outlives
    ``timeout``; raise unless every rank exits 0.  Returns the seconds."""
    import os
    import signal

    from katsdpimager_tpu_torch.parallel import launch

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
           str(nproc), "--master-addr", "localhost", "--master-port",
           str(launch.free_port()), os.path.abspath(__file__),
           "--rank-worker", *argv]
    t = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"torchrun {argv} outlived {timeout} s")
    if proc.returncode != 0:
        raise AssertionError(f"torchrun {argv} exited {proc.returncode}:\n"
                             f"{out[-6000:]}")
    return time.perf_counter() - t


def coordinator_run(nproc: int, argv, out,
                    timeout: float = TORCHRUN_TIMEOUT_S) -> float:
    """Run ``chip_smoke.py --rank-worker *argv`` as ``nproc`` processes
    joined by ``--coordinator localhost:PORT --num-processes nproc
    --process-id i``, with no ``torchrun`` variables in their
    environment; each writes its output to ``out/coord<i>.log``.  Every
    process runs in a session of its own, all killed if one outlives
    ``timeout``; raise unless each exits 0.  Returns the seconds."""
    import os
    import signal

    from katsdpimager_tpu_torch.parallel import launch

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE", "GROUP_WORLD_SIZE",
                        "MASTER_ADDR", "MASTER_PORT")
           and not k.startswith("TORCHELASTIC")}
    coordinator = f"localhost:{launch.free_port()}"
    t = time.perf_counter()
    procs = []
    try:
        for i in range(nproc):
            with open(os.path.join(out, f"coord{i}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--rank-worker", *argv, "--coordinator", coordinator,
                     "--num-processes", str(nproc), "--process-id", str(i)],
                    stdout=log, stderr=subprocess.STDOUT, env=env,
                    start_new_session=True))
        codes = [p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t)))
                 for p in procs]
    except subprocess.TimeoutExpired:
        raise AssertionError(f"--coordinator {argv} outlived {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    if any(codes):
        tails = []
        for i in range(nproc):
            with open(os.path.join(out, f"coord{i}.log")) as f:
                tails.append(f.read()[-3000:])
        raise AssertionError(f"--coordinator {argv} exited {codes}:\n"
                             + "\n".join(tails))
    return time.perf_counter() - t


def rank_worker(argv) -> None:
    """One rank of :func:`distributed_phase`, started by ``torchrun``
    (or by :func:`coordinator_run`): ``pipeline OUT VIS_SHARDS [pipeline
    options]`` runs ``pipeline.run --cube`` on the simulated
    observation's 2 channels, joining the group as ``pipeline.main`` does
    (``--coordinator``, ``--num-processes`` and ``--process-id`` among
    the options, else ``torchrun``'s environment); ``step OUT`` the
    bench-shape step (2 channels) at vis 2.  Each rank joins with the
    backend ``initialize_distributed`` picks (gloo: the ranks outnumber
    the card), logs the mesh's join line and writes to
    ``OUT/rank<r>.json`` its backend, host layout, device, seconds,
    all-reduce counts and seconds (its ``mesh.psum`` spans, taken by a
    ``CollectProfiler``), and the launches of K1-K7 in the
    timed run (the
    counters set to 0 just before it); rank 0 of the step also the dirty
    images (``OUT/dirty.npy``).  The step's ranks then time 3 all-reduces
    of a 4096 px plane pair on idle ranks (synchronised, after a
    barrier): the transfer alone."""
    import logging
    import os

    import numpy as np

    from katsdpimager_tpu_torch import pipeline, profiling
    from katsdpimager_tpu_torch.parallel import mesh
    from katsdpimager_tpu_torch.parallel import multichannel as mc

    torch.backends.cuda.matmul.allow_tf32 = False
    logging.basicConfig(level=logging.WARNING)
    logging.getLogger(mesh.__name__).setLevel(logging.INFO)
    kind, out = argv[0], argv[1]
    if kind == "pipeline":
        args = pipeline_args(cube_argv(os.path.join(out, "images"),
                                       IMAGER_VIS_BLOCK, (0, 2),
                                       ["--vis-shards", argv[2], *argv[3:]]))
        mesh.initialize_distributed(args.coordinator, args.num_processes,
                                    args.process_id)
    else:
        mesh.initialize_distributed()
    rank = mesh.rank()
    line = {"rank": rank, "backend": torch.distributed.get_backend(),
            "layout": mesh.local_layout()._asdict(),
            "device": str(mesh.default_device())}
    counters = kernel_counters()
    prof = profiling.CollectProfiler()

    def zero_counts():
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0

    if kind == "pipeline":
        dataset, _ = sim_dataset(64, 1024, 2, noise_jy=1.0)
        zero_counts()
        t = time.perf_counter()
        with profiling.installed(prof):
            timings = pipeline.run(args, dataset, pipeline.PipelineWriter(
                os.path.join(out, "images"), thumbnails=False))
        torch.cuda.synchronize()
        line.update(seconds=time.perf_counter() - t, waves=timings)
        line["launches"] = dict(zip(KERNEL_NAMES,
                                    [fn.launches for fn in counters]))
    else:
        m = mesh.make_mesh(2)
        batch = mc.make_example_batch(bench_config(), 2, vis_per_slice=1 << 19,
                                      device="cpu")
        local = mc.local_batch(m, batch)
        step = mc.make_imaging_step(m, bench_config())
        step(local)
        torch.cuda.synchronize()
        calls = mesh.psum.calls
        zero_counts()
        t = time.perf_counter()
        with profiling.installed(prof):
            dirty = step(local)[0]
        torch.cuda.synchronize()
        line.update(seconds=time.perf_counter() - t,
                    num_vis=int(local.valid.sum()))
        line["launches"] = dict(zip(KERNEL_NAMES,
                                    [fn.launches for fn in counters]))
        if rank == 0:
            np.save(os.path.join(out, "dirty.npy"), dirty.cpu().numpy())
        mesh.psum.calls -= calls
        N = bench_config().pixels
        pair = [torch.ones((1, N, N), device=m.device) for _ in range(2)]
        idle = []
        for _ in range(3):
            torch.cuda.synchronize()
            torch.distributed.barrier()
            t = time.perf_counter()
            for x in pair:
                torch.distributed.all_reduce(x, group=m.vis_group)
            torch.cuda.synchronize()
            idle.append(time.perf_counter() - t)
        line["idle_pair_all_reduce_s"] = idle
    line.update(psum_calls=mesh.psum.calls, psum_s=prof.seconds("mesh.psum"))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(line, f)
    torch.distributed.destroy_process_group()


def production_slice(cfg):
    """Channel 0, slice 0 of the step's batch (:func:`bench_config`, 2^19
    visibilities a slice) as drawn, before planning: the first draws of
    ``make_example_batch`` (seed 0), as numpy (uv, sub_uv, w_plane, vis,
    weights)."""
    import numpy as np

    rng = np.random.default_rng(0)
    n, P = 1 << 19, cfg.num_pols
    lim = cfg.pixels // 2 - cfg.kernel_width - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    sub = rng.integers(0, cfg.oversample, size=(n, 2)).astype(np.int16)
    wp = rng.integers(0, cfg.w_planes, size=n).astype(np.int16)
    vis = (rng.normal(size=(n, P))
           + 1j * rng.normal(size=(n, P))).astype(np.complex64)
    wt = rng.uniform(0.5, 2.0, size=(n, P)).astype(np.float32)
    return uv, sub, wp, vis, wt


def device_plan_phase(dev, card, cfg, batch, rows) -> None:
    """The device planner (``mxu_gridder.plan_chunks_tiled_device``) at
    the production slice (channel 0, slice 0 of the step's batch): every
    ``ChunkPlan`` field bitwise equal to the host planner's plan, which
    is the batch's own slice; K1 + K2 grid both plans to bitwise equal
    planes (the counters set to 0 just before gridding from the device
    plan: K1 and K2 must launch); with ``nc`` below the chunk count,
    ``n_chunks`` the true count and the kept chunks unchanged; the
    planner makes no host sync (``set_sync_debug_mode("error")``).
    Times: the device planner by CUDA events (median of 10) and one
    profiled call (device busy time, largest ops, host enqueue seconds),
    the host planner (median of 3) and ``MxuGridder.upload_plan`` of its
    plan (median of 3, ending in a synchronize)."""
    import statistics

    import numpy as np

    from katsdpimager_tpu_torch import imaging, native
    from katsdpimager_tpu_torch.ops import fused_gridder, mxu_gridder

    raw = production_slice(cfg)
    kw = dict(pixels=cfg.pixels, kernel_width=cfg.kernel_width, ts=cfg.rv,
              mc=cfg.chunk_size)
    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        host = mxu_gridder.plan_chunks_tiled(*raw, **kw)
        host_s.append(time.perf_counter() - t0)
    nc = host.uv.shape[0]
    n_chunks = int(host.valid.any(axis=1).sum())
    checks = {"host_plan_is_the_batch_slice": n_chunks == int(
        batch.n_chunks[0, 0]) and all(
        np.array_equal(getattr(host, f)[:n_chunks],
                       getattr(batch, f)[0, 0, :n_chunks].cpu().numpy())
        for f in ("uv", "sub_uv", "w_plane", "vis", "weights", "anchor",
                  "valid"))}

    gridder = imaging.MxuGridder(pixels=cfg.pixels,
                                 kernel_width=cfg.kernel_width, device=dev)
    upload_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gridder.upload_plan(host)
        torch.cuda.synchronize()
        upload_s.append(time.perf_counter() - t0)

    inputs = [torch.from_numpy(a).to(dev) for a in raw]

    def plan(nc_):
        return mxu_gridder.plan_chunks_tiled_device(*inputs, **kw, nc=nc_,
                                                    device=dev)

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = plan(nc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    device_ms = []
    for _ in range(10):
        device_ms.append(cuda_ms(lambda: plan(nc), 1))
    # Where its time goes: one planner call under torch.profiler (device
    # busy time, the largest device ops) and the host's seconds to
    # enqueue it.
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plan(nc)
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    busy_ms, by_op = device_busy_ms(prof)
    checks["profiled_device_work"] = busy_ms > 0
    checks["fields_bitwise_equal"] = all(
        np.array_equal(got[f].cpu().numpy(), getattr(host, f))
        for f in mxu_gridder.ChunkPlan._fields)
    checks["n_chunks_equal"] = int(got["n_chunks"]) == n_chunks

    # K1 + K2 from each plan, natural weights (no density), the occupied
    # chunks only, as the step grids a slice.
    kern = batch.kernel[0]
    fields = ("uv", "sub_uv", "w_plane", "vis", "anchor", "valid")

    def grid(p):
        return fused_gridder.grid_slice(
            kern, None, *(p[f] for f in fields), n_chunks,
            pixels=cfg.pixels, ts=cfg.rv)

    want = grid({f: torch.from_numpy(getattr(host, f)).to(dev)
                 for f in fields})
    counters = (fused_gridder.grid_planes, fused_gridder.combine_planes)
    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    planes = grid(got)
    torch.cuda.synchronize()
    launches = [fn.launches for fn in counters]
    checks["planes_bitwise_equal"] = all(
        torch.equal(a, b) for a, b in zip(planes, want))
    checks["k1_k2_launched"] = min(launches) > 0
    checks["planes_finite_nonzero"] = bool(
        torch.isfinite(planes[0]).all() and planes[0].abs().max() > 0)
    for row, count in zip(rows, launches):
        row["device_plan_launches"] = count
    del want, planes

    short = nc // 2
    cut = plan(short)
    checks["overflow_counts_every_chunk"] = (
        int(cut["n_chunks"]) == n_chunks > short)
    checks["overflow_keeps_the_first_chunks"] = all(
        np.array_equal(cut[f].cpu().numpy(), getattr(host, f)[:short])
        for f in ("uv", "sub_uv", "w_plane", "vis", "weights", "anchor",
                  "valid")) and all(
        np.array_equal(cut[f].cpu().numpy(), getattr(host, f))
        for f in ("row_chunk", "row_slot"))
    emit({"phase": "device_plan", "card": card, "num_vis": len(raw[0]),
          "n_chunks": n_chunks, "nc": nc, "overflow_nc": short,
          "runs": int(np.count_nonzero(np.diff(
              host.anchor[:n_chunks], axis=0).any(axis=1))) + 1,
          "device_planner_ms_median_of_10": statistics.median(device_ms),
          "device_planner_ms": device_ms,
          "device_planner_busy_ms": busy_ms,
          "device_planner_enqueue_s_profiled": enqueue_s,
          "device_planner_top_device_ms": sorted(
              by_op.items(), key=lambda kv: -kv[1])[:8],
          "host_planner_s_median_of_3": statistics.median(host_s),
          "host_planner_s": host_s, "native_packer": native.available(),
          "upload_plan_s_median_of_3": statistics.median(upload_s),
          "upload_plan_s": upload_s,
          "launches": dict(zip(("K1", "K2"), launches)), **checks})
    if not all(checks.values()):
        raise AssertionError(f"device_plan phase failed: {checks}")


def bench_config():
    """The dirty step's shape, ``bench.py``'s (``bench.py:215-228``): 4096
    px, K = 60, oversample 8, 32 W planes, 4 W slices, 8192 chunks of 256,
    natural weights, no CLEAN."""
    from katsdpimager_tpu_torch.parallel import multichannel as mc

    return mc.MultiChannelConfig(
        pixels=4096, num_pols=1, kernel_width=60, oversample=8,
        w_planes=32, w_slices=4, chunks_per_slice=8192, chunk_size=256,
        rv=64, ru=64, minor_cycles=0, weight_type="natural")


def distributed_phase(dev, card, dataset, vis_block: int) -> None:
    """The mesh on the one card: ranks of one ``torchrun`` sharing it over
    gloo.  ``pipeline --cube`` on the CLI's observation (2 channels, 4096
    px, K = 60, 2 majors, fixed patch 65) at (chan 2, vis 1) and (chan 1,
    vis 2) against the 1-rank run in this process: the restored images
    within 1e-6 of its peak (the chan split) and within 1e-4 inside the
    field (the vis split); each rank's seconds a channel, its seconds
    blocked in all-reduce (its own kernels synchronised first) and its
    launches of K1-K7 and K23, which must show K1, K5 and K23 (the chan
    split) or K2 (the vis split) on every rank: K1 and K23 summed over
    the chan split's ranks as in the 1-rank run, and at
    most its K1 on a vis rank (a slice whose chunks all lie on the other
    rank launches no K1 here).  Then the chan split once more in the
    ``--coordinator`` form (:func:`coordinator_run`, no ``torchrun``
    variables): each rank must log and report one host of 2 ranks, gloo
    and ``cuda:0``, and the images must be bitwise the ``torchrun``
    run's.  Then the bench-shape step (2 channels) at vis 2 against the
    unsharded step, within 1e-4 of the peak inside the field, K1 and K2
    launched on both ranks, and an all-reduce of a plane pair on idle
    ranks.  Every rank must have joined over gloo."""
    import os
    import tempfile

    import numpy as np

    from katsdpimager_tpu_torch import io, pipeline
    from katsdpimager_tpu_torch.ops import wkernel
    from katsdpimager_tpu_torch.parallel import mesh
    from katsdpimager_tpu_torch.parallel import multichannel as mc

    def images(out):
        return [np.asarray(io.read_fits(os.path.join(
            out, f"image_{c:05d}_clean.fits"))[1])[0, 0] for c in range(2)]

    def ranks(out, n):
        lines = []
        for r in range(n):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                lines.append(json.load(f))
        return lines

    counters = kernel_counters()
    with tempfile.TemporaryDirectory() as tmp:
        ref_out = os.path.join(tmp, "one")
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        t = time.perf_counter()
        pipeline.run(pipeline_args(cube_argv(ref_out, vis_block, (0, 2))),
                     dataset, pipeline.PipelineWriter(ref_out,
                                                      thumbnails=False),
                     device=dev)
        torch.cuda.synchronize()
        one_seconds = time.perf_counter() - t
        one_launches = dict(zip(KERNEL_NAMES,
                                [fn.launches for fn in counters]))
        ref = images(ref_out)
        peak = max(float(np.abs(r).max()) for r in ref)
        N = ref[0].shape[-1]
        taper = wkernel.taper(N, 7.0, 8, wkernel.default_beta(7.0))
        t2 = np.outer(taper, taper)
        inside = t2 >= 0.002 * t2.max()
        results, ok = {}, True
        for name, vis_shards, tol, where in (
                ("chan 2, vis 1", 1, 1e-6, None),
                ("chan 1, vis 2", 2, 1e-4, inside)):
            out = os.path.join(tmp, name.replace(", ", "_").replace(" ", ""))
            os.makedirs(out)
            wall = torchrun(2, ["pipeline", out, str(vis_shards)])
            got = images(os.path.join(out, "images"))
            err = max(float(np.abs(g - r)[where if where is not None
                                          else slice(None)].max())
                      for g, r in zip(got, ref)) / peak
            lines = ranks(out, 2)
            launches = [ln["launches"] for ln in lines]
            # the chan split's slice loop takes K23, the vis split's K2
            # (its grid is summed over the group before K3)
            k2 = "K23" if vis_shards == 1 else "K2"
            every = all(ln[k] > 0 for ln in launches
                        for k in ("K1", k2, "K5"))
            if vis_shards == 1:
                counted = all(sum(ln[k] for ln in launches)
                              == one_launches[k] for k in ("K1", k2))
            else:
                counted = all(ln["K1"] <= one_launches["K1"]
                              for ln in launches)
            results[name] = {
                "max_err_over_peak": err, "tolerance": tol,
                "compared": "everywhere" if where is None
                else "inside the field",
                "torchrun_seconds": wall,
                "rank_seconds": [ln["seconds"] for ln in lines],
                "s_per_channel": max(ln["seconds"] for ln in lines) / 2,
                "all_reduce_calls": [ln["psum_calls"] for ln in lines],
                "blocked_in_all_reduce_s": [ln["psum_s"] for ln in lines],
                "launches": launches, "launches_ok": every and counted,
                "backends": [ln["backend"] for ln in lines],
                "layouts": [ln["layout"] for ln in lines],
                "devices": [ln["device"] for ln in lines],
                "waves": lines[0]["waves"]}
            ok = (ok and err <= tol and every and counted
                  and all(ln["backend"] == "gloo" for ln in lines)
                  and all(np.isfinite(g[inside]).all() for g in got))

        # The chan split again in the --coordinator form: 2 processes with
        # no torchrun variables, each finding the host's layout through
        # the rendezvous store; the images bitwise the torchrun run's.
        out = os.path.join(tmp, "coordinator")
        os.makedirs(out)
        wall = coordinator_run(2, ["pipeline", out, "1"], out)
        got = images(os.path.join(out, "images"))
        same = all(np.array_equal(g, w) for g, w in zip(
            got, images(os.path.join(tmp, "chan2_vis1", "images"))))
        lines = ranks(out, 2)
        logged = []
        for r in range(2):
            with open(os.path.join(out, f"coord{r}.log")) as f:
                logged.append([ln for ln in f.read().splitlines()
                               if "distributed: rank" in ln])
        layouts_ok = all(
            ln["layout"] == {"local_rank": r, "local_world": 2,
                             "backend": "gloo", "hosts": 1}
            and ln["device"] == "cuda:0" and ln["backend"] == "gloo"
            and len(logged[r]) == 1
            and (f"rank {r} of 2, 1 host(s), local rank {r} of 2, backend "
                 f"gloo, device cuda:0") in logged[r][0]
            for r, ln in enumerate(lines))
        results["coordinator chan 2, vis 1"] = {
            "bitwise_equal_to_torchrun": same, "seconds": wall,
            "rank_seconds": [ln["seconds"] for ln in lines],
            "layouts": [ln["layout"] for ln in lines],
            "devices": [ln["device"] for ln in lines],
            "logged": [lg[0] if lg else None for lg in logged],
            "launches": [ln["launches"] for ln in lines],
            "layouts_ok": layouts_ok}
        ok = ok and same and layouts_ok

        out = os.path.join(tmp, "step")
        os.makedirs(out)
        wall = torchrun(2, ["step", out])
        got = np.load(os.path.join(out, "dirty.npy"))
        batch = mc.make_example_batch(bench_config(), 2, vis_per_slice=1 << 19,
                                      device="cpu")
        one = mesh.make_mesh(1, device=dev)
        want = mc.make_imaging_step(one, bench_config())(
            mc.local_batch(one, batch))[0].cpu().numpy()
        tap = batch.taper1d[0].double().numpy()
        t2s = np.outer(tap, tap)
        step_inside = t2s >= 0.002 * t2s.max()
        step_err = float(np.abs(got - want)[..., step_inside].max()) \
            / float(np.abs(want).max())
        lines = ranks(out, 2)
        launches = [ln["launches"] for ln in lines]
        every = all(ln[k] > 0 for ln in launches for k in ("K1", "K2"))
        results["step chan 1, vis 2"] = {
            "max_err_inside_over_peak": step_err, "tolerance": 1e-4,
            "torchrun_seconds": wall,
            "rank_step_seconds": [ln["seconds"] for ln in lines],
            "all_reduce_calls": [ln["psum_calls"] for ln in lines],
            "blocked_in_all_reduce_s": [ln["psum_s"] for ln in lines],
            "idle_pair_all_reduce_s": [ln["idle_pair_all_reduce_s"]
                                       for ln in lines],
            "launches": launches, "launches_ok": every,
            "backends": [ln["backend"] for ln in lines]}
        ok = (ok and step_err <= 1e-4 and every
              and all(ln["backend"] == "gloo" for ln in lines))
    emit({"phase": "distributed", "card": card, "backend": "gloo",
          "ranks": 2, "cards": torch.cuda.device_count(), "pixels": N,
          "kernel_width": 60, "channels": 2,
          "one_rank_seconds": one_seconds, "one_rank_launches": one_launches,
          "runs": results, "ok": ok})
    if not ok:
        raise AssertionError("distributed phase failed")




if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(sys.argv[2:])
    else:
        main()
