"""Drive the PyTorch/CUDA port's dirty-image step once on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels (K1-K4) from ``katsdpimager_tpu_torch/csrc``,
builds the production batch (8 channels, 4096 px, K=60, oversample 8,
32 W planes, 4 W slices, 2^19 visibilities per slice, natural weights),
checks every kernel against its plain PyTorch version at the main path's
shapes and times both, runs the 8-channel step through
``multichannel.single_channel_step`` (1 warm-up, 3 timed iterations) with
the kernels' launch counters reset just before, and checks channel 0's
dirty image against the all-plain step.  Each phase prints one JSON line;
the card's name and power limit, the kernel table and, last, the ``ok``
line follow.  Any failure raises: the exit code is then non-zero.

It imports no JAX.
"""

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

    from katsdpimager_tpu_torch.ops import (_build, fused_fft, fused_gridder,
                                            mxu_gridder)
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
    del kr, ki, pr, pi, out, img_k, img_p, par, pai, ar, ai, gr, gi

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
        row["launches"] = count

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

    print(card, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
