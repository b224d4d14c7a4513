"""K1's design search on the card: one-change copies of its source, timed
in turns against the tree's kernel.

Run from the repository root on a machine with a CUDA card:

    python k1_variants.py [name,name,...]

Each variant is the tree's ``katsdpimager_tpu_torch/csrc/gridder.cu``
(with its ``wgmma.cuh``) with one change (:data:`VARIANTS`), built with
the port's flags into ``_archive/k1_variants/<name>/`` (git-ignored), all
at once.  Then, at the production slice (``chip_smoke.py``'s step,
channel 0, slice 0), on the 128-chunk runs at ts 64 and 32 and on some
``tiles`` cases, each variant's time in turns against the tree's K1
(tree, variant, variant, tree; 20 launches each) and, where the copy of
the parent's kernel lies at ``chip_smoke.PARENT_K1_SOURCE``, the parent's;
and each variant's planes against the tree's (bitwise) and its error over
the peak of a float64 run of the plain version.  The diagnostics
(``no_gathers``, ``no_stores``) give wrong sums by design; the
sensitivities (``producer_x2``, ``consumer_x2``) do some work twice.
One JSON line per case; the card's name and power limit first.

The variants are literal edits of the source: a variant whose text is no
longer in the source once stops the script before anything is built,
and is brought up to date with the source or dropped.
"""

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from katsdpimager_tpu_torch.ops import _build, fused_gridder

CSRC = os.path.join("katsdpimager_tpu_torch", "csrc")
OUT = os.path.join("_archive", "k1_variants")

_ISSUE = "      band_issue<BN>(acc_r, acc_i, ring + st * R::kStage, cb);"
_STAGE = ("  stage_batch<BN, kPad>(ring + st * R::kStage, cs[w.cur], mb, cb, "
          "tab, K,\n                        ts2, w.jr0, w.jc0, pt);")
_GATHER_A = "ta[a][u] = tab[ivs[u] * K + dv];"
_GATHER_B = "tb[b][u] = tab[ius[u] * K + du];"
_STORE_A = ("      *reinterpret_cast<float4*>(S + q * R::kPlaneA + off) =\n"
            "          make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);")
_STORE_B = ("      *reinterpret_cast<float4*>(S + 4 * R::kPlaneA + "
            "q * R::kPlaneB +\n                                 off) =\n"
            "          make_float4(v[q][0], v[q][1], v[q][2], v[q][3]);")

#: name: (kind, [(text in gridder.cu or wgmma.cuh, its replacement)]).
VARIANTS = {
    "turns_off": ("design", [(
        "  constexpr bool kTurns = R::kLanes == 1;  // one lane: issue in "
        "turn", "  constexpr bool kTurns = false;")]),
    "stages_2": ("design", [("constexpr int kStagesOne = 3;",
                             "constexpr int kStagesOne = 2;")]),
    "stages_4": ("design", [("constexpr int kStagesOne = 3;",
                             "constexpr int kStagesOne = 4;"),
                            ("constexpr int kStagesTwo = 2;",
                             "constexpr int kStagesTwo = 3;")]),
    "cvt_round": ("design", [(
        "  return __uint_as_float((__float_as_uint(x) + 0x1000u) & "
        "~0x1FFFu);", "  return __uint_as_float(tf32_rna(x));")]),
    "ldcg": ("design", [(_GATHER_A, "ta[a][u] = __ldcg(tab + ivs[u] * K "
                                    "+ dv);"),
                        (_GATHER_B, "tb[b][u] = __ldcg(tab + ius[u] * K "
                                    "+ du);")]),
    **{f"item_weight_{w}": ("design", [("constexpr int kItemWeight = 1;",
                                        f"constexpr int kItemWeight = {w};")])
       for w in (0, 2, 3, 4)},
    "producer_x2": ("sensitivity", [(_STAGE, _STAGE + "\n" + _STAGE)]),
    "consumer_x2": ("sensitivity", [(_ISSUE, _ISSUE + "\n" + _ISSUE)]),
    "no_gathers": ("diagnostic", [
        (_GATHER_A, "ta[a][u] = make_float2(__int_as_float(ivs[u]), "
                    "__int_as_float(dv));"),
        (_GATHER_B, "tb[b][u] = make_float2(__int_as_float(ius[u]), "
                    "__int_as_float(du));")]),
    "no_stores": ("diagnostic", [
        (_STORE_A, "      if (v[q][0] == 1234.5f)\n"
                   "        S[q * R::kPlaneA + off] = v[q][1] + v[q][2];"),
        (_STORE_B, "      if (v[q][0] == 1234.5f)\n"
                   "        S[4 * R::kPlaneA + q * R::kPlaneB + off] = "
                   "v[q][1] + v[q][2];")]),
}

#: (ts, K) of the ``tiles`` cases timed here (chip_smoke.TILE_CASES).
TILES = [(8, 9), (32, 33), (64, 65), (96, 97), (128, 129), (256, 256)]


def emit(obj):
    print(json.dumps(obj), flush=True)


def start_build(name, edits):
    """Write the variant's sources and start its nvcc."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    srcs = {f: open(os.path.join(CSRC, f)).read()
            for f in ("gridder.cu", "wgmma.cuh")}
    for old, new in edits:
        hit = [f for f in srcs if srcs[f].count(old) == 1]
        if not hit:
            raise ValueError(f"{name}: the text to change is not in the "
                             f"sources once: {old[:60]!r}")
        srcs[hit[0]] = srcs[hit[0]].replace(old, new)
    for f, src in srcs.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(src)
    lib = os.path.join(d, "libk1.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.COMPILE_FLAGS,
           "-shared", "-o", lib, os.path.join(d, "gridder.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), lib


def runner(build):
    """The built variant's ``ktt_grid_planes`` (the tree's C interface)
    as ``fn(slot, n, count, iu, iv, su, sv, sre, sim, table, accr, acci,
    ts)``, and its ptxas registers and spills."""
    proc, path = build
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(err[-4000:])
    regs = [(k["registers"], k["spill_stores"])
            for k in _build.ptxas_report(err)
            if "grid_planes_kernel" in k["function"]]
    fn = ctypes.CDLL(os.path.abspath(path)).ktt_grid_planes
    fn.argtypes = _build.SIGNATURES["ktt_grid_planes"]
    fn.restype = ctypes.c_int

    def run(slot, n, count, iu, iv, su, sv, sre, sim, table, accr, acci,
            ts):
        NC, Mc = iu.shape
        _build.check(fn(slot.data_ptr(), n, count.data_ptr(), iu.data_ptr(),
                        iv.data_ptr(), su.data_ptr(), sv.data_ptr(),
                        sre.data_ptr(), sim.data_ptr(), table.data_ptr(),
                        accr.data_ptr(), acci.data_ptr(), None, NC, Mc,
                        sre.shape[1], table.shape[1], ts,
                        accr.shape[-1] // (2 * ts), _build.stream_of(accr)),
                     "variant ktt_grid_planes")
    return run, regs


def production_args(dev):
    from katsdpimager_tpu_torch.ops import mxu_gridder
    from katsdpimager_tpu_torch.parallel import multichannel as mc

    cfg = cs.bench_config()
    batch = mc.make_example_batch(cfg, 1, vis_per_slice=1 << 19, device=dev)
    N, ts, K = cfg.pixels, cfg.rv, cfg.kernel_width
    nt2 = mxu_gridder.colour_tiles(N, ts)
    n = int(batch.n_chunks[0, 0])
    kern = batch.kernel[0]
    uv, sub, wp, anc, val, vis = (x[0, 0] for x in (
        batch.uv, batch.sub_uv, batch.w_plane, batch.anchor, batch.valid,
        batch.vis))
    iu, iv, su, sv = fused_gridder.tap_indices(kern, uv, sub, wp, anc,
                                               pixels=N, ts=ts)
    sre, sim = fused_gridder.samples(vis, val, None, None, anc, su, sv,
                                     kernel_width=K, ts=ts)
    args = (fused_gridder.chunk_slots(anc, n, ts=ts, nt2=nt2), n,
            fused_gridder.valid_counts(val), iu, iv, su, sv, sre, sim,
            fused_gridder.conj_table(kern))
    return args, ts, nt2


def cases(dev):
    """(label, K1 arguments, ts, nt2) of every case, made one at a time."""
    yield ("production slice",) + production_args(dev)
    for ts, K in ((64, 60), (32, 30)):
        t, nt2 = cs.k1_inputs(dev, 7000 + ts + 128, ts=ts, K=K, pixels=2048,
                              max_runs=48, run_chunks=128)
        yield f"long runs ts {ts} x 128", (t[0], t[0].shape[0], *t[1:]), \
            ts, nt2
    for ts, K in TILES:
        t, nt2 = cs.k1_inputs(dev, ts * 1000 + K, ts=ts, K=K, pixels=2048)
        yield f"tiles ts {ts} K {K}", (t[0], t[0].shape[0], *t[1:]), ts, nt2


def main():
    names = (sys.argv[1].split(",") if len(sys.argv) > 1
             else list(VARIANTS))
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"card": cs.card_line()})
    t0 = time.perf_counter()
    builds = {n: start_build(n, VARIANTS[n][1]) for n in names}
    parent_build = cs.start_parent_build(cs.PARENT_K1_SOURCE)
    _build.load()
    runners = {}
    for name, b in builds.items():
        runners[name], regs = runner(b)
        emit({"variant": name, "kind": VARIANTS[name][0],
              "registers_spills": regs})
    parent = cs.parent_k1(parent_build)
    emit({"build_s": time.perf_counter() - t0})

    def tree(*a, ts):
        fused_gridder.grid_planes(*a, ts=ts)

    for label, args, ts, nt2 in cases(dev):
        shape = (2, 2, args[7].shape[1], nt2 * 2 * ts, nt2 * 2 * ts)
        written = fused_gridder.occupancy(args[0], args[1], nt2)
        written = written.repeat_interleave(2 * ts, -2).repeat_interleave(
            2 * ts, -1)[:, :, None]
        kr, ki = (torch.full(shape, float("nan"), device=dev)
                  for _ in range(2))
        tree(*args, kr, ki, ts=ts)
        line = {"case": label, **cs.run_lengths(args[0], args[1], args[2]),
                "variants": {}}
        if parent is not None:
            pr, pi = torch.empty_like(kr), torch.empty_like(ki)
            ms, pms = cs.timed_pair(lambda: parent(*args, pr, pi, ts),
                                    lambda: tree(*args, kr, ki, ts=ts),
                                    reps=20)
            line.update(tree_ms=ms, parent_ms=pms, tree_over_parent=ms / pms)
        for name, run in runners.items():
            vr, vi = (torch.full(shape, float("nan"), device=dev)
                      for _ in range(2))
            run(*args, vr, vi, ts)
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in ((vr, kr), (vi, ki)))
            vs64 = cs.k1_vs_float64(args, ts, written, variant=(vr, vi))
            ms, tms = cs.timed_pair(lambda: tree(*args, kr, ki, ts=ts),
                                    lambda: run(*args, vr, vi, ts), reps=20)
            line["variants"][name] = {
                "ms": ms, "tree_ms": tms, "over_tree": ms / tms,
                "bitwise_tree": same,
                "err_vs_float64_over_peak": vs64["variant"]}
            del vr, vi
        emit(line)
        del kr, ki
    emit({"done": True, "card": cs.card_line()})


if __name__ == "__main__":
    np.seterr(all="ignore")
    main()
