"""K1's persistent schedule and its budget, on the CPU.

K1 (``csrc/gridder.cu``) runs one CTA per SM over a list of work items,
an item being (pass, anchor run), a pass (polarization, tile of the
window): every CTA finds, inside the launch, where its lanes' contiguous
shares of the items' weights (a run's batches plus ``kItemWeight``)
begin, and walks them.  :func:`k1_schedule` is the plain model of that
search and walk, with the kernel's constants read out of the CUDA
source; here it is held to the plan's runs and occupancy at every tile
size the planners give, with one and two polarizations, and to its
balance on a plan whose run lengths are adversarial.
``tests/test_torch_gpu.py`` holds it to the items and batches that each
worker of the kernel reports on the card (``grid_planes(...,
stats=...)``).  Each instance's shared memory is laid out from the
structs and ``constexpr`` members of the source, as nvcc lays them out.
"""

import bisect
import os
import re

import numpy as np
import pytest
import torch

from katsdpimager_tpu_torch.ops import fused_gridder, mxu_gridder

#: The H100's shared memory a block can take (bytes) and register file
#: (32-bit registers an SM; at most 255 a thread).
SMEM_PER_BLOCK = 232448
REGISTERS_PER_SM = 65536

#: The CTAs a launch has on an H100 SXM (one per SM).
CTAS = 132


def cuda_source(name="gridder.cu"):
    with open(os.path.join(os.path.dirname(fused_gridder.__file__), "..",
                           "csrc", name)) as f:
        return re.sub(r"//[^\n]*", "", f.read())


def c_eval(expr, env):
    """A C constant expression of the source (``a ? b : c``,
    ``static_cast<int>(x)``, ``X::kY``, ``sizeof(T)``) in Python, with
    the names in ``env``."""
    expr = " ".join(expr.split())
    expr = re.sub(r"static_cast<int>\((.*)\)", r"\1", expr)
    expr = re.sub(r"sizeof\((\w+)\)", r"sizeof_\1", expr)
    expr = re.sub(r"\b\w+::(k\w+)", r"\1", expr)
    m = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
    if m:
        expr = f"({m[2]}) if ({m[1]}) else ({m[3]})"
    return eval(expr.replace("/", "//"), {}, dict(env))   # noqa: S307


def cuda_constants(names, source, env=None):
    """The values of ``constexpr int|bool name = ...;`` in ``source``,
    each evaluated with ``env`` and the constants before it."""
    env = dict(env or {"true": True, "false": False})
    for name in names:
        expr = re.search(rf"constexpr (?:int|bool) {name} =\s*([^;]+);",
                         source).group(1)
        env[name] = c_eval(expr, env)
    return env


def k1_constants():
    """The kernel's constants: ``kKB``, ``kMaxMc``, ``kConsumers``,
    ``kThreads``, ``kStagesOne``, ``kStagesTwo``, ``kItemWeight``."""
    env = cuda_constants(["kPromoteSteps"], cuda_source("wgmma.cuh"))
    return cuda_constants(
        ["kKB", "kMaxMc", "kConsumers", "kThreads", "kStagesOne",
         "kStagesTwo", "kItemWeight"], cuda_source(), env)


K1 = k1_constants()


def struct_body(source, name):
    """The text between ``struct ... name {`` and its ``};``."""
    m = re.search(rf"struct (?:__align__\((\d+)\) )?{name} \{{(.*?)\n\}};",
                  source, re.S)
    return int(m[1] or 1), m[2]


def struct_size(source, name, env):
    """``sizeof`` of a struct of ``int``, ``float`` and ``long long``
    scalars and arrays, as a C++ compiler lays it out."""
    align, body = struct_body(source, name)
    sizes = {"int": 4, "float": 4, "long long": 8}
    off = 0
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        m = re.fullmatch(r"(long long|int|float) (.*)", decl, re.S)
        assert m, f"{name}: cannot lay out {decl!r}"
        size = sizes[m[1]]
        align = max(align, size)
        for field in m[2].split(","):
            dims = re.findall(r"\[([^\]]+)\]", field)
            count = 1
            for d in dims:
                count *= c_eval(d, env)
            off = -(-off // size) * size + size * count
    return -(-off // align) * align


def k1_layout(ts: int) -> dict:
    """K1's instance at tile size ``ts`` (the dispatch of
    ``ktt_grid_planes``): the padded window ``wp``, the tile's columns
    ``bn`` (its rows are 64), whether the window is padded, the ``tiles``
    of a run, and the members of ``Ring<bn>`` and ``Smem<bn>`` with the
    sizes of the structs, evaluated from the source."""
    src = cuda_source()
    wp = 64 * -(-2 * ts // 64)
    bn = 128 if wp % 128 == 0 else 64
    env = dict(K1, BN=bn, sizeof_float=4, true=True, false=False)
    for name in ("ChunkSlots", "StageInfo", "Schedule"):
        env["sizeof_" + name] = struct_size(src, name, env)
    for struct in ("Ring", "Smem"):
        _, body = struct_body(src, struct)
        members = re.findall(r"static constexpr (?:int|bool) (\w+) =", body)
        env = cuda_constants(members, body, env)
    return {"wp": wp, "bn": bn, "pad": wp > 2 * ts, "lanes": env["kLanes"],
            "tiles": (wp // 64) * (wp // bn), **env}


def k1_schedule(slot, n: int, count, *, P: int, ts: int, ctas: int):
    """Plain model of K1's schedule (``find_starts`` and ``produce_step``
    in ``csrc/gridder.cu``): for each worker, lane ``l`` of CTA ``b``
    being worker ``l * ctas + b``, the items it takes, in order, each
    ``(pass, the run's first chunk, its batches)``; a pass is
    ``divmod(pass, tiles)``, (polarization, tile).

    A chunk weighs its batches of ``kKB`` valid slots, plus
    ``kItemWeight`` where it starts a run; a pass weighs ``W``, the sum.
    Item (q, c) lies at ``q W + (the weight of the chunks before c)``,
    and worker ``k`` of ``NW`` takes the items at ``[k L / NW, (k + 1) L
    / NW)``, ``L = passes W``: it finds its first run by the prefix sum,
    then walks the runs."""
    lay = k1_layout(ts)
    batch, weight = K1["kKB"], K1["kItemWeight"]
    slot = [int(x) for x in slot[:n]]
    count = [int(x) for x in count[:n]]
    first = [c == 0 or slot[c] != slot[c - 1] for c in range(n)]
    pos_of = [0]
    for c in range(n):
        pos_of.append(pos_of[-1] + -(-count[c] // batch)
                      + (weight if first[c] else 0))
    W = pos_of[-1]
    starts = [c for c in range(n) if first[c]]
    start_pos = [pos_of[c] for c in starts]      # strictly increasing
    passes = P * lay["tiles"]
    nw = lay["lanes"] * ctas
    out = []
    for k in range(nw):
        lo, hi = k * passes * W // nw, (k + 1) * passes * W // nw
        q = lo // W
        i = bisect.bisect_left(start_pos, lo - q * W)
        c = starts[i] if i < len(starts) else n
        pos = pos_of[c] if c < n else 0
        if c >= n:
            q, c, pos = q + 1, 0, 0
        items = []
        while q < passes and q * W + pos < hi:
            cc, batches = c, 0
            while True:
                batches += -(-count[cc] // batch)
                cc += 1
                if cc >= n or slot[cc] != slot[c]:
                    break
            items.append((q, c, batches))
            pos += weight + batches
            c = cc
            if c >= n:
                q, c, pos = q + 1, 0, 0
        out.append(items)
    return out


def test_cta_constants_match_the_cuda_source():
    """The kernel's batch and chunk are the wrapper's ``BATCH`` and
    ``MAX_CHUNK``; its CTA is the consumer warpgroups and one producer
    warpgroup, one CTA an SM (``__launch_bounds__(kThreads, 1)``); an
    item weighs at least one batch, so empty runs take their turn."""
    assert K1["kKB"] == fused_gridder.BATCH
    assert K1["kMaxMc"] == fused_gridder.MAX_CHUNK
    assert K1["kThreads"] == 128 * (K1["kConsumers"] + 1)
    assert "__launch_bounds__(kThreads, 1)" in cuda_source()
    assert K1["kItemWeight"] >= 1


#: (ts, bn, lanes, pad): each of K1's four instances, (BN, kPad), at a
#: tile size that takes it.
INSTANCES = [(64, 128, 1, False), (50, 128, 1, True), (32, 64, 2, False),
             (16, 64, 2, True)]


@pytest.mark.parametrize("ts,bn,lanes,pad", INSTANCES)
def test_each_instance_fits_the_sm(ts, bn, lanes, pad):
    """Each instance's shared memory, laid out from the source (the ring
    of ``Ring<BN>``, then the regions of ``Smem<BN>``: per lane two
    chunks' slots, the stages' infos and their full and empty mbarriers;
    and the static ``Schedule``), is under the 227 KB a block can take,
    with the 16-byte slot buffers and 8-byte barriers aligned; a lane's
    ring holds at least 2 staged batches of its tile's A and B in 8
    planes; and the CTA's threads at the registers one CTA an SM allows
    fit the register file, with room for a consumer's accumulators and
    segment totals."""
    lay = k1_layout(ts)
    assert (lay["bn"], lay["lanes"], lay["pad"]) == (bn, lanes, pad)
    assert lay["wp"] % bn == 0 and lay["wp"] >= 2 * ts
    assert lay["kStage"] == 4 * K1["kKB"] * (64 + bn)
    assert lay["kStages"] >= 2
    assert lay["sizeof_StageInfo"] == 32
    assert lay["sizeof_ChunkSlots"] == 6 * 4 * K1["kMaxMc"]
    assert lay["kSlots"] == lanes * lay["kStages"] * lay["kStage"] * 4
    assert lay["kSlots"] % 16 == 0 and lay["kInfo"] % 16 == 0
    assert lay["kBars"] % 8 == 0
    assert lay["kBytes"] == (lay["kBars"]
                             + 2 * lanes * lay["kStages"] * 8)
    assert lay["kBytes"] + lay["sizeof_Schedule"] <= SMEM_PER_BLOCK
    threads = K1["kThreads"]
    per_thread = REGISTERS_PER_SM // threads // 8 * 8
    assert per_thread * threads <= REGISTERS_PER_SM
    accumulators = 2 * 2 * lay["kAcc"]      # acc and segment, re and im
    assert accumulators + 32 <= per_thread
    assert lay["kProducers"] == 128
    assert lay["kLaneConsumers"] * lanes == 128 * K1["kConsumers"]
    assert lay["kFullCount"] == 4 and lay["kEmptyCount"] * 32 == (
        lay["kLaneConsumers"])


#: Tile sizes the planners give (the per-channel planner's 8-63 and ts =
#: K above 64, the cube's 128 and 256), with the kernel width the plan
#: takes (K <= ts) and the image size.
PLAN_TILES = [(8, 8, 256), (16, 12, 256), (32, 30, 512), (33, 20, 512),
              (50, 30, 1024), (64, 60, 1024), (96, 60, 1024),
              (128, 100, 2048), (256, 200, 2048)]


def plan(ts, K, pixels, seed=1, n=20000, mc=256):
    """The tiled planner's chunks of ``n`` visibilities: slot, the chunk
    count, valid counts and nt2."""
    rng = np.random.default_rng(seed)
    lim = pixels // 2 - K - 1
    uv = np.clip(rng.normal(scale=lim / 3, size=(n, 2)), -lim, lim
                 ).astype(np.int16)
    coords = mxu_gridder.plan_chunks_tiled_coords(
        uv, pixels=pixels, kernel_width=K, ts=ts, mc=mc)
    nc = int(coords["n_chunks"])
    nt2 = mxu_gridder.colour_tiles(pixels, ts)
    anchor = torch.from_numpy(np.ascontiguousarray(coords["anchor"]))
    valid = torch.from_numpy(np.ascontiguousarray(coords["valid"]))
    slot = fused_gridder.chunk_slots(anchor, nc, ts=ts, nt2=nt2)
    return slot, nc, fused_gridder.valid_counts(valid), nt2


def run_batches(slot, n, count):
    """Each run's first chunk and its batches of ``BATCH`` valid slots."""
    out = {}
    for c in range(n):
        if c == 0 or int(slot[c]) != int(slot[c - 1]):
            c0 = c
            out[c0] = 0
        out[c0] += -(-int(count[c]) // K1["kKB"])
    return out


def check_schedule(slot, n, count, *, P, ts, nt2):
    """The schedule's items, against the plan: every (pass, run) once,
    with its run's batches, in position order within each worker; each
    worker's weight at most its share plus one item.  Returns the items'
    weights by worker and the share."""
    lay = k1_layout(ts)
    sched = k1_schedule(slot, n, count, P=P, ts=ts, ctas=CTAS)
    assert len(sched) == lay["lanes"] * CTAS
    runs = run_batches(slot, n, count)
    occ = fused_gridder.occupancy(slot, n, nt2)
    assert len(runs) == int(occ.sum())
    passes = P * lay["tiles"]
    want = {(q, c0): b for q in range(passes) for c0, b in runs.items()}
    got = [(q, c0, b) for items in sched for q, c0, b in items]
    assert len(got) == len(want)
    assert {(q, c0): b for q, c0, b in got} == want
    w = K1["kItemWeight"]
    total = sum(b + w for b in want.values())
    share = total / len(sched)
    heaviest = max(want.values()) + w
    pos = {c0: 0 for c0 in runs}
    acc = 0
    for c0 in sorted(runs):
        pos[c0] = acc
        acc += runs[c0] + w
    loads = []
    for items in sched:
        keys = [q * acc + pos[c0] for q, c0, _ in items]
        assert keys == sorted(keys)
        loads.append(sum(b + w for _, _, b in items))
        assert loads[-1] <= share + heaviest
    assert sum(loads) == total
    return loads, share, heaviest


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("ts,K,pixels", PLAN_TILES)
def test_schedule_takes_every_run_once(ts, K, pixels, P):
    """On the planner's chunks at every tile size it gives, the
    schedule deals each (polarization, tile, anchor run) to exactly one
    worker with the run's batches, as many runs as the plan's occupied
    colour-plane tiles, and no worker more than its share plus one
    item."""
    slot, n, count, nt2 = plan(ts, K, pixels, seed=ts + P)
    assert n > 0
    check_schedule(slot, n, count, P=P, ts=ts, nt2=nt2)


def adversarial_plan(ts, long_chunks=128, short=(200, 300), spare=40,
                     seed=3):
    """One run of ``long_chunks`` full chunks among 1-chunk runs of 0-256
    valid slots; ``spare`` chunks past n."""
    rng = np.random.default_rng(seed)
    nt2 = mxu_gridder.colour_tiles(2048, ts)
    runs = [1] * short[0] + [long_chunks] + [1] * short[1]
    n = sum(runs)
    slots = rng.choice(4 * nt2 * nt2, size=len(runs), replace=False)
    slot = np.zeros(n + spare, np.int32)
    slot[:n] = np.repeat(slots, runs)
    count = np.zeros(n + spare, np.int32)
    count[:n] = np.concatenate([
        rng.integers(0, 257, size=short[0]), np.full(long_chunks, 256),
        rng.integers(0, 257, size=short[1])])
    return torch.from_numpy(slot), n, torch.from_numpy(count), nt2


@pytest.mark.parametrize("ts", [64, 32])
def test_schedule_isolates_the_longest_run(ts):
    """One 128-chunk run (2048 batches) among 500 one-chunk runs, with
    chunks past n: each of the long run's items goes to its own worker,
    which takes at most a share of other work besides; every other
    worker stays within its share plus the longest short run."""
    slot, n, count, nt2 = adversarial_plan(ts)
    loads, share, heaviest = check_schedule(slot, n, count, P=1, ts=ts,
                                            nt2=nt2)
    runs = run_batches(slot, n, count)
    long_weight = max(runs.values()) + K1["kItemWeight"]
    short_weight = sorted(runs.values())[-2] + K1["kItemWeight"]
    assert heaviest == long_weight == 2048 + K1["kItemWeight"]
    lay = k1_layout(ts)
    holders = [w for w in loads if w >= long_weight]
    assert len(holders) == lay["tiles"]
    assert all(w <= long_weight + share for w in holders)
    assert all(w <= share + short_weight for w in loads if w < long_weight)
