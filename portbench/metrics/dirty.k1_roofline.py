"""dirty.k1_roofline: K1's share of its roofline over the traced stretch
of dirty steps, %.

The floor counts the work the inputs need, whatever implements it: for
each non-empty (channel, W slice) of a step, 8 K^2 P real operations per
valid visibility (a complex sample times the K x K separable kernel,
accumulated), at the card's fastest float32-accurate rate (3xTF32 on the
tensor cores, a third of 495 TFLOP/s), and the bytes of each input read
once (each chunk's slot and count, each valid visibility's four tap
indices and its sample, the kernel table) and the colour planes written
once (anchor runs x P x (2 ts)^2 x 8 B); the larger of the two times.
That floor, summed over the traced steps, over the device seconds of the
kernels whose names match :data:`KERNEL` in the trace.  Nothing is read
where K1 did not run (its wrapper's ``launches`` counter, ``k1.launches``,
and the trace).
"""

from portbench.common import peaks

#: K1's kernel name in the trace (``csrc/gridder.cu``).
KERNEL = r"grid_planes_kernel"


def launch_bytes(w: dict) -> float:
    """Bytes K1's inputs and outputs need for one (channel, slice)."""
    P, ts = w["pols"], w["ts"]
    return (2 * w["chunks"] * 4
            + w["valid"] * (4 * 4 + 2 * P * 4)
            + w["table_rows"] * w["kernel_width"] * 8
            + w["runs"] * P * (2 * ts) ** 2 * 8)


def launch_flops(w: dict) -> float:
    """Real operations the gridding of one (channel, slice) needs."""
    return 8.0 * w["kernel_width"] ** 2 * w["pols"] * w["valid"]


def floor_s(w: dict) -> float:
    return peaks.floor_s(launch_bytes(w), launch_flops(w))


def read(trace):
    k1_s = trace.kernel_seconds(KERNEL)
    steps = trace.counters.get("trace.steps", 0)
    work = trace.counters.get("k1.work", [])
    if k1_s <= 0 or not steps or not work or not trace.counters.get(
            "k1.launches"):
        return None
    return 100.0 * steps * sum(floor_s(w) for w in work) / k1_s
