"""iquv.k1_ms_per_pol: K1's device milliseconds a dirty step over the
number of polarisations, over the traced stretch.

K1's kernel time (``grid_planes_kernel`` in the trace, as
``dirty.k1_roofline`` names it) over ``trace.steps``, divided by the
polarisations of its work (``k1.work``'s ``pols``).  K1 runs one pass a
polarisation and tile, so where the passes share nothing this reads K1's
Stokes-I milliseconds a step; work shared across the passes brings it
below that.  Nothing is read where K1 did not run.
"""

#: K1's kernel name in the trace (``csrc/gridder.cu``).
KERNEL = r"grid_planes_kernel"


def read(trace):
    k1_s = trace.kernel_seconds(KERNEL)
    steps = trace.counters.get("trace.steps", 0)
    work = trace.counters.get("k1.work", [])
    if k1_s <= 0 or not steps or not work or not trace.counters.get(
            "k1.launches"):
        return None
    pols = work[0]["pols"]
    return 1e3 * k1_s / steps / pols
