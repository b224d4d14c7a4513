"""iquv.k1_roofline: K1's share of its roofline over the traced stretch
of full-Stokes dirty steps, %.

The reading of ``dirty.k1_roofline``, loaded from that file so that the
work count lives in one place: its floor counts each (channel, W
slice)'s work with the polarisations that ``k1.work`` carries (8 K^2 P
operations per valid visibility, P colour planes per anchor run), summed
over the traced steps, over K1's device seconds.  Nothing is read where
K1 did not run.
"""

import importlib.util
import os


def read(trace):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "dirty.k1_roofline.py")
    spec = importlib.util.spec_from_file_location("dirty_k1_roofline", path)
    roofline = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(roofline)
    return roofline.read(trace)
