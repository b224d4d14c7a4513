"""The import guard: nothing the harness or the reference loads is JAX or
the JAX package, judged by top-level names compared whole; the reference
also loads nothing of the program."""

import subprocess
import sys

from portbench.common import guard


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_loaded(
        ["katsdpimager_tpu_torch", "katsdpimager_tpu_torch.ops",
         "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(
        ["katsdpimager_tpu.ops.fourier", "jax._src", "jaxlib", "flax.nn"]
    ) == ["flax", "jax", "jaxlib", "katsdpimager_tpu"]


def loaded_after(code: str) -> set:
    """The top-level module names a fresh interpreter holds after
    running ``code``."""
    out = subprocess.run(
        [sys.executable, "-c",
         code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        check=True, capture_output=True, text=True, timeout=300)
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    names = loaded_after(
        "import portbench.run, portbench.manifest\n"
        "from portbench.runners import dirty_step\n"
        "from portbench.tools import readings\n"
        "from katsdpimager_tpu_torch.parallel import multichannel\n"
        "from katsdpimager_tpu_torch.ops import fused_gridder, wkernel\n"
        "from katsdpimager_tpu_torch import parameters, polarization\n"
        "cell = portbench.manifest.cell('mkat_l_4k.dirty')\n"
        "[cell.reader(m) for m in cell.per_layer]\n")
    assert not names & guard.FORBIDDEN
    assert guard.PROGRAM in names


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("import portbench.reference.imaging\n"
                         "import portbench.reference.wkernel\n")
    assert not names & (guard.FORBIDDEN | {guard.PROGRAM})
