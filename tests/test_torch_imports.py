"""The PyTorch port must run where JAX is not installed: none of its
modules, nor ``chip_smoke.py``, nor ``tests/test_torch_gpu.py`` (the one
test file that runs on the card), may import JAX or anything of the JAX
package ``katsdpimager_tpu`` (the port has its own host modules)."""

import os
import pathlib
import re
import subprocess
import sys

import katsdpimager_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(katsdpimager_tpu_torch.__file__).parent
#: Every source that runs where JAX is not installed.
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "tests" / "test_torch_gpu.py"]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises ImportError
import katsdpimager_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None), "jax was imported"
jax_pkg = [m for m in sys.modules
           if m == "katsdpimager_tpu" or m.startswith("katsdpimager_tpu.")]
assert not jax_pkg, f"the JAX package was imported: {jax_pkg}"
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 8


def test_sources_name_no_jax():
    pattern = re.compile(r"\s*(import|from)\s+jax(\.|\s|$)")
    for path in SOURCES:
        for line in path.read_text().splitlines():
            assert not pattern.match(line), (path, line)


def test_sources_name_no_jax_package():
    """No import line of the port, of ``chip_smoke.py`` or of
    ``tests/test_torch_gpu.py`` names the JAX package
    (``katsdpimager_tpu`` without ``_torch``)."""
    pattern = re.compile(r"\s*(import|from)\s+katsdpimager_tpu(?!_torch)\b")
    for path in SOURCES:
        for line in path.read_text().splitlines():
            assert not pattern.match(line), (path, line)
