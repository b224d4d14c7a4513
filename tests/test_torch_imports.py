"""The PyTorch port must run where JAX is not installed: none of its
modules, nor ``chip_smoke.py``, nor ``tests/test_torch_gpu.py`` (the one
test file that runs on the card), may import JAX or anything of the JAX
package ``katsdpimager_tpu`` (the port has its own host modules)."""

import ast
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


def test_no_function_takes_plain():
    """Which version of a kernel runs is decided in one place,
    ``device.runs_plain`` (switched by ``device.plain_versions``): no
    function of the port takes a ``plain`` parameter."""
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                a = node.args
                names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
                assert "plain" not in names, (path.name, node.lineno)


#: The gridding modules of ``ops``: the planner and layout helpers, and
#: the two kernel modules that import them.
_GRIDDING = ("mxu_gridder", "fused_gridder", "fused_degrid")


def _imported_gridding_modules(node) -> set:
    """The modules of :data:`_GRIDDING` that an import statement names."""
    if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
    elif node.level == 0:
        names = [node.module or ""]
    elif node.module is None:
        names = [a.name for a in node.names]
    else:
        names = [node.module] + [f"{node.module}.{a.name}"
                                 for a in node.names]
    return {m for m in _GRIDDING for name in names
            if name == m or name.endswith("." + m)
            or name.startswith(m + ".")}


def test_gridding_modules_import_in_one_direction():
    """``ops.mxu_gridder`` imports neither kernel module, and the three
    import each other at module level only (no hidden cycle through a
    function body)."""
    for name in _GRIDDING:
        tree = ast.parse((PKG / "ops" / f"{name}.py").read_text())
        top = set()
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                top |= _imported_gridding_modules(node)
        every = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                every |= _imported_gridding_modules(node)
        assert every == top, (name, every - top)
        if name == "mxu_gridder":
            assert not every, every
