"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, then linked into one
shared library with a plain C interface, loaded with :mod:`ctypes`.
(With 8 CPU cores and three sources this took 2.3-2.5 s against
5.2-5.5 s for one ``nvcc`` over all of them.)
The library lands in ``katsdpimager_tpu_torch/_build/<hash>/``, keyed by
a hash of the sources and the compiler flags, so an edited source is
rebuilt and an unchanged one is reused within a checkout.  Each source
compiles with ``-Xptxas -v``; what ``ptxas`` says (registers, spills,
static shared memory per kernel) is kept beside the library and read back
by :func:`ptxas_report`.

Every C entry point launches on the stream it is given (the wrapper
passes ``torch.cuda.current_stream().cuda_stream``) and returns
``cudaGetLastError()``; :func:`check` raises when that is non-zero.  A
failed build raises: there is no fallback.

No ``-use_fast_math``: K4's epilogue needs accurate ``sincosf`` for
W-phases far beyond ±π, and K2 must not reassociate its adds.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
_LIBNAME = "libktpu_torch.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]
#: Compile-only flags: ptxas's resource report.
COMPILE_FLAGS = ["-Xptxas", "-v"]
_REPORT = "ptxas.txt"

_P = ctypes.c_void_p
_I = ctypes.c_int

#: C entry points and their argument types (pointers and the stream are
#: ``c_void_p``, so 64-bit addresses are never cut to 32 bits).
SIGNATURES = {
    # slot, n, count, iu, iv, su, sv, sre, sim, tab, tabs, accr, acci,
    # NC, Mc, P, K, ts, nt2, stream
    "ktt_grid_planes": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _P],
    # accr, acci, occ, gr, gi, P, N, ts, nt2, accumulate, stream
    "ktt_combine_planes": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # xr, xi, tw, yr, yi, P, N, stream
    "ktt_cb_col_fft": [_P, _P, _P, _P, _P, _I, _I, _P],
    # xr, xi, tw, taper, scal, imgT, P, N, stream
    "ktt_epi_col_fft": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # imgT, tw, taper, scal, yr, yi, P, N, stream
    "ktt_pre_col_fft": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # xr, xi, tw, yr, yi, P, N, stream
    "ktt_cbout_col_fft": [_P, _P, _P, _P, _P, _I, _I, _P],
    # gr, gi, av, au, iu, iv, su, sv, tab, pred, n, Mc, P, N, K, ts2, stream
    "ktt_degrid_planes": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _P],
    # xr, xi, tw, yr, yi, B, N, M, sign, stream
    "ktt_col_fft": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # idx, tab, out, M, W, L, recombine, stream
    "ktt_probe_select_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
    # idx, table, out, M, W, L, stream
    "ktt_probe_select_f32": [_P, _P, _P, _I, _I, _I, _P],
    # x, y, out, Mk, I, J, stream
    "ktt_probe_dot_f32": [_P, _P, _P, _I, _I, _I, _P],
    "ktt_probe_dot_tf32": [_P, _P, _P, _I, _I, _I, _P],
    # tab, out, W, L, stream
    "ktt_probe_recombine": [_P, _P, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def lib_path() -> str:
    return os.path.join(_BUILD, _key(), _LIBNAME)


def build() -> str:
    """Compile ``csrc/*.cu`` unless the keyed library exists; return its
    path.  Each source compiles in its own ``nvcc`` process, all at once;
    the objects link into a temporary name that is then renamed, so a
    cut build never leaves a library that looks finished."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as tmp:
        jobs = []
        for src in (p for p in sources() if p.endswith(".cu")):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, "-I", _CSRC, "-c",
                   "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed, report = [], []
        for cmd, _, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append("%s\n%s" % (" ".join(cmd), err[-8000:]))
            report.append("// source %s\n%s" % (os.path.basename(cmd[-1]),
                                                  err))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = os.path.join(tmp, _LIBNAME)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
               *(obj for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed (exit %d):\n%s\n%s" % (
                res.returncode, " ".join(cmd), res.stderr[-8000:]))
        with open(os.path.join(os.path.dirname(out), _REPORT), "w") as f:
            f.write("".join(report))
        os.replace(lib, out)
    return out


def ptxas_report() -> list[dict]:
    """Per kernel of the built library, what ``ptxas -v`` reported:
    ``source``, ``function`` (mangled), ``registers``, ``spill_stores``,
    ``spill_loads``, ``stack_bytes`` and ``static_smem_bytes`` (dynamic
    shared memory is set at launch and not included)."""
    with open(os.path.join(os.path.dirname(lib_path()), _REPORT)) as f:
        text = f.read()
    out, source, cur = [], None, None
    for line in text.splitlines():
        m = re.match(r"// source (\S+)", line)
        if m:
            source = m.group(1)
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"source": source, "function": m.group(1)}
            out.append(cur)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's types."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_of(t) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def expect(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` has the dtype, shape and device a kernel takes
    and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
