"""Native (C++) host-side components, loaded via ctypes.

The port's own copy of :mod:`katsdpimager_tpu.native` (host code, no
kernel); the port imports nothing of the JAX package.  The shared library
is built at first use with g++ (OpenMP, -O3) into
``katsdpimager_tpu_torch/_build/native/``, named by a hash of the source
and the flags, and renamed into place once linked, so processes that
build it at once never load a half-written file.  No pybind11 or
build-system dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "preprocess.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "_build", "native")
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
          "-std=c++17"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class ChannelConfigStruct(ctypes.Structure):
    _fields_ = [
        ("cell_size", ctypes.c_double),
        ("max_w", ctypes.c_double),
        ("oversample", ctypes.c_int32),
        ("w_slices", ctypes.c_int32),
        ("w_planes", ctypes.c_int32),
        ("pixels", ctypes.c_int32),
        ("kernel_width", ctypes.c_int32),
    ]


def lib_path() -> str:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"libktpu_native_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> ctypes.CDLL:
    """Load (building if necessary) the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.ktpu_preprocess_channel.restype = ctypes.c_int64
        lib.ktpu_preprocess_channel.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),   # uvw
            ctypes.POINTER(ctypes.c_float),   # weights
            ctypes.POINTER(ctypes.c_float),   # vis
            ctypes.POINTER(ctypes.c_float),   # mueller
            ctypes.c_int32,                   # per_vis_mueller
            ctypes.POINTER(ChannelConfigStruct),
            ctypes.POINTER(ctypes.c_int16),   # out_uv
            ctypes.POINTER(ctypes.c_int16),   # out_sub_uv
            ctypes.POINTER(ctypes.c_int16),   # out_w_plane
            ctypes.POINTER(ctypes.c_float),   # out_weights
            ctypes.POINTER(ctypes.c_float),   # out_vis
            ctypes.POINTER(ctypes.c_int64),   # out_slice_counts
        ]
        lib.ktpu_num_threads.restype = ctypes.c_int32
        lib.ktpu_place_payload.restype = None
        lib.ktpu_place_payload.argtypes = [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),   # row_chunk
            ctypes.POINTER(ctypes.c_int32),   # row_slot
            ctypes.POINTER(ctypes.c_float),   # weights
            ctypes.POINTER(ctypes.c_float),   # vis
            ctypes.POINTER(ctypes.c_float),   # out_wts
            ctypes.POINTER(ctypes.c_float),   # out_vis
        ]
        lib.ktpu_pack_slice_coords.restype = ctypes.c_int64
        lib.ktpu_pack_slice_coords.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int16),   # uv
            ctypes.POINTER(ctypes.c_int16),   # sub_uv
            ctypes.POINTER(ctypes.c_int16),   # w_plane
            ctypes.c_int32, ctypes.c_int32,   # pixels, kernel_width
            ctypes.c_int32, ctypes.c_int32,   # ts, mc
            ctypes.c_int64,                   # nc_cap
            ctypes.POINTER(ctypes.c_int32),   # out_uv
            ctypes.POINTER(ctypes.c_int32),   # out_sub
            ctypes.POINTER(ctypes.c_int32),   # out_wp
            ctypes.POINTER(ctypes.c_int32),   # out_anchor
            ctypes.POINTER(ctypes.c_uint8),   # out_valid
            ctypes.POINTER(ctypes.c_int32),   # row_chunk
            ctypes.POINTER(ctypes.c_int32),   # row_slot
        ]
        _lib = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i16ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


_OUT_ARENA = {"cap": 0, "P": 0, "arrs": None}


def _out_arena(n, P):
    """Reusable output arrays (allocating ~n x 22 B per call pays
    first-touch page faults every call on hosts that reclaim cold
    pages).  Callers of :func:`preprocess_channel` must therefore copy
    any slices they keep before the next call (the collectors do)."""
    if _OUT_ARENA["cap"] < n or _OUT_ARENA["P"] != P:
        _OUT_ARENA["cap"] = n
        _OUT_ARENA["P"] = P
        _OUT_ARENA["arrs"] = (
            np.empty((n, 2), np.int16), np.empty((n, 2), np.int16),
            np.empty((n,), np.int16), np.empty((n, P), np.float32),
            np.empty((n, P), np.complex64))
    return _OUT_ARENA["arrs"]


def preprocess_channel(uvw, weights, vis, mueller, geometry):
    """Run the native preprocessing for one channel.

    uvw (n,3) f32; weights/vis (n,Q); mueller (P,Q) or (n,P,Q) complex64;
    geometry: a :class:`..preprocess.ChannelGeometry`.

    Returns a dict matching the JAX path's per-channel output (trimmed to
    the merged count, sorted by (w_slice, v, u, sub, w_plane)).  The
    returned arrays are views of a reused arena: copy anything you keep
    before the next call.
    """
    lib = load()
    uvw = np.ascontiguousarray(uvw, np.float32)
    weights = np.ascontiguousarray(weights, np.float32)
    vis = np.ascontiguousarray(vis, np.complex64)
    mueller = np.ascontiguousarray(mueller, np.complex64)
    n = uvw.shape[0]
    Q = weights.shape[-1]
    per_vis = 1 if mueller.ndim == 3 else 0
    P = mueller.shape[-2]

    cfg = ChannelConfigStruct(
        cell_size=geometry.cell_size, max_w=geometry.max_w,
        oversample=geometry.oversample, w_slices=geometry.w_slices,
        w_planes=geometry.w_planes, pixels=geometry.pixels,
        kernel_width=geometry.kernel_width)

    out_uv, out_sub, out_wp, out_wt, out_vis = _out_arena(n, P)
    counts = np.zeros((geometry.w_slices,), np.int64)

    m = lib.ktpu_preprocess_channel(
        n, Q, P, _fptr(uvw), _fptr(weights),
        vis.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mueller.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        per_vis, ctypes.byref(cfg),
        _i16ptr(out_uv), _i16ptr(out_sub), _i16ptr(out_wp),
        _fptr(out_wt),
        out_vis.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if m < 0:
        raise RuntimeError("native preprocessing failed")
    assert counts.sum() == m
    return {
        "uv": out_uv[:m], "sub_uv": out_sub[:m], "w_plane": out_wp[:m],
        "weights": out_wt[:m], "vis": out_vis[:m],
        "count": int(m), "slice_counts": counts.astype(np.int32),
    }


def _i32ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def pack_slice_coords(uv, sub_uv, w_plane, *, pixels, kernel_width, ts, mc,
                      out_uv, out_sub, out_wp, out_anchor, out_valid):
    """Tile-chunk plan + coordinate scatter for one (channel, w-slice).

    Native counterpart of ``mxu_gridder.plan_chunks_tiled_coords`` plus
    the batch coordinate scatter (bitwise-identical assignment): fills the
    caller's pre-zeroed ``(NC, Mc)``-layout views in parallel and returns
    ``(n_chunks, row_chunk, row_slot)`` for streaming payload placement.
    When ``n_chunks > NC`` nothing is written (caller grows the layout).
    """
    lib = load()
    n = len(uv)
    uv = np.ascontiguousarray(uv, np.int16)
    sub_uv = np.ascontiguousarray(sub_uv, np.int16)
    w_plane = np.ascontiguousarray(w_plane, np.int16)
    for a, dt in ((out_uv, np.int32), (out_sub, np.int32),
                  (out_wp, np.int32), (out_anchor, np.int32),
                  (out_valid, np.bool_)):
        assert a.dtype == dt and a.flags.c_contiguous
    nc_cap = out_valid.shape[0]
    row_chunk = np.empty(n, np.int32)
    row_slot = np.empty(n, np.int32)
    n_chunks = lib.ktpu_pack_slice_coords(
        n, _i16ptr(uv), _i16ptr(sub_uv), _i16ptr(w_plane),
        pixels, kernel_width, ts, mc, nc_cap,
        _i32ptr(out_uv), _i32ptr(out_sub), _i32ptr(out_wp),
        _i32ptr(out_anchor),
        out_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _i32ptr(row_chunk), _i32ptr(row_slot))
    if n_chunks < 0:
        raise RuntimeError("native slice packing failed")
    return int(n_chunks), row_chunk, row_slot


def place_payload(row_chunk, row_slot, weights, vis, out_wts, out_vis):
    """Scatter a payload block to its (chunk, slot) positions (parallel,
    race-free: destinations are unique).  ``out_wts``/``out_vis`` are
    (NC, Mc, P) float32/complex64 views of the wave batch."""
    lib = load()
    m = len(row_chunk)
    assert (out_wts.flags.c_contiguous and out_vis.flags.c_contiguous
            and out_wts.dtype == np.float32 and out_vis.dtype == np.complex64)
    weights = np.ascontiguousarray(weights, np.float32)
    vis = np.ascontiguousarray(vis, np.complex64)
    lib.ktpu_place_payload(
        m, out_wts.shape[-1], out_wts.shape[-2],
        _i32ptr(row_chunk), _i32ptr(row_slot),
        _fptr(weights), vis.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _fptr(out_wts),
        out_vis.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
