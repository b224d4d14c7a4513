r"""Visibility preprocessing: polarization conversion, weighting, quantization
and compression.

Counterpart of :mod:`katsdpimager_tpu.preprocess`, with the same
behaviour:

- per-visibility Mueller-matrix polarization conversion, optionally with
  feed-angle rotation applied in the circular frame;
- statistical weights propagated through the Mueller matrix as variances
  with 0 * inf = 0 semantics;
- visibilities with any zero input weight discarded; non-finite results
  squashed to zero weight;
- w < 0 flipped to +w with conjugated visibilities;
- UV quantized to (cell, subpixel) at ``oversample`` subcells, w to
  (w_slice, w_plane) with the first slice half-width;
- identically-quantized visibilities merged ("compression"), bucketed by
  (channel, w_slice).

Two engines compute a batch: ``"torch"`` (:func:`preprocess_channel`,
vectorised on a device: transform, quantise, sort by one packed 62-bit
key, merge with a segment sum) and ``"native"`` (the C++/OpenMP core,
:mod:`.native`, on the host).  The
collectors and readers keep the records on the host, in memory or spilled
to an HDF5 file (``h5py``, imported only there).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import device as device_mod

# -----------------------------------------------------------------------------
# Static per-channel geometry for quantization


@dataclasses.dataclass(frozen=True)
class ChannelGeometry:
    """Static quantization geometry for one channel (all floats in metres)."""

    pixels: int
    cell_size: float
    oversample: int
    w_slices: int
    w_planes: int
    max_w: float
    kernel_width: int

    def __post_init__(self):
        # Bit budget of the packed sort key (see _pack_key).
        assert self.pixels <= 32768
        assert self.oversample <= 128
        assert self.w_planes <= 1024
        assert self.w_slices <= 128

    @classmethod
    def from_parameters(cls, image_p, grid_p) -> "ChannelGeometry":
        return cls(
            pixels=image_p.pixels,
            cell_size=image_p.cell_size,
            oversample=grid_p.fixed.oversample,
            w_slices=grid_p.w_slices,
            w_planes=grid_p.w_planes,
            max_w=grid_p.fixed.max_w,
            kernel_width=grid_p.fixed.kernel_width,
        )


def apply_mueller_weights(vis, weights, mueller):
    """Convert correlation products with a Mueller matrix and propagate
    weights as variances with 0*inf = 0 semantics.

    vis: (N, Q) complex; weights: (N, Q) float; mueller: (P, Q) or
    (N, P, Q).  Returns (xvis (N, P) complex, xweights (N, P) float)."""
    inv_w = 1.0 / weights.abs()                       # inf where weight == 0
    m2 = mueller.abs() ** 2
    if mueller.dim() == 2:
        xvis = vis @ mueller.transpose(0, 1)
        contrib = torch.where(m2[None] > 0, m2[None] * inv_w[:, None, :], 0.0)
    else:
        xvis = torch.einsum("npq,nq->np", mueller, vis)
        contrib = torch.where(m2 > 0, m2 * inv_w[:, None, :], 0.0)
    return xvis, 1.0 / contrib.sum(-1)


def rotated_mueller_np(from_circular, to_circular, feed_angle1, feed_angle2):
    """Per-visibility Mueller matrices with feed-angle rotation (numpy).

    The rotation is diagonal in the circular frame: RR scales by
    ``e^{i(a1-a2)}``, RL by ``e^{i(a1+a2)}``, LR/LL by the conjugates."""
    r1 = np.exp(1j * np.asarray(feed_angle1, np.float32))
    r2 = np.exp(1j * np.asarray(feed_angle2, np.float32))
    rr = r1 * np.conj(r2)
    rl = r1 * r2
    diag = np.stack([rr, rl, np.conj(rl), np.conj(rr)], axis=-1)
    mid = np.asarray(to_circular)[None, :, :] * diag[:, :, None]
    return np.einsum("pc,ncq->npq", np.asarray(from_circular), mid)


def _pack_key(uv, sub_uv, w_plane, w_slice, invalid):
    """One int64 sort key: invalid(1) | w_slice(7) | v(15) | u(15) |
    sub_v(7) | sub_u(7) | w_plane(10), most significant first.  Records
    compare equal exactly when all quantized coordinates match; invalid
    records sort last.  (The JAX package packs the same fields into three
    int32 keys for ``lexsort``.)"""
    i64 = torch.int64
    k2 = (invalid.to(i64) << 7) | w_slice.to(i64)
    k1 = ((uv[:, 1].to(i64) + 16384) << 15) | (uv[:, 0].to(i64) + 16384)
    k0 = (((sub_uv[:, 1].to(i64) << 7) | sub_uv[:, 0].to(i64)) << 10) \
        | w_plane.to(i64)
    return (k2 << 54) | (k1 << 24) | k0


def preprocess_channel(geometry: ChannelGeometry, uvw, weights, vis,
                       mueller) -> dict:
    """Transform + quantize + sort + merge one channel's batch (tensors on
    one device: uvw (N, 3) f32 metres, weights (N, Q) f32, vis (N, Q)
    complex64, mueller (P, Q) or (N, P, Q) complex64).

    Returns numpy arrays trimmed to the merged valid records, sorted by
    (w_slice, v, u, sub_v, sub_u, w_plane): ``uv``, ``sub_uv``
    (count, 2) int16, ``w_plane``, ``w_slice`` (count,) int16,
    ``weights`` (count, P) f32, ``vis`` (count, P) complex64, plus
    ``count`` and ``slice_counts`` (w_slices,) int32."""
    dev = uvw.device
    f32 = torch.float32
    uvw = uvw.to(f32)
    flagged = (weights == 0.0).any(-1)
    xvis, xweights = apply_mueller_weights(vis, weights, mueller)

    # Flip to w >= 0 (conjugate symmetry of the visibility function).
    flip = uvw[:, 2] < 0
    uvw = torch.where(flip[:, None], -uvw, uvw)
    xvis = torch.where(flip[:, None], xvis.conj(), xvis)

    # Pre-multiply weights; squash non-finite products (NaN inputs etc.).
    wvis = xvis * xweights
    bad = ~(torch.isfinite(wvis.real) & torch.isfinite(wvis.imag))
    wvis = torch.where(bad, 0.0, wvis)
    xweights = torch.where(bad, 0.0, xweights)

    # UV quantization: cell + subpixel at `oversample` subcells.
    uv_scale = float(np.float32(1.0 / geometry.cell_size))
    xs = torch.floor(uvw[:, :2] * uv_scale * geometry.oversample).to(
        torch.int32)
    uv = torch.div(xs, geometry.oversample, rounding_mode="floor")
    sub_uv = xs - uv * geometry.oversample

    # W quantization: first slice half-width, centred at w = 0.
    w_scale = float(np.float32(
        (geometry.w_slices - 0.5) * geometry.w_planes / geometry.max_w))
    max_slice_plane = geometry.w_slices * geometry.w_planes - 1
    wq = torch.trunc(uvw[:, 2] * w_scale + geometry.w_planes * 0.5).to(
        torch.int32).clamp(0, max_slice_plane)
    w_plane = wq % geometry.w_planes
    w_slice = torch.div(wq, geometry.w_planes, rounding_mode="floor")

    # The gridder needs the whole kernel footprint inside the grid.
    idx0 = uv + geometry.pixels // 2 - (geometry.kernel_width - 1) // 2
    in_range = ((idx0 >= 0)
                & (idx0 + geometry.kernel_width <= geometry.pixels)).all(-1)
    invalid = flagged | ~in_range | (xweights == 0.0).all(-1)

    key, order = torch.sort(_pack_key(uv, sub_uv, w_plane, w_slice, invalid),
                            stable=True)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    nseg = int(seg[-1]) + 1 if len(seg) else 0
    merged_vis = torch.zeros((nseg, wvis.shape[1]), dtype=wvis.dtype,
                             device=dev).index_add_(0, seg, wvis[order])
    merged_wt = torch.zeros((nseg, xweights.shape[1]), dtype=f32,
                            device=dev).index_add_(0, seg,
                                                   xweights[order].to(f32))
    starts = order[first]
    live = ~invalid[starts]
    count = int(live.sum())          # invalid records sort last
    head = starts[:count]
    slice_counts = torch.bincount(w_slice[head].long(),
                                  minlength=geometry.w_slices)

    def host(t, dtype):
        return t.cpu().numpy().astype(dtype)

    return {
        "uv": host(uv[head], np.int16),
        "sub_uv": host(sub_uv[head], np.int16),
        "w_plane": host(w_plane[head], np.int16),
        "w_slice": host(w_slice[head], np.int16),
        "weights": host(merged_wt[:count], np.float32),
        "vis": host(merged_vis[:count].to(torch.complex64), np.complex64),
        "count": count,
        "slice_counts": host(slice_counts[:geometry.w_slices], np.int32),
    }


# -----------------------------------------------------------------------------
# Collector / reader (host-side streaming orchestration)


class VisibilityCollector:
    """Streams raw visibility chunks through a preprocessing engine and
    stores compressed records bucketed by (channel, w_slice): ``add(...)``
    per chunk, ``close()``, then ``reader()``.

    ``engine`` is ``"torch"`` (on ``device``) or ``"native"`` (host).
    ``device`` None is the CUDA device, which must exist (:mod:`.device`);
    pass ``"cpu"`` for the CPU."""

    def __init__(self, image_parameters: Sequence, grid_parameters: Sequence,
                 buffer_size: int = 1 << 20, engine: str = "torch",
                 device=None):
        if engine not in ("torch", "native"):
            raise ValueError(f"Unknown preprocess engine {engine!r}")
        if len(image_parameters) != len(grid_parameters):
            raise ValueError("Inconsistent image/grid parameter lengths")
        self.image_parameters = list(image_parameters)
        self.grid_parameters = list(grid_parameters)
        self.geometries = [
            ChannelGeometry.from_parameters(ip, gp)
            for ip, gp in zip(image_parameters, grid_parameters)
        ]
        self.num_pols = image_parameters[0].fixed.num_polarizations
        self.buffer_size = buffer_size
        self.num_input = 0
        self.num_output = 0
        # buckets[channel][w_slice] -> list of record dicts (numpy)
        self._buckets: List[List[List[dict]]] = [
            [[] for _ in range(gp.w_slices)] for gp in self.grid_parameters
        ]
        self.engine = engine
        self.device = device_mod.resolve(device)

    @property
    def num_channels(self):
        return len(self.image_parameters)

    def add(self, uvw, weights, vis, feed_angle1=None, feed_angle2=None,
            mueller_stokes=None, mueller_circular=None):
        """Add a chunk of raw visibilities.

        uvw: (N, 3) float metres. weights/vis: (C, N, Q). If
        ``mueller_circular`` is given, per-visibility feed-angle rotation is
        applied via the circular frame (``mueller_stokes`` maps circular ->
        output Stokes); otherwise ``mueller_stokes`` maps inputs directly.
        """
        uvw = np.ascontiguousarray(uvw, np.float32)
        N = uvw.shape[0]
        if mueller_circular is not None:
            mueller = rotated_mueller_np(mueller_stokes, mueller_circular,
                                         feed_angle1, feed_angle2)
        else:
            mueller = np.asarray(mueller_stokes)
        mueller = np.ascontiguousarray(mueller, np.complex64)
        if self.engine == "torch":
            dev = self.device
            uvw_t = torch.from_numpy(uvw).to(dev)
            mueller_t = torch.from_numpy(mueller).to(dev)
        for channel in range(self.num_channels):
            if self.engine == "native":
                from . import native

                out = native.preprocess_channel(
                    uvw, np.asarray(weights[channel]),
                    np.asarray(vis[channel]), mueller,
                    self.geometries[channel])
            else:
                out = preprocess_channel(
                    self.geometries[channel], uvw_t,
                    torch.from_numpy(np.ascontiguousarray(
                        weights[channel], np.float32)).to(dev),
                    torch.from_numpy(np.ascontiguousarray(
                        vis[channel], np.complex64)).to(dev),
                    mueller_t)
            self._store(channel, out)
            self.num_input += N
            self.num_output += int(out["count"])

    def _store(self, channel: int, out: dict):
        # Records are sorted by w_slice; slice s occupies
        # [start, start+counts[s]) among valid records.
        ws = out.get("w_slice")
        counts = out["slice_counts"]
        start = 0
        for s in range(self.grid_parameters[channel].w_slices):
            n = int(counts[s])
            if n == 0:
                continue
            sl = slice(start, start + n)
            assert ws is None or np.all(ws[sl] == s)
            self._buckets[channel][s].append({
                "uv": out["uv"][sl].copy(),
                "sub_uv": out["sub_uv"][sl].copy(),
                "w_plane": out["w_plane"][sl].copy(),
                "weights": out["weights"][sl].copy(),
                "vis": out["vis"][sl].copy(),
            })
            start += n

    def close(self):
        pass

    def reader(self) -> "VisibilityReader":
        return VisibilityReader(self)


@dataclasses.dataclass
class VisChunk:
    """One block of compressed visibilities for a (channel, w_slice)."""

    uv: np.ndarray        # (N, 2) int16, centred
    sub_uv: np.ndarray    # (N, 2) int16
    w_plane: np.ndarray   # (N,) int16
    weights: np.ndarray   # (N, P) float32
    vis: np.ndarray       # (N, P) complex64

    def __len__(self):
        return len(self.uv)

    def __getitem__(self, field):
        return getattr(self, field)


def _empty_chunk(num_pols: int) -> VisChunk:
    z = np.zeros
    return VisChunk(z((0, 2), np.int16), z((0, 2), np.int16),
                    z((0,), np.int16), z((0, num_pols), np.float32),
                    z((0, num_pols), np.complex64))


class VisibilityReader:
    """Iterates compressed visibilities per (channel, w_slice)."""

    def __init__(self, collector: VisibilityCollector):
        self._collector = collector

    def num_w_slices(self, channel: int) -> int:
        return self._collector.grid_parameters[channel].w_slices

    def len(self, channel: int, w_slice: int) -> int:
        return sum(len(b["uv"])
                   for b in self._collector._buckets[channel][w_slice])

    def slice_arrays(self, channel: int, w_slice: int) -> VisChunk:
        """All records for a slice as one contiguous chunk."""
        bs = self._collector._buckets[channel][w_slice]
        if not bs:
            return _empty_chunk(self._collector.num_pols)
        return VisChunk(*(np.concatenate([b[name] for b in bs])
                          for name in ("uv", "sub_uv", "w_plane", "weights",
                                       "vis")))

    def iter_slice(self, channel: int, w_slice: int,
                   block_size: Optional[int] = None):
        arrays = self.slice_arrays(channel, w_slice)
        n = len(arrays)
        if block_size is None or block_size >= n:
            if n:
                yield arrays
            return
        for start in range(0, n, block_size):
            sl = slice(start, start + block_size)
            yield VisChunk(arrays.uv[sl], arrays.sub_uv[sl],
                           arrays.w_plane[sl], arrays.weights[sl],
                           arrays.vis[sl])

    def close(self):
        pass


class VisibilityCollectorMem(VisibilityCollector):
    """In-memory backend (the base class is already in-memory)."""


def _import_h5py():
    try:
        import h5py
    except ImportError as exc:
        raise RuntimeError(
            "h5py is not installed: spilling preprocessed visibilities to a "
            "temporary HDF5 file (the default --tmp-file) needs it; pass "
            "--no-tmp-file to keep them in memory") from exc
    return h5py


class VisibilityCollectorHDF5(VisibilityCollector):
    """HDF5-spill backend: buckets are flushed to a temp file so host RAM
    stays bounded for large cubes."""

    def __init__(self, filename, image_parameters, grid_parameters,
                 buffer_size: int = 1 << 20, max_cache_size=None,
                 engine: str = "torch", device=None):
        h5py = _import_h5py()
        super().__init__(image_parameters, grid_parameters, buffer_size,
                         engine=engine, device=device)
        # Writes round-robin across (channel, w_slice) streams, so size the
        # chunk cache to hold one chunk set per stream, capped by
        # ``max_cache_size``.
        P = self.num_pols
        per_stream = ((1 << 14) * P * (8 + 4)       # vis + weights chunks
                      + (1 << 16) * (2 * 2 + 2 * 2 + 2))  # uv, sub_uv, w_plane
        streams = max(1, sum(gp.w_slices for gp in self.grid_parameters))
        cache_size = per_stream * streams
        if max_cache_size is not None:
            cache_size = min(cache_size, int(max_cache_size))
            streams = max(1, cache_size // per_stream)
        slots = streams * 100 + 1
        while any(slots % p == 0 for p in range(2, min(slots, 100))):
            slots += 2
        self._file = h5py.File(filename, "w", rdcc_nbytes=cache_size,
                               rdcc_nslots=slots)
        self._dsets = {}

    def _store(self, channel, out):
        counts = out["slice_counts"]
        start = 0
        P = self.num_pols
        shapes = {"uv": ((2,), np.int16, 1 << 16),
                  "sub_uv": ((2,), np.int16, 1 << 16),
                  "w_plane": ((), np.int16, 1 << 16),
                  "weights": ((P,), np.float32, 1 << 14),
                  "vis": ((P,), np.complex64, 1 << 14)}
        for s in range(self.grid_parameters[channel].w_slices):
            n = int(counts[s])
            if n == 0:
                continue
            sl = slice(start, start + n)
            grp_name = f"ch{channel}/ws{s}"
            if grp_name not in self._dsets:
                g = self._file.create_group(grp_name)
                self._dsets[grp_name] = {
                    name: g.create_dataset(name, (0,) + tail,
                                           maxshape=(None,) + tail,
                                           dtype=dt, chunks=(rows,) + tail)
                    for name, (tail, dt, rows) in shapes.items()}
            for name, ds in self._dsets[grp_name].items():
                old = ds.shape[0]
                ds.resize(old + n, axis=0)
                ds[old:] = out[name][sl]
            start += n

    def reader(self):
        return VisibilityReaderHDF5(self)

    def close(self):
        # Flush buffered writes; the file handle stays open for the reader.
        self._file.flush()


class VisibilityReaderHDF5(VisibilityReader):
    def _dset(self, channel, w_slice):
        return self._collector._dsets.get(f"ch{channel}/ws{w_slice}")

    def len(self, channel, w_slice):
        d = self._dset(channel, w_slice)
        return 0 if d is None else d["uv"].shape[0]

    def slice_arrays(self, channel, w_slice):
        d = self._dset(channel, w_slice)
        if d is None:
            return _empty_chunk(self._collector.num_pols)
        return VisChunk(d["uv"][:], d["sub_uv"][:], d["w_plane"][:],
                        d["weights"][:], d["vis"][:])

    def iter_slice(self, channel, w_slice, block_size=None):
        """Stream fixed-size blocks through a recycled buffer, so read-back
        host memory is bounded by ``block_size``.  Yielded chunks are views
        into the buffer: consume each before advancing the iterator."""
        d = self._dset(channel, w_slice)
        if d is None:
            return
        n = d["uv"].shape[0]
        if n == 0:
            return
        if block_size is None or block_size >= n:
            yield self.slice_arrays(channel, w_slice)
            return
        P = self._collector.num_pols
        buf = VisChunk(np.empty((block_size, 2), np.int16),
                       np.empty((block_size, 2), np.int16),
                       np.empty((block_size,), np.int16),
                       np.empty((block_size, P), np.float32),
                       np.empty((block_size, P), np.complex64))
        for start in range(0, n, block_size):
            m = min(block_size, n - start)
            src = np.s_[start:start + m]
            for name in ("uv", "sub_uv", "w_plane", "weights", "vis"):
                d[name].read_direct(buf[name], src, np.s_[:m])
            yield VisChunk(buf.uv[:m], buf.sub_uv[:m], buf.w_plane[:m],
                           buf.weights[:m], buf.vis[:m])

    def close(self):
        self._collector._file.close()
