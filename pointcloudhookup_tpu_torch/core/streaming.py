"""Double-buffered host-to-device tile streaming.

Counterpart of ``pointcloudhookup_tpu/core/streaming.py``.  A multi-tile
corridor (50M+ points) is more than one device chunk, and the host must
decode the next LAS tile while the device processes the current one: a
background thread decodes, pads and uploads one tile ahead.

On a CUDA device the staging buffers are pinned, the producer thread copies
with ``non_blocking=True`` on a CUDA stream of its own (and dequantises the
u16 wire there), and the consumer's stream waits on an event recorded after
that work; ``record_stream`` tells the caching allocator that the consumer's
stream uses the tensors, so their memory is not handed out again early.
"""

from __future__ import annotations

import contextlib
import contextvars
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from pointcloudhookup_tpu_torch.ops.morton import fma_f32
from pointcloudhookup_tpu_torch.state import to_numpy
from pointcloudhookup_tpu_torch.utils import trace


def _dequantize_u16(q, scale, shift, n):
    """u16 lattice -> centred float32 coordinates and validity mask on the
    tensors' device.  q: int32[capacity, 3] lattice steps 0..65535; scale,
    shift: float32[3]; n: the valid row count.  q * scale + shift is one
    fused multiply-add, as XLA:CPU compiles the JAX function."""
    xyz = fma_f32(q.to(torch.float32), scale[None, :], shift[None, :])
    mask = torch.arange(q.shape[0], device=q.device) < n
    return torch.where(mask[:, None], xyz, 0.0), mask


class TileStreamer:
    """Iterates (xyz float32[capacity, 3], mask bool[capacity], meta dict)
    on ``device`` over a sequence of tile sources with ``prefetch`` tiles
    prepared ahead.

    ``sources`` yields file paths (decoded by the native LAS reader, or
    io/las.py without a compiler; meta["reader"] says which) or numpy
    f64[N, 3] arrays.  A tile larger than the capacity is split into
    chunks in row order.  On a CUDA device meta["uploaded"] is the event
    recorded on the copy stream after the chunk's upload (None on the CPU).

    wire="f32" ships padded float32[capacity, 3] and bool[capacity] (13 B a
    point, exact).  wire="u16" quantises each chunk on the host to a
    chunk-local u16 lattice and dequantises and masks on the device (6 B a
    point); a chunk whose lattice pitch (extent / 65535 on its widest axis)
    exceeds max_pitch goes on the f32 wire instead (None disables the
    guard).
    """

    def __init__(
        self,
        sources: Iterable,
        capacity: Optional[int] = None,
        origin: Optional[np.ndarray] = None,
        device="cuda",
        decode: Optional[Callable] = None,
        prefetch: int = 1,
        max_memory_percent: float = 30.0,
        wire: str = "f32",
        max_pitch: Optional[float] = 0.05,
    ):
        if wire not in ("f32", "u16"):
            raise ValueError(f"wire must be 'f32' or 'u16', got {wire!r}")
        self.wire = wire
        self.max_pitch = max_pitch
        self.sources = list(sources)
        self.origin = None if origin is None else np.asarray(origin, np.float64)
        self.device = torch.device(device)
        self.decode = decode
        self.prefetch = max(1, prefetch)
        if capacity is None:
            from pointcloudhookup_tpu_torch.core.governor import auto_capacity, estimate_points

            biggest = 0
            for s in self.sources:
                n = len(s) if isinstance(s, np.ndarray) else estimate_points(str(s))
                biggest = max(biggest, n or 0)
            capacity = auto_capacity(
                device=self.device, prefetch=self.prefetch,
                max_memory_percent=max_memory_percent, n_points=biggest or None,
            )
        # big tiles align to the compaction kernel's 32k block so the fast
        # step's ground pre-cut can engage; padding rows ride as masked
        if capacity >= 131072:
            capacity = -(-capacity // 32768) * 32768
        self.capacity = capacity

    def _load(self, source) -> tuple[np.ndarray, str]:
        with trace.span("stream.decode"):
            if self.decode is not None:
                return np.asarray(self.decode(source), np.float64), "decode"
            if isinstance(source, np.ndarray):
                return np.asarray(source, np.float64), "array"
            from pointcloudhookup_tpu_torch.native import las_read_xyz

            xyz = las_read_xyz(str(source))
            if xyz is not None:
                return xyz, "native"
            from pointcloudhookup_tpu_torch.io.las import read_las

            return read_las(source).xyz(), "python"

    def _chunks(self) -> Iterator[tuple[np.ndarray, dict]]:
        for i, src in enumerate(self.sources):
            pts, reader = self._load(src)
            pts = pts.reshape(-1, 3)
            for start in range(0, max(len(pts), 1), self.capacity):
                chunk = pts[start: start + self.capacity]
                yield chunk, dict(tile=i, offset=start, source=src, n=len(chunk),
                                  reader=reader)

    def _host(self, shape, dtype):
        """A zeroed staging tensor: pinned for a CUDA device."""
        return torch.zeros(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _prepare(self, chunk: np.ndarray, meta: dict, stream):
        with trace.span("stream.stage"):
            with trace.span("stream.stage.stats"):
                origin = self.origin if self.origin is not None else (
                    chunk.mean(axis=0) if len(chunk) else np.zeros(3)
                )
                n = len(chunk)
                wire = self.wire
                lo = chunk.min(axis=0) if n else np.zeros(3)
                hi = chunk.max(axis=0) if n else np.zeros(3)
                if wire == "u16":
                    scale = np.maximum((hi - lo) / 65535.0, 1e-9)
                    if self.max_pitch is not None and float(scale.max()) > self.max_pitch:
                        wire = "f32"  # lattice too coarse for this chunk: go exact
            with trace.span("stream.stage.alloc"):
                if wire == "u16":
                    # the u16 bits travel as int16 (torch has few uint16 kernels)
                    bufs = (self._host((self.capacity, 3), torch.int16),
                            self._host((2, 3), torch.float32))
                else:
                    bufs = (self._host((self.capacity, 3), torch.float32),
                            self._host((self.capacity,), torch.bool))
            with trace.span("stream.stage.fill"):
                copying = (torch.cuda.stream(stream) if stream is not None
                           else contextlib.nullcontext())
                if wire == "u16":
                    q, consts = bufs
                    if n:
                        tmp = chunk - lo
                        tmp /= scale
                        np.rint(tmp, out=tmp)
                        np.clip(tmp, 0, 65535, out=tmp)
                        q.numpy().view(np.uint16)[:n] = tmp
                    consts.numpy()[0] = scale
                    consts.numpy()[1] = lo - origin
                    with copying:
                        qd = q.to(self.device, non_blocking=True).to(torch.int32) & 0xFFFF
                        cd = consts.to(self.device, non_blocking=True)
                        xa, ma = _dequantize_u16(qd, cd[0], cd[1], n)
                else:
                    xyz, mask = bufs
                    if n:
                        np.subtract(chunk, origin, out=xyz.numpy()[:n], casting="same_kind")
                    mask[:n] = True
                    with copying:
                        xa = xyz.to(self.device, non_blocking=True)
                        ma = mask.to(self.device, non_blocking=True)
                trace.count("upload_bytes", sum(b.nbytes for b in bufs))
                event = None
                if stream is not None:
                    event = torch.cuda.Event()
                    event.record(stream)
            meta = dict(meta, origin=origin, wire=wire, span=hi - lo, uploaded=event)
        return xa, ma, meta, event

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        errors: list[BaseException] = []
        cuda = self.device.type == "cuda"
        if cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(self.device) if cuda else None

        def producer():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for chunk, meta in self._chunks():
                    q.put(self._prepare(chunk, meta, stream))
            except BaseException as e:  # raised again on the consumer's side
                errors.append(e)
            finally:
                q.put(done)

        # the producer's spans carry the consumer's request and open span
        t = threading.Thread(target=contextvars.copy_context().run, args=(producer,),
                             daemon=True)
        t.start()
        while True:
            with trace.span("stream.wait"):
                item = q.get()
            if item is done:
                break
            xa, ma, meta, event = item
            if event is not None:
                current = torch.cuda.current_stream(self.device)
                current.wait_event(event)
                xa.record_stream(current)
                ma.record_stream(current)
            yield xa, ma, meta
        t.join()
        if errors:
            raise errors[0]


def stream_extract(
    sources,
    capacity: Optional[int] = None,
    params=None,
    origin: Optional[np.ndarray] = None,
    fetch_labels: bool = False,
    wire: str = "u16",
    fast: bool = False,
    prefetch: int = 1,
    timings: bool = False,
    precut_div: int = 4,
    device="cuda",
):
    """The extraction step over streamed tiles on ``device``; returns a list
    of per-tile (stats dict, meta).

    Only the [K]-sized tower summaries come back to the host; the
    point-sized arrays (labels, ground_keep, ds_xyz) stay on the device
    unless fetch_labels=True.  fast=True runs the fused step (geometric
    voxels, sort mode "full" with the ground pre-cut at capacity /
    precut_div, the configured cell-density floor) instead of the modular
    ``extract_step``.  timings=True adds meta["step_seconds"]: the wall time
    of the step's dispatch and the host-blocking [K] fetches."""
    from pointcloudhookup_tpu_torch.config import ExtractParams
    from pointcloudhookup_tpu_torch.models.towers import extract_step
    from pointcloudhookup_tpu_torch.ops.frontend_fused import fused_extract_step

    params = params or ExtractParams()
    if fast:
        def step(xyz, mask):
            return fused_extract_step(
                xyz, mask, params, geometric_voxels=True,
                min_cell_points=max(params.cluster.min_cell_points, 1),
                sort_mode="full", precut_div=precut_div,
            )
    else:
        def step(xyz, mask):
            return extract_step(xyz, mask, params)

    point_sized = ("labels", "ground_keep", "ds_xyz")
    results = []
    with trace.span("stream"):
        for xyz, mask, meta in TileStreamer(sources, capacity, origin=origin, device=device,
                                            wire=wire, prefetch=prefetch):
            t0 = time.perf_counter() if timings else 0.0
            with trace.span("stream.step"):
                stats = step(xyz, mask)
                out = {}
                for k, v in stats.items():
                    if k in point_sized and not fetch_labels:
                        out[k] = v  # stays on the device
                    else:
                        out[k] = to_numpy(v)
            if timings:
                meta = dict(meta, step_seconds=time.perf_counter() - t0)
            results.append((out, meta))
    return results
