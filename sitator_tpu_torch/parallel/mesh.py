"""Frame-axis sharding (counterpart of ``sitator_tpu.parallel.mesh``).

The workload's parallel axis is the frame axis: the landmark vectors, the
assignment and the lattice drift of a frame depend on that frame alone.  A
block of frames is split into contiguous shards, each shard runs the kernel
on its own device (or on its own stream of one device), and the per-frame
results come back to the mesh's first device, where the jump statistics run
once over the whole block, so they are the unsharded ones by construction.

A mesh is a list of devices in which a device may repeat.
``frame_mesh(devices=["cpu"] * 8)`` is the counterpart of the reference's 8
virtual CPU devices; ``frame_mesh(devices=["cuda:0"] * n)`` runs n shards on
one card, each on its own stream; ``frame_mesh()`` takes every visible card.
Work on different streams is ordered by CUDA events, never by a host
synchronisation, so shards on one card overlap and shards on several cards
do not wait for each other.  A one-device mesh whose device is the inputs'
device calls the function directly: no stream, copy, event or
synchronisation is added.

This is the single-process form.  The reference's multi-process form (one
process per host, the mesh spanning them) has no counterpart yet:
:func:`shard_frames_local` degenerates to :func:`shard_frames`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FRAME_AXIS = "frames"

__all__ = ["FRAME_AXIS", "frame_mesh", "frame_sharding", "replicated",
           "shard_frames", "shard_frames_local", "pad_frames",
           "shard_map_frames", "FrameMesh", "ShardedFrames", "gather_frames"]


def _device(d):
    """``d`` as a torch device with the index of a CUDA device filled in."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class FrameMesh:
    """A 1-D mesh over the frame axis.

    ``devices`` is a NumPy object array of torch devices (so
    ``mesh.devices.size`` reads as in the reference); ``axis_names`` is
    ``("frames",)``; ``streams`` holds one CUDA stream per shard, made on
    first use (None for a CPU shard).  ``process_indices`` gives each
    device's process: all 0, since the mesh spans one process.  The mesh
    also keeps the copies of replicated arguments that
    :func:`shard_map_frames` made for a device other than the one they live
    on."""

    def __init__(self, devices):
        devs = [_device(d) for d in devices]
        if not devs:
            raise ValueError("a frame mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = (FRAME_AXIS,)
        self.process_indices = (0,) * len(devs)
        self._streams = None
        self._replicas = {}

    def __repr__(self):
        return (f"FrameMesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")

    @property
    def streams(self):
        if self._streams is None:
            self._streams = [torch.cuda.Stream(d) if d.type == "cuda"
                             else None for d in self.devices]
        return self._streams

    def replicate(self, x):
        """Place ``x`` (a tensor, or a dict of them) on every distinct
        device of the mesh now, so the first sharded call does not copy;
        returns ``x``."""
        for dev in dict.fromkeys(self.devices):
            self._replicated(x, dev)
        return x

    def _replicated(self, x, dev):
        """``x`` as a shard on ``dev`` sees it.  A tensor on another
        accelerator is copied once and the copy kept (a dict value by
        value); CPU tensors (host parameters such as the kernels' packed
        cell) and everything else pass through.  The calling stream waits
        for the copy by its event."""
        if not _needs_copy(x, dev):
            return x
        key = (id(x), dev)
        stream = torch.cuda.current_stream(dev)
        hit = self._replicas.get(key)
        if hit is None:
            if len(self._replicas) >= 256:   # engines replicate a few objects
                self._replicas.clear()
            with torch.cuda.device(dev):
                copy = _copy_to(x, dev)
            hit = self._replicas[key] = (x, copy, stream.record_event())
        stream.wait_event(hit[2])
        _record_stream(hit[1], stream)
        return hit[1]


def _needs_copy(x, dev):
    if torch.is_tensor(x):
        return x.device.type != "cpu" and x.device != dev
    if isinstance(x, dict):
        return any(_needs_copy(v, dev) for v in x.values())
    return False


def _copy_to(x, dev):
    if torch.is_tensor(x):
        return x.to(dev, non_blocking=True) if _needs_copy(x, dev) else x
    if isinstance(x, dict):
        return {k: _copy_to(v, dev) for k, v in x.items()}
    return x


def _record_stream(x, stream):
    if torch.is_tensor(x):
        if x.device == stream.device:
            x.record_stream(stream)
    elif isinstance(x, dict):
        for v in x.values():
            _record_stream(v, stream)


class FramePlacement(NamedTuple):
    """Where an array lives on a mesh: ``spec == ("frames",)`` splits the
    leading axis over the mesh, ``spec == ()`` copies it to every device."""
    mesh: FrameMesh
    spec: tuple


def _as_mesh(mesh):
    if isinstance(mesh, FrameMesh):
        return mesh
    if isinstance(mesh, FramePlacement):
        return mesh.mesh
    raise TypeError(f"expected a FrameMesh (frame_mesh()), got "
                    f"{type(mesh).__name__}")


def frame_mesh(n_devices=None, devices=None) -> FrameMesh:
    """1-D mesh over the frame axis: every visible card by default, the
    first ``n_devices`` of them, or the explicit ``devices`` (a device may
    repeat).  Without a card and without ``devices`` it raises: the mesh
    never falls back to the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "frame_mesh: no CUDA device is visible; pass devices=[...] "
                "(for example ['cpu'] * 8) for a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return FrameMesh(devices)


def frame_sharding(mesh) -> FramePlacement:
    """Placement that splits the leading (frame) axis across the mesh."""
    return FramePlacement(_as_mesh(mesh), (FRAME_AXIS,))


def replicated(mesh) -> FramePlacement:
    """Placement that copies an array to every device of the mesh."""
    return FramePlacement(_as_mesh(mesh), ())


def pad_frames(arr, multiple):
    """Pad the leading axis to a multiple (repeating the last frame), so
    frame shards divide evenly.  Returns (padded, n_valid)."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = np.broadcast_to(arr[-1:], (rem,) + arr.shape[1:])
    return np.concatenate([arr, pad], axis=0), n


class ShardedFrames:
    """One frame-sharded array: ``shards[i]`` holds frames ``offsets[i]``
    onwards on ``mesh.devices[i]``; on a card ``events[i]`` marks the end of
    the work that wrote it (None where nothing is pending).  ``np.asarray``
    gathers it to the host."""

    def __init__(self, mesh, shards, offsets, events=None):
        self.mesh = mesh
        self.shards = list(shards)
        self.offsets = list(offsets)
        self.events = list(events) if events is not None \
            else [None] * len(self.shards)

    def __array__(self, dtype=None, copy=None):
        out = gather_frames(self, "cpu").numpy()
        return out if dtype is None else out.astype(dtype)


def shard_frames(arr, mesh) -> ShardedFrames:
    """Split the leading axis of ``arr`` into ``mesh.devices.size``
    contiguous equal shards, one on each device of the mesh.  A length the
    mesh size does not divide raises.  A host array goes up once for each
    run of consecutive shards on one device (the whole array at once for a
    mesh over one card: a copy per shard from freshly pinned memory cost
    more host time than it saved) and is split into views there; a tensor
    is split into views, copied to shards on other devices.  Each shard's
    stream waits for the work that made its frames."""
    mesh = _as_mesh(mesh)
    n_dev = mesh.devices.size
    n = arr.shape[0]
    if n % n_dev:
        raise ValueError(
            f"shard_frames: the frame axis has {n} frames, which the "
            f"{n_dev} devices of the mesh do not divide; pad it first "
            "(pad_frames)")
    m = n // n_dev
    if torch.is_tensor(arr):
        sources, starts = [arr] * n_dev, [i * m for i in range(n_dev)]
    else:
        arr = np.ascontiguousarray(arr)
        sources, starts = [], []
        i = 0
        while i < n_dev:
            j = i
            while j + 1 < n_dev and mesh.devices[j + 1] == mesh.devices[i]:
                j += 1
            run = torch.tensor(arr[i * m:(j + 1) * m],
                               device=mesh.devices[i])
            sources += [run] * (j + 1 - i)
            starts += [k * m for k in range(j + 1 - i)]
            i = j + 1
    ready = {}
    shards, events = [], []
    for i, dev in enumerate(mesh.devices):
        src = sources[i]
        part = src[starts[i]:starts[i] + m]
        if dev.type != "cuda":
            shards.append(part.to(dev))
            events.append(None)
            continue
        if src.is_cuda and id(src) not in ready:
            ready[id(src)] = torch.cuda.current_stream(
                src.device).record_event()
        stream = mesh.streams[i]
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            if src.is_cuda:
                stream.wait_event(ready[id(src)])
                if src.device == dev:
                    part.record_stream(stream)
            shards.append(part.to(dev, non_blocking=True))
            events.append(stream.record_event())
    return ShardedFrames(mesh, shards, range(0, n, m), events)


def shard_frames_local(local_arr, mesh) -> ShardedFrames:
    """Multi-process-safe :func:`shard_frames`: each process contributes
    its LOCAL contiguous frame slab.  Degenerates to :func:`shard_frames`
    in a single process (every device has process index 0).  The mesh's
    device sequence must be process-contiguous in process-index order, or
    each process's contiguous frames would land on non-contiguous global
    indices; that is checked here."""
    mesh = _as_mesh(mesh)
    procs = list(mesh.process_indices)
    if procs != sorted(procs):
        raise ValueError(
            "mesh devices are not process-contiguous in process_index "
            "order; build the frame mesh in process order (frame_mesh) "
            "rather than from a reordered device list, or place explicit "
            "per-device shards instead")
    return shard_frames(local_arr, mesh)


def _as_tuple(out, n_outputs):
    out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    if len(out) != n_outputs:
        raise ValueError(f"the shard function returned {len(out)} outputs, "
                         f"expected {n_outputs}")
    return out


def shard_map_frames(fn, mesh, n_frame_args: int, *args,
                     n_outputs: int = 2):
    """Run ``fn`` once per shard of a 1-D frame mesh: the first
    ``n_frame_args`` arguments are frame-sharded (a :class:`ShardedFrames`,
    or a tensor or host array that is split here), the rest replicated
    (copied once to each distinct device and kept for later calls).
    Returns ``n_outputs`` :class:`ShardedFrames`.

    Each shard runs under its device and its own stream, after the work
    the caller had enqueued on that device and the events that made its
    frames ready, and records an event when its launches are enqueued;
    nothing here waits on the host.  A one-device mesh whose
    device holds the frame tensors calls ``fn`` directly."""
    mesh = _as_mesh(mesh)
    frames, rep = args[:n_frame_args], args[n_frame_args:]
    if mesh.devices.size == 1 and all(
            torch.is_tensor(a) and a.device == mesh.devices[0]
            for a in frames):
        return tuple(ShardedFrames(mesh, [o], [0])
                     for o in _as_tuple(fn(*args), n_outputs))
    sharded = [a if isinstance(a, ShardedFrames) else shard_frames(a, mesh)
               for a in frames]
    # the replicated arguments may still be in the making on the caller's
    # stream of each device
    called = {d: torch.cuda.current_stream(d).record_event()
              for d in dict.fromkeys(mesh.devices) if d.type == "cuda"}
    outs = [[] for _ in range(n_outputs)]
    events = []
    for i, dev in enumerate(mesh.devices):
        if dev.type != "cuda":
            res = fn(*(s.shards[i] for s in sharded), *rep)
            events.append(None)
        else:
            stream = mesh.streams[i]
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                stream.wait_event(called[dev])
                local = []
                for s in sharded:
                    if s.events[i] is not None:
                        stream.wait_event(s.events[i])
                    s.shards[i].record_stream(stream)
                    local.append(s.shards[i])
                res = fn(*local, *(mesh._replicated(a, dev) for a in rep))
                events.append(stream.record_event())
        for k, o in enumerate(_as_tuple(res, n_outputs)):
            outs[k].append(o)
    return tuple(ShardedFrames(mesh, o, sharded[0].offsets, events)
                 for o in outs)


def gather_frames(sharded, device=None):
    """The whole array of ``sharded`` on ``device`` (default: the mesh's
    first device), concatenated on that device's current stream after each
    shard's event; None when the shards are None.  The counterpart of the
    reduction XLA inserts after a sharded computation.  A single shard
    already on ``device`` with nothing pending is returned as it is."""
    dev = sharded.mesh.devices[0] if device is None else _device(device)
    parts = sharded.shards
    if any(p is None for p in parts):
        return None
    if len(parts) == 1 and parts[0].device == dev \
            and sharded.events[0] is None:
        return parts[0]
    for p, ev in zip(parts, sharded.events):
        if p.device.type == "cuda":
            # the copy or the concatenation reads the shard on its device's
            # current stream, which must wait for the shard's stream
            cur = torch.cuda.current_stream(p.device)
            if ev is not None:
                cur.wait_event(ev)
            p.record_stream(cur)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            return torch.cat([p.to(dev, non_blocking=True) for p in parts])
    return torch.cat([p.to(dev) for p in parts])


def bind_mesh(mesh, device):
    """``(mesh, device)`` of an engine built with ``mesh`` and ``device``.
    ``mesh`` None stays None and the device is ``device``.  Otherwise
    ``mesh`` must be a :class:`FrameMesh` (or a placement on one) whose
    first device is ``device`` (a device given without an index matches
    any device of its type), else ValueError; the engine then runs on the
    mesh's first device, where its accumulators and statistics live."""
    device = torch.device(device)
    if mesh is None:
        return None, device
    mesh = _as_mesh(mesh)
    first = mesh.devices[0]
    if first.type != device.type or (device.index is not None
                                     and _device(device) != first):
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{first}")
    return mesh, first


def run_sharded(fn, mesh, n_frame_args, *args, n_outputs=2):
    """``fn(*args)`` called directly when ``mesh`` is None, else
    :func:`shard_map_frames` with each output gathered on the mesh's first
    device.  Returns the ``n_outputs`` tensors."""
    if mesh is None:
        return fn(*args)
    return tuple(gather_frames(o) for o in shard_map_frames(
        fn, mesh, n_frame_args, *args, n_outputs=n_outputs))


def place_frames(arr, mesh, device):
    """Host frames ``arr`` as float32: a tensor on ``device`` when ``mesh``
    is None or has one device (the engines' ``device``), else frame shards
    over it (:func:`shard_frames`)."""
    if mesh is None or mesh.devices.size == 1:
        return torch.as_tensor(arr, dtype=torch.float32, device=device)
    return shard_frames(np.ascontiguousarray(arr, np.float32), mesh)
