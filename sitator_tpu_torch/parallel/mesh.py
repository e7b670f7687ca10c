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

The multi-process form, the counterpart of the reference's under
``jax.distributed``: after ``torch.distributed.init_process_group`` every
rank calls :func:`frame_mesh` with its own devices, and the mesh spans all
ranks' devices in rank order (``process_indices`` holds each device's
rank).  :func:`shard_frames_local` places each rank's own frame slab at its
global offsets; :func:`shard_frames` takes the same global array on every
rank and places that rank's shards.  :func:`shard_map_frames` runs on a
rank's own shards, and :func:`gather_frames` is then a collective that
every rank calls: an all-gather of the block onto each rank's first device,
so the statistics computed from it are the same on every rank.  NCCL
serves ranks with a card each; gloo serves CPU ranks and ranks that share a
card.  Under gloo the all-gather of CUDA tensors (the one tensor collective
here) is staged through pinned host buffers.  The engines stay in one
process (:func:`bind_mesh`), as the reference's do.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

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


def _rank():
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_available() \
        and dist.is_initialized() else 0


def _world():
    """The default process group's size (1 without one)."""
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


class FrameMesh:
    """A 1-D mesh over the frame axis.

    ``devices`` is a NumPy object array of torch devices (so
    ``mesh.devices.size`` reads as in the reference); ``axis_names`` is
    ``("frames",)``.  ``process_indices`` gives each device's process (its
    rank in the default process group; by default every device is this
    process's) and ``process_index`` is this process's rank: the shards
    this process holds are ``local``.  ``streams`` holds one CUDA stream per
    local card shard, made on first use (None for a CPU or another rank's
    shard).  The mesh also keeps the copies of replicated arguments that
    :func:`shard_map_frames` made for a device other than the one they live
    on."""

    def __init__(self, devices, process_indices=None):
        devs = [_device(d) for d in devices]
        if not devs:
            raise ValueError("a frame mesh needs at least one device")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = (FRAME_AXIS,)
        self.process_index = _rank()
        self.process_indices = (tuple(process_indices)
                                if process_indices is not None
                                else (self.process_index,) * len(devs))
        self._streams = None
        self._replicas = {}

    def __repr__(self):
        return (f"FrameMesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")

    @property
    def local(self):
        """The indices of this process's shards, in mesh order."""
        return [i for i, p in enumerate(self.process_indices)
                if p == self.process_index]

    @property
    def spans_processes(self):
        """True when the mesh holds devices of more than one process."""
        return len(set(self.process_indices)) > 1

    @property
    def streams(self):
        if self._streams is None:
            self._streams = [
                torch.cuda.Stream(d) if d.type == "cuda"
                and p == self.process_index else None
                for d, p in zip(self.devices, self.process_indices)]
        return self._streams

    def replicate(self, x):
        """Place ``x`` (a tensor, or a dict of them) on every distinct
        local device of the mesh now, so the first sharded call does not
        copy; returns ``x``."""
        for dev in dict.fromkeys(self.devices[self.local]):
            self._replicated(x, dev)
        return x

    def _replicated(self, x, dev):
        """``x`` as a shard on ``dev`` sees it.  A tensor on another
        accelerator is copied once and the copy kept (a dict value by
        value) until ``x`` is written in place (its version counters move:
        then it is copied again); CPU tensors (host parameters such as the
        kernels' packed cell) and everything else pass through.  The
        calling stream waits for the copy by its event."""
        if not _needs_copy(x, dev):
            return x
        key = (id(x), dev)
        stream = torch.cuda.current_stream(dev)
        version = _versions(x)
        hit = self._replicas.get(key)
        if hit is None or hit[3] != version:
            if len(self._replicas) >= 256:   # engines replicate a few objects
                self._replicas.clear()
            with torch.cuda.device(dev):
                copy = _copy_to(x, dev)
            hit = self._replicas[key] = (x, copy, stream.record_event(),
                                         version)
        stream.wait_event(hit[2])
        _record_stream(hit[1], stream)
        return hit[1]


def _needs_copy(x, dev):
    if torch.is_tensor(x):
        return x.device.type != "cpu" and x.device != dev
    if isinstance(x, dict):
        return any(_needs_copy(v, dev) for v in x.values())
    return False


def _versions(x):
    """The version counters of ``x`` (a tensor, or a dict's tensor
    values), which every in-place write moves; None for an inference
    tensor, which keeps none."""
    if torch.is_tensor(x):
        return None if x.is_inference() else x._version
    return tuple(_versions(v) for v in x.values() if torch.is_tensor(v))


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


def _cards(n_devices=None):
    """This process's visible cards (the first ``n_devices`` of them);
    RuntimeError without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "frame_mesh: no CUDA device is visible; pass devices=[...] "
            "(for example ['cpu'] * 8) for a mesh on the CPU")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())][:n_devices]


def frame_mesh(n_devices=None, devices=None) -> FrameMesh:
    """1-D mesh over the frame axis: every visible card by default, the
    first ``n_devices`` of them, or the explicit ``devices`` (a device may
    repeat).  Without a card and without ``devices`` it raises: the mesh
    never falls back to the CPU.

    In a process group of several ranks every rank calls it with its own
    devices (the same rules apply on each rank: with one rank a card, pass
    ``devices=[that card]``); the ranks exchange their lists once and the
    mesh spans them in rank order.  A rank whose devices are refused makes
    every rank raise."""
    if _world() == 1:
        return FrameMesh(_cards(n_devices) if devices is None else devices)
    try:
        mine = [str(_device(d)) for d in (
            _cards(n_devices) if devices is None else devices)]
    except RuntimeError as e:
        mine = str(e)
    every = [None] * _world()
    dist.all_gather_object(every, mine or "a frame mesh needs at least "
                           "one device")
    failed = [f"rank {r}: {x}" for r, x in enumerate(every)
              if isinstance(x, str)]
    if failed:
        raise RuntimeError("frame_mesh failed on " + "; ".join(failed))
    return FrameMesh([d for devs in every for d in devs],
                     [r for r, devs in enumerate(every) for _ in devs])


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
    """One frame-sharded array: ``shards[j]`` holds frames ``offsets[j]``
    onwards on ``mesh.devices[mesh.local[j]]`` (in one process, every
    shard of the mesh; across processes, this rank's, at their global
    offsets); on a card ``events[j]`` marks the end of the work that wrote
    it (None where nothing is pending).  ``np.asarray`` gathers it to the
    host in one process; across processes it raises, and every rank calls
    :func:`gather_frames` instead."""

    def __init__(self, mesh, shards, offsets, events=None):
        self.mesh = mesh
        self.shards = list(shards)
        self.offsets = list(offsets)
        self.events = list(events) if events is not None \
            else [None] * len(self.shards)

    def __array__(self, dtype=None, copy=None):
        if self.mesh.spans_processes:
            raise RuntimeError(
                "this frame-sharded array spans "
                f"{len(set(self.mesh.process_indices))} processes: the "
                "other ranks' shards cannot be fetched here; call "
                "gather_frames on every rank")
        out = gather_frames(self, "cpu").numpy()
        return out if dtype is None else out.astype(dtype)


def shard_frames(arr, mesh) -> ShardedFrames:
    """Split the leading axis of ``arr`` into ``mesh.devices.size``
    contiguous equal shards, one on each device of the mesh (across
    processes ``arr`` is the same global array on every rank, and each rank
    places its own shards).  A length the mesh size does not divide raises.
    A host array goes up once for each run of consecutive shards on one
    device (the whole array at once for a mesh over one card: a copy per
    shard from freshly pinned memory cost more host time than it saved)
    and is split into views there; a tensor is split into views, copied to
    shards on other devices.  Each shard's stream waits for the work that
    made its frames."""
    mesh = _as_mesh(mesh)
    n_dev = mesh.devices.size
    n = arr.shape[0]
    if n % n_dev:
        raise ValueError(
            f"shard_frames: the frame axis has {n} frames, which the "
            f"{n_dev} devices of the mesh do not divide; pad it first "
            "(pad_frames)")
    m = n // n_dev
    return _place(arr, mesh, m, [i * m for i in mesh.local])


def _place(arr, mesh, m, starts):
    """The local shards of ``mesh``: local shard j holds the ``m`` frames
    of ``arr`` from ``starts[j]`` on, at global offset ``mesh.local[j] *
    m``."""
    local = mesh.local
    if torch.is_tensor(arr):
        sources = [arr] * len(local)
    else:
        arr = np.ascontiguousarray(arr)
        sources, runs = [], []
        j = 0
        while j < len(local):
            k = j
            while (k + 1 < len(local) and starts[k + 1] == starts[k] + m
                   and mesh.devices[local[k + 1]] == mesh.devices[local[j]]):
                k += 1
            run = torch.tensor(arr[starts[j]:starts[k] + m],
                               device=mesh.devices[local[j]])
            sources += [run] * (k + 1 - j)
            runs += [q * m for q in range(k + 1 - j)]
            j = k + 1
        starts = runs
    ready = {}
    shards, events = [], []
    for j, i in enumerate(local):
        dev, src = mesh.devices[i], sources[j]
        part = src[starts[j]:starts[j] + m]
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
    return ShardedFrames(mesh, shards, [i * m for i in local], events)


def shard_frames_local(local_arr, mesh) -> ShardedFrames:
    """Multi-process-safe :func:`shard_frames`: each process contributes
    its LOCAL contiguous frame slab (global frame order = process order x
    local order), split over its own shards and placed at their global
    offsets.  Degenerates to :func:`shard_frames` in a single process.  The
    ranks exchange their slabs' shapes: a slab that is not the same number
    of frames a shard on every rank, or not of the same trailing shape,
    raises on every rank.  The mesh's device sequence must be
    process-contiguous in process-index order, or each process's contiguous
    frames would land on non-contiguous global indices; that is checked
    here."""
    mesh = _as_mesh(mesh)
    procs = list(mesh.process_indices)
    if procs != sorted(procs):
        raise ValueError(
            "mesh devices are not process-contiguous in process_index "
            "order; build the frame mesh in process order (frame_mesh) "
            "rather than from a reordered device list, or place explicit "
            "per-device shards instead")
    if not mesh.spans_processes:
        return shard_frames(local_arr, mesh)
    shapes = [None] * _world()
    dist.all_gather_object(shapes, tuple(local_arr.shape))
    counts = _shard_counts(mesh)
    m = sum(s[0] for s in shapes) // mesh.devices.size
    if any(s[0] != c * m or s[1:] != shapes[0][1:]
           for s, c in zip(shapes, counts)):
        raise ValueError(
            "shard_frames_local: the ranks' frame slabs disagree: shapes "
            f"{shapes} for {counts} shards a rank; every rank passes the "
            "same number of frames a shard, of the same trailing shape")
    return _place(local_arr, mesh, m, [j * m for j in range(counts[_rank()])])


def _shard_counts(mesh):
    """The number of shards of each rank of the process group."""
    counts = [0] * _world()
    for p in mesh.process_indices:
        counts[p] += 1
    return counts


def _as_tuple(out, n_outputs):
    out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
    if len(out) != n_outputs:
        raise ValueError(f"the shard function returned {len(out)} outputs, "
                         f"expected {n_outputs}")
    return out


def shard_map_frames(fn, mesh, n_frame_args: int, *args,
                     n_outputs: int = 2):
    """Run ``fn`` once per shard of a 1-D frame mesh (across processes, per
    shard of this rank): the first ``n_frame_args`` arguments are
    frame-sharded (a :class:`ShardedFrames`, or a tensor or host array that
    is split here), the rest replicated (copied once to each distinct
    device and kept for later calls until written in place).  Returns
    ``n_outputs`` :class:`ShardedFrames`.

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
    local = mesh.local
    # the replicated arguments may still be in the making on the caller's
    # stream of each device
    called = {d: torch.cuda.current_stream(d).record_event()
              for d in dict.fromkeys(mesh.devices[local]) if d.type == "cuda"}
    outs = [[] for _ in range(n_outputs)]
    events = []
    for j, i in enumerate(local):
        dev = mesh.devices[i]
        if dev.type != "cuda":
            res = fn(*(s.shards[j] for s in sharded), *rep)
            events.append(None)
        else:
            stream = mesh.streams[i]
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                stream.wait_event(called[dev])
                parts = []
                for s in sharded:
                    if s.events[j] is not None:
                        stream.wait_event(s.events[j])
                    s.shards[j].record_stream(stream)
                    parts.append(s.shards[j])
                res = fn(*parts, *(mesh._replicated(a, dev) for a in rep))
                events.append(stream.record_event())
        for k, o in enumerate(_as_tuple(res, n_outputs)):
            outs[k].append(o)
    return tuple(ShardedFrames(mesh, o, sharded[0].offsets, events)
                 for o in outs)


def gather_frames(sharded, device=None):
    """The whole array of ``sharded`` on ``device`` (default: the first
    device of this process's shards), concatenated on that device's current
    stream after each shard's event; None when the shards are None.  The
    counterpart of the reduction XLA inserts after a sharded computation.
    A single shard already on ``device`` with nothing pending is returned
    as it is.  Across processes it is a collective that every rank calls:
    the ranks' shards are all-gathered (:func:`_all_gather_frames`), so
    every rank gets the same array."""
    mesh = sharded.mesh
    dev = mesh.devices[mesh.local[0]] if device is None else _device(device)
    parts = sharded.shards
    if any(p is None for p in parts):
        return None
    if len(parts) == 1 and parts[0].device == dev \
            and sharded.events[0] is None:
        block = parts[0]
    else:
        for p, ev in zip(parts, sharded.events):
            if p.device.type == "cuda":
                # the copy or the concatenation reads the shard on its
                # device's current stream, which must wait for the shard's
                # stream
                cur = torch.cuda.current_stream(p.device)
                if ev is not None:
                    cur.wait_event(ev)
                p.record_stream(cur)
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                block = torch.cat([p.to(dev, non_blocking=True)
                                   for p in parts])
        else:
            block = torch.cat([p.to(dev) for p in parts])
    if not mesh.spans_processes:
        return block
    return _all_gather_frames(block, mesh)


def _all_gather_frames(block, mesh):
    """Every rank's ``block`` (its shards' frames, in mesh order) gathered
    into the mesh's frame order on ``block.device``.  Ranks with fewer
    shards send zero rows up to the largest rank's count.  Under NCCL the
    collective runs on the card; otherwise a CUDA block is staged through
    pinned host buffers (gloo's all-gather of CUDA tensors is not counted
    on)."""
    counts = _shard_counts(mesh)
    m = block.shape[0] // counts[_rank()]
    width, rest = max(counts) * m, block.shape[1:]
    if block.shape[0] < width:
        block = torch.cat([block, block.new_zeros((width - block.shape[0],)
                                                  + rest)])
    staged = block.is_cuda and dist.get_backend() != "nccl"
    if staged:
        send = torch.empty(block.shape, dtype=block.dtype, pin_memory=True)
        send.copy_(block)
    else:
        send = block.contiguous()
    recv = [torch.empty(send.shape, dtype=send.dtype, device=send.device,
                        pin_memory=staged) for _ in counts]
    dist.all_gather(recv, send)
    out = torch.empty((mesh.devices.size, m) + rest, dtype=block.dtype,
                      device=block.device)
    procs = np.asarray(mesh.process_indices)
    for r, c in enumerate(counts):
        if c:
            idx = torch.as_tensor(np.flatnonzero(procs == r),
                                  device=block.device)
            out[idx] = recv[r][:c * m].view((c, m) + rest).to(
                block.device, non_blocking=True)
    return out.view((-1,) + rest)


def bind_mesh(mesh, device):
    """``(mesh, device)`` of an engine built with ``mesh`` and ``device``.
    ``mesh`` None stays None and the device is ``device``.  Otherwise
    ``mesh`` must be a :class:`FrameMesh` (or a placement on one) whose
    first device is ``device`` (a device given without an index matches
    any device of its type), else ValueError; the engine then runs on the
    mesh's first device, where its accumulators and statistics live.  A
    mesh that spans processes raises ValueError: the engines run in one
    process, as the reference's do (they fetch their labels to the
    host)."""
    device = torch.device(device)
    if mesh is None:
        return None, device
    mesh = _as_mesh(mesh)
    if mesh.spans_processes:
        raise ValueError(
            "this frame mesh spans processes "
            f"{sorted(set(mesh.process_indices))}; the engines run in one "
            "process: build each rank's engine on a mesh of its own "
            "devices (FrameMesh([...])), or drive the analysis steps "
            "(mxu_analysis_step, fused_analysis_step, analysis_step) on "
            "every rank")
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
