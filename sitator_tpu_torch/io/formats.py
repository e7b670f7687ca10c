"""The trajectory reader protocol, the in-memory reader and the background
prefetcher: copies of ``sitator_tpu.io.formats``'s ``TrajectoryReader``,
``ArrayTrajectory`` and ``ChunkedFeeder``.  The file formats are not ported
yet."""
from __future__ import annotations

import queue as _queue
import threading

import numpy as np

__all__ = ["TrajectoryReader", "ArrayTrajectory", "ChunkedFeeder"]


class TrajectoryReader:
    """Protocol: ``len(r)`` frames; ``r[lo:hi] -> (n, A, 3) float32``;
    optional ``r.structure``."""

    structure = None

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, key):
        raise NotImplementedError

    @property
    def n_atoms(self):
        return self[0:1].shape[1]


class ArrayTrajectory(TrajectoryReader):
    def __init__(self, array, structure=None):
        self._a = np.asarray(array)
        self.structure = structure

    def __len__(self):
        return self._a.shape[0]

    def __getitem__(self, key):
        return np.asarray(self._a[key], dtype=np.float32)


class ChunkedFeeder:
    """Background prefetcher: reads fixed-size frame blocks from a
    ``TrajectoryReader`` on a worker thread so host IO overlaps device
    compute.  Iterate to get ``(lo, block)`` pairs in order.
    """

    def __init__(self, reader, block_frames, start=0, stop=None, depth=2):
        self.reader = reader
        self.block = int(block_frames)
        self.start = int(start)
        self.stop = len(reader) if stop is None else int(stop)
        self.depth = int(depth)

    def __iter__(self):
        q = _queue.Queue(maxsize=self.depth)
        stop_flag = threading.Event()

        def worker():
            try:
                for lo in range(self.start, self.stop, self.block):
                    if stop_flag.is_set():
                        return
                    hi = min(lo + self.block, self.stop)
                    q.put((lo, self.reader[lo:hi]))
                q.put(None)
            except BaseException as e:  # surface reader errors to consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop_flag.set()
