"""A cell's frames: the store that the traffic mix names, cycled to the
pass's length."""
import numpy as np

from portbench.harness import spec


class Cycled:
    """A trajectory reader of ``n_frames`` frames over ``source`` (anything
    with ``len`` and slices of frames: a NumPy array, a trajectory reader):
    frame ``f`` is the source's frame ``f % len(source)``.  A slice within
    one turn is the source's slice (a view, for an array).  After
    ``sitator_tpu_torch/tools/northstar_run.py::CycleReader``."""

    def __init__(self, source, n_frames):
        self.source = source
        self.period = len(source)
        self._n = int(n_frames)

    def __len__(self):
        return self._n

    def __getitem__(self, key):
        if not isinstance(key, slice):
            raise TypeError("Cycled takes a slice of frames")
        lo, hi, step = key.indices(self._n)
        if step != 1:
            raise ValueError("Cycled takes slices with step 1")
        parts = []
        while lo < hi:
            off = lo % self.period
            take = min(self.period - off, hi - lo)
            parts.append(self.source[off:off + take])
            lo += take
        if not parts:
            return self.source[0:0]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)


def open_source(traffic, pool, workdir):
    """``(reader of the pool's frames, close)`` from the store module that
    the traffic's ``store`` names (``portbench/stores/<store>.py``)."""
    return spec.module("stores", traffic["store"]).open_frames(
        traffic, pool, workdir)
