"""What the port's store readers (``io/zarr_store.py``, ``io/h5_store.py``)
share: the pool of threads their reads decode on, and the probe of the
libraries their codecs load."""
from __future__ import annotations

import importlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor

N_THREADS = min(8, os.cpu_count() or 1)

_pool = None
_pool_lock = threading.Lock()


def _io_pool():
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(N_THREADS,
                                       thread_name_prefix="store-io")
        return _pool


def pool_map(fn, *items):
    """``fn`` over the items, on the I/O pool where there are several."""
    if len(items[0]) < 2:
        return list(map(fn, *items))
    return list(_io_pool().map(fn, *items))


def native_lib():
    """The native library (``io/native/``, built with g++ at first use), or
    None where it cannot be built."""
    from sitator_tpu_torch.io import native
    return native.get_lib()


def library_usable(name):
    """Whether the library ``name`` is usable here: ``'zarrcodec'`` (the
    native codec), ``'libz.so.1'``, ``'libzstd.so.1'`` (loaded by it), or
    Python's ``'bz2'`` or ``'lzma'`` module."""
    if name in ("bz2", "lzma"):
        try:
            importlib.import_module(name)
        except ImportError:
            return False
        return True
    lib = native_lib()
    if lib is None or name == "zarrcodec":
        return lib is not None
    return bool(lib.zc_libraries() & {"libz.so.1": 1, "libzstd.so.1": 2}[name])
