"""tqdm auto-selection (copy of ``sitator_tpu.util.progress``)."""
from __future__ import annotations


def get_progress_bar(iterable=None, enabled=True, **kwargs):
    """Return a tqdm iterator/bar (notebook-aware) or a no-op passthrough."""
    if not enabled:
        return iterable if iterable is not None else _NullBar()
    try:
        from tqdm.auto import tqdm
        return tqdm(iterable, **kwargs)
    except ImportError:  # pragma: no cover - tqdm is in the base env
        return iterable if iterable is not None else _NullBar()


class _NullBar:
    def update(self, n=1):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
