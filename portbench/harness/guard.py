"""What the benchmark's process must never load: the JAX stack and the JAX
package, compared by the top-level name of each module (the part before
the first dot), so that ``sitator_tpu_torch`` is not ``sitator_tpu``."""
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "sitator_tpu")


def loaded(modules=None):
    """The forbidden top-level names present in ``modules`` (default
    ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(t for t in FORBIDDEN if t in tops)
