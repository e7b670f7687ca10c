"""sitator_tpu_torch — the PyTorch/CUDA port of sitator_tpu's main path.

Landmark vectors → normalisation → cosine assignment to fitted site centres
→ jump statistics, in memory (``LandmarkAnalysis``, ``SpmdLandmarkPipeline``)
and out of core (``StreamingLandmarkAnalysis``), with the four TPU kernels of
the JAX package rewritten by hand in CUDA C++ for Hopper (``csrc/``, built
with nvcc at first use).  The JAX package ``sitator_tpu`` is the unchanged
reference.  The port keeps its own copy of the NumPy data model and imports
nothing of ``sitator_tpu``; its engines are duck-typed and take either
package's objects.

Engines take an explicit ``device`` (default ``"cuda"``); on CPU tensors
every kernel wrapper runs its plain PyTorch version.
"""
from sitator_tpu_torch.core import SiteNetwork, SiteTrajectory, Structure
from sitator_tpu_torch.dynamics import JumpAnalysis
from sitator_tpu_torch.landmark import (LandmarkAnalysis,
                                        StreamingLandmarkAnalysis)
from sitator_tpu_torch.parallel import SpmdLandmarkPipeline

__all__ = ["Structure", "SiteNetwork", "SiteTrajectory", "LandmarkAnalysis",
           "StreamingLandmarkAnalysis", "JumpAnalysis", "SpmdLandmarkPipeline"]
