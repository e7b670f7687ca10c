from sitator_tpu_torch.dynamics.jump_analysis import JumpAnalysis
from sitator_tpu_torch.dynamics.merge_dynamics import MergeSitesByDynamics
from sitator_tpu_torch.dynamics.filters import (RemoveUnoccupiedSites,
                                                RemoveShortJumps)
from sitator_tpu_torch.network.merging import MergeSitesByDistance

__all__ = ["JumpAnalysis", "MergeSitesByDynamics", "MergeSitesByDistance",
           "RemoveUnoccupiedSites", "RemoveShortJumps"]
