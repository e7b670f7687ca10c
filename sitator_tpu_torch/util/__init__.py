from sitator_tpu_torch.util.errors import (
    SitatorError,
    StaticLatticeError,
    ZeroLandmarkError,
    MultipleOccupancyError,
    InsufficientSitesError,
)
from sitator_tpu_torch.util.progress import get_progress_bar
from sitator_tpu_torch.util.elbow import elbow_index
from sitator_tpu_torch.util.dotprod import DotProdClassifier
from sitator_tpu_torch.util.timing import StageTimer, device_trace
from sitator_tpu_torch.ops.pbc import PBCCalculator

__all__ = [
    "SitatorError", "StaticLatticeError", "ZeroLandmarkError",
    "MultipleOccupancyError", "InsufficientSitesError",
    "get_progress_bar", "elbow_index", "PBCCalculator",
    "DotProdClassifier", "StageTimer", "device_trace",
]
