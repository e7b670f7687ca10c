from sitator_tpu_torch.util.errors import (
    SitatorError,
    StaticLatticeError,
    ZeroLandmarkError,
    MultipleOccupancyError,
    InsufficientSitesError,
)
from sitator_tpu_torch.util.progress import get_progress_bar
from sitator_tpu_torch.util.dotprod import DotProdClassifier

__all__ = [
    "SitatorError", "StaticLatticeError", "ZeroLandmarkError",
    "MultipleOccupancyError", "InsufficientSitesError", "get_progress_bar",
    "DotProdClassifier",
]
