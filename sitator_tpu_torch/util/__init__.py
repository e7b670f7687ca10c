from sitator_tpu_torch.util.errors import (
    SitatorError,
    StaticLatticeError,
    ZeroLandmarkError,
    MultipleOccupancyError,
    InsufficientSitesError,
)
from sitator_tpu_torch.util.progress import get_progress_bar

__all__ = [
    "SitatorError", "StaticLatticeError", "ZeroLandmarkError",
    "MultipleOccupancyError", "InsufficientSitesError", "get_progress_bar",
]
