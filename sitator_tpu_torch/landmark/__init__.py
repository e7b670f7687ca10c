from sitator_tpu_torch.landmark.analysis import LandmarkAnalysis
from sitator_tpu_torch.landmark.streaming import StreamingLandmarkAnalysis
from sitator_tpu_torch.landmark.calibrate import suggest_cutoff
from sitator_tpu_torch.util.errors import (
    StaticLatticeError,
    ZeroLandmarkError,
    MultipleOccupancyError,
)

__all__ = ["LandmarkAnalysis", "StreamingLandmarkAnalysis",
           "suggest_cutoff",
           "StaticLatticeError", "ZeroLandmarkError",
           "MultipleOccupancyError"]
