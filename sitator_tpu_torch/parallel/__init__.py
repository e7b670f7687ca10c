from sitator_tpu_torch.parallel.mesh import pad_frames
from sitator_tpu_torch.parallel.pipeline import (SpmdLandmarkPipeline,
                                                 analysis_step)

__all__ = ["pad_frames", "SpmdLandmarkPipeline", "analysis_step"]
