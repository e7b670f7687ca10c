from sitator_tpu_torch.parallel.mesh import (
    FRAME_AXIS,
    frame_mesh,
    frame_sharding,
    pad_frames,
    replicated,
    shard_frames,
    shard_frames_local,
)
from sitator_tpu_torch.parallel.pipeline import (SpmdLandmarkPipeline,
                                                 analysis_step)

__all__ = [
    "FRAME_AXIS", "frame_mesh", "frame_sharding", "pad_frames",
    "replicated", "shard_frames", "shard_frames_local",
    "SpmdLandmarkPipeline", "analysis_step",
]
