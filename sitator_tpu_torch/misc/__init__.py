"""Small trajectory utilities (counterpart of ``sitator_tpu.misc``)."""
from sitator_tpu_torch.misc.navgs import NAvgsPerSite
from sitator_tpu_torch.misc.recenter import RecenterTrajectory

__all__ = ["NAvgsPerSite", "RecenterTrajectory"]
