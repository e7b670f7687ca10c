from sitator_tpu_torch.dynamics.jump_analysis import JumpAnalysis

__all__ = ["JumpAnalysis"]
