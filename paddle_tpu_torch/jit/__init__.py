"""paddle_tpu_torch.jit: the eager counterpart of paddle_tpu.jit.TrainStep."""

from paddle_tpu_torch.jit.api import TrainStep

__all__ = ["TrainStep"]
