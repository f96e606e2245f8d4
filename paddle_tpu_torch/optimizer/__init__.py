"""paddle_tpu_torch.optimizer: Adam, AdamW and the global-norm clip of
paddle_tpu.optimizer."""

from paddle_tpu_torch.optimizer.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer.optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "Optimizer"]
