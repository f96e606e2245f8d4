"""paddle_tpu_torch.optimizer: Adam, AdamW, the global-norm clip and the
learning-rate schedulers (`lr`) of paddle_tpu.optimizer."""

from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer.optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "ClipGradByGlobalNorm", "Optimizer", "lr"]
