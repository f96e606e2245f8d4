"""Gradient clipping (the global-norm clip of paddle_tpu/optimizer/clip.py).

Paddle's scale is min(clip_norm / max(gn, 1e-12), 1), which is not
torch.nn.utils.clip_grad_norm_'s clip_norm / (gn + 1e-6). The norm is
summed in fp32 whatever the gradients' dtype (bf16 under O2), as the JAX
clip upcasts each one, and stays on the device: clipping never waits for
the host.
"""

from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm=1.0):
        self.clip_norm = float(clip_norm)

    def _scale(self, grads):
        """min(clip_norm / max(gn, 1e-12), 1) as a 0-d device tensor, gn
        the fp32 norm of all grads, summed grad by grad in order."""
        total = None
        for g in grads:
            sq = g.float().square().sum()
            total = sq if total is None else total + sq
        gn = torch.sqrt(total)
        return torch.clamp_max(self.clip_norm / torch.clamp_min(gn, 1e-12),
                               1.0)

    def clip_(self, grads) -> None:
        """Clip a list of grads in place (no second copy of the
        gradients): the JAX package's `functional`, on torch tensors."""
        if grads:
            scale = self._scale(grads)
            for g in grads:
                if g.dtype == torch.float32:
                    g.mul_(scale)
                else:
                    # a bf16 gradient (O2): the product in fp32, rounded
                    # once, as the JAX (g * scale).astype(g.dtype)
                    g.copy_(g.float() * scale)
