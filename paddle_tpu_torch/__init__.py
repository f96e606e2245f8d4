"""PyTorch/CUDA port of paddle_tpu's serving path.

The JAX package ``paddle_tpu`` is the reference; this package serves the
same Llama models with PyTorch on an NVIDIA H100, through hand-written
CUDA kernels for the two paged-attention kernels of the serving path
(``ops.ragged_paged_attention``, ``ops.paged_attention``). It imports
torch and numpy only, never jax and never ``paddle_tpu``.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``;
on CPU tensors each kernel wrapper runs its plain PyTorch version.
"""

from paddle_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
