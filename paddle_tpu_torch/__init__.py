"""PyTorch/CUDA port of paddle_tpu's serving and training paths.

The JAX package ``paddle_tpu`` is the reference; this package serves and
trains the same Llama models with PyTorch on an NVIDIA H100, through
hand-written CUDA kernels: the two paged-attention kernels of the serving
path (``ops.ragged_paged_attention``, ``ops.paged_attention``) and the
flash-attention forward and backward kernels of the training path
(``ops.flash_attention``, under ``models.Llama.forward`` and
``jit.TrainStep``). It imports torch and numpy only, never jax and never
``paddle_tpu``.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``;
on CPU tensors each kernel wrapper runs its plain PyTorch version.
"""

from paddle_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
