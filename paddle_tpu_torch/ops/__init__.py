"""The port's kernels: hand-written CUDA C++ for Hopper (csrc/), each with
a wrapper, a plain PyTorch version and launch counts (`COUNTS`):

  ragged_paged_attention  K1, prefill chunks and GQA decode
  paged_attention         K2, single-token MHA decode, + best_paged_impl
  flash_attention         K3a forward, K3b-dq and K3b-dkv backward, tied
                          by a torch.autograd.Function (training)
  _build                  nvcc build at first use, ctypes loader

and `impl`, the plain ops of the training path (SDPA dispatch, RMSNorm,
RoPE, SwiGLU, embedding, cross-entropy).

Import the functions from their modules; the package re-exports nothing,
so ``paddle_tpu_torch.ops.ragged_paged_attention`` names the module.
"""
