"""The port's kernels: hand-written CUDA C++ for Hopper (csrc/), each with
a wrapper, a plain PyTorch version and launch counts (`COUNTS`):

  ragged_paged_attention  K1, prefill chunks and GQA decode
  paged_attention         K2, single-token MHA decode, + best_paged_impl
  _build                  nvcc build at first use, ctypes loader

Import the functions from their modules; the package re-exports nothing,
so ``paddle_tpu_torch.ops.ragged_paged_attention`` names the module.
"""
