"""The port's kernels: hand-written CUDA C++ for Hopper (csrc/), each with
a wrapper, a plain PyTorch version and launch counts (`COUNTS`):

  ragged_paged_attention  K1, prefill chunks and GQA decode
  paged_attention         K2, single-token MHA decode, + best_paged_impl
  flash_attention         K3a forward, K3b-dq and K3b-dkv backward, tied
                          by a torch.autograd.Function (training)
  _build                  nvcc build at first use, ctypes loader

and the op surface: `registry` (the table of `ops.yaml`, `dispatch`,
`C_OPS`), `impl` and `impl_extra` (the ops themselves; the attention ops
over the K3 kernels).

The package re-exports the registry's `C_OPS`, `OPS` and `dispatch`, as
the JAX package's does; import the kernels' functions from their modules
(``paddle_tpu_torch.ops.ragged_paged_attention`` names the module).
"""

from paddle_tpu_torch.ops.registry import C_OPS, OPS, dispatch

__all__ = ["C_OPS", "OPS", "dispatch"]
