"""`SpecLayout`: the canonical placements of a tensor-parallel decoder.

Counterpart of paddle_tpu/parallel/compat.py::SpecLayout (and only of it:
the parallelize plans are ROADMAP.md item 13). A placement is a
`PartitionSpec`, a tuple of axis names or None per tensor dimension that
equals JAX's as a tuple. The collectives are the port's, over the list
of per-shard tensors (`parallel.mesh`, `quantization.qcomm`).
"""

from __future__ import annotations

from dataclasses import dataclass


class PartitionSpec(tuple):
    """``PartitionSpec(None, "model")``: the mesh axis (or None) of each
    dimension; equal to JAX's PartitionSpec of the same entries."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _unknown(comm_dtype):
    return ValueError(f"comm_dtype={comm_dtype!r}; expected 'fp32' or "
                      "'int8'")


@dataclass(frozen=True)
class SpecLayout:
    """Placements over a ``(data, model)`` serving mesh: embeddings
    vocab-sharded over ``model``; column-parallel [in, out] weights (QKV,
    MLP up / gate, the logits head) with OUT sharded; row-parallel ones
    (attention out-proj, MLP down-proj) with IN sharded, their partial
    products reduced by `row_parallel_reduce()`; the paged K/V pools on
    the kv-head axis; norms, biases and host operands replicated.
    ``comm_dtype`` is the wire precision of the two collectives: "fp32"
    (`parallel.mesh.psum` / `all_gather`) or "int8"
    (`quantization.qcomm.quantized_psum` / `quantized_allgather`)."""

    data_axis: str = "data"
    model_axis: str = "model"
    comm_dtype: str = "fp32"

    def replicated(self) -> PartitionSpec:
        return P()

    def row_parallel_reduce(self):
        """fn(per-shard partial sums) -> per-shard allreduced sums."""
        if self.comm_dtype == "fp32":
            from paddle_tpu_torch.parallel.mesh import psum
            return psum
        if self.comm_dtype == "int8":
            from paddle_tpu_torch.quantization.qcomm import quantized_psum
            return quantized_psum
        raise _unknown(self.comm_dtype)

    def column_parallel_gather(self):
        """fn(per-shard last-axis slices) -> per-shard full-width values,
        tiled in shard order."""
        if self.comm_dtype == "fp32":
            from paddle_tpu_torch.parallel.mesh import all_gather
            return all_gather
        if self.comm_dtype == "int8":
            from paddle_tpu_torch.quantization.qcomm import \
                quantized_allgather
            return quantized_allgather
        raise _unknown(self.comm_dtype)

    def embeddings(self) -> PartitionSpec:
        return P(self.model_axis, None)

    def column_parallel(self) -> PartitionSpec:
        return P(None, self.model_axis)

    def row_parallel(self) -> PartitionSpec:
        return P(self.model_axis, None)

    def bias_column(self) -> PartitionSpec:
        return P(self.model_axis)

    def heads(self) -> PartitionSpec:
        """[B, T, heads, d] activations: heads ride the model axis."""
        return P(None, None, self.model_axis, None)

    def kv_pool(self) -> PartitionSpec:
        """[blocks, block, n_kv, d]: kv heads ride the model axis."""
        return P(None, None, self.model_axis, None)
