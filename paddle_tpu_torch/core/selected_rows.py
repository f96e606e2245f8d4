"""SelectedRows: the sparse row-gradient tensor.

Counterpart of paddle_tpu/core/selected_rows.py: `rows` (int32 [n]
indices into a [height, ...] table) and `value` ([n, ...] the rows'
values), with the four functions over it: `merge_selected_rows` (sum
duplicate rows), `get_tensor_from_selected_rows` (scatter-add into a
dense table), `embedding_sparse_grad` (an embedding backward as
SelectedRows) and the row updates `apply_rows_sgd` / `apply_rows_adam`.
Values are torch tensors; the updates replace the parameter's value, as
the JAX ones do.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.tensor import Tensor


def _raw(x):
    return x._value if isinstance(x, Tensor) else torch.as_tensor(x)


class SelectedRows:
    """rows: int [n] indices into a [height, ...] dense table;
    value: [n, ...] the rows' values."""

    def __init__(self, rows, value, height: int):
        self.value = _raw(value)
        self.rows = _raw(rows).to(device=self.value.device,
                                  dtype=torch.int32)
        self.height = int(height)

    @property
    def shape(self):
        return [self.height] + list(self.value.shape[1:])

    def to_dense(self) -> Tensor:
        """get_tensor_from_selected_rows."""
        dense = torch.zeros((self.height,) + tuple(self.value.shape[1:]),
                            dtype=self.value.dtype, device=self.value.device)
        return Tensor._wrap(dense.index_add(0, self.rows.long(), self.value))

    def merge(self) -> "SelectedRows":
        """merge_selected_rows: dedup rows, summing duplicates (sorted)."""
        uniq, inv = torch.unique(self.rows, sorted=True, return_inverse=True)
        merged = torch.zeros((len(uniq),) + tuple(self.value.shape[1:]),
                             dtype=self.value.dtype, device=self.value.device)
        merged = merged.index_add(0, inv, self.value)
        return SelectedRows(uniq, merged, self.height)

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"rows={self.rows.tolist()[:8]}..., "
                f"value.shape={tuple(self.value.shape)})")


def merge_selected_rows(sr: SelectedRows) -> SelectedRows:
    return sr.merge()


def get_tensor_from_selected_rows(sr: SelectedRows) -> Tensor:
    return sr.to_dense()


def embedding_sparse_grad(weight: Tensor, ids, out_grad) -> SelectedRows:
    """The embedding backward as SelectedRows: rows = the looked-up ids,
    values = the output cotangents, merged."""
    idv = _raw(ids)
    g = _raw(out_grad)
    flat_g = g.reshape((idv.numel(),) + tuple(g.shape[idv.dim():]))
    return SelectedRows(idv.reshape(-1), flat_g, weight.shape[0]).merge()


def apply_rows_sgd(param: Tensor, grad: SelectedRows, lr: float) -> None:
    """Sparse SGD row update: only the touched rows move."""
    sr = grad.merge()
    with torch.no_grad():
        new = param._value.detach().index_add(
            0, sr.rows.long(), -lr * sr.value.to(param._value.dtype))
    param._inplace_update(new)


def apply_rows_adam(param: Tensor, grad: SelectedRows, m, v, lr: float,
                    beta1=0.9, beta2=0.999, eps=1e-8, step: int = 1):
    """Sparse Adam row update. m / v: dense accumulators [height, ...]
    (torch tensors); returns the updated (m, v)."""
    sr = grad.merge()
    rows = sr.rows.long()
    with torch.no_grad():
        g = sr.value.to(param._value.dtype)
        m_rows = m[rows] * beta1 + (1 - beta1) * g
        v_rows = v[rows] * beta2 + (1 - beta2) * g * g
        mh = m_rows / (1 - beta1 ** step)
        vh = v_rows / (1 - beta2 ** step)
        upd = lr * mh / (torch.sqrt(vh) + eps)
        new = param._value.detach().index_add(0, rows, -upd)
        m, v = m.clone(), v.clone()
        m[rows] = m_rows
        v[rows] = v_rows
    param._inplace_update(new)
    return m, v
