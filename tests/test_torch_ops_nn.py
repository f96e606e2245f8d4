"""The op sweep, activations, the nn core ops, conv and pool,
losses and the attention ops (the last sections of the first block of
ops.yaml; the attention ops run the flash kernels' plain versions): each case of
`_torch_op_cases` gives the same seeded numpy inputs to the JAX
package's `_C_ops` and the port's on CPU Tensors; values (fp32 within
rtol 1e-5, atol 1e-6 unless the case states otherwise; integer and bool
outputs exact), dtype names, shapes and, for differentiable ops, the
inputs' gradients of the same loss agree."""

import pytest

import _torch_op_cases as oc
from _torch_op_sweep import check, cpu_sweep

CASES = (oc.cases_between("relu", "cosine_similarity")
         + oc.cases_between("scaled_dot_product_attention",
                            "rotary_embedding"))


@pytest.fixture(scope="module", autouse=True)
def _sweep():
    with cpu_sweep():
        yield


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_op_matches_jax(case):
    check(case)
