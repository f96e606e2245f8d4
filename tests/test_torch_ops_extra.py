"""The op sweep, the round-2 block of ops.yaml (impl_extra): the linalg
family, creation, bitwise, unary extras, losses, manipulation and the
reductions / checks against the JAX package's `_C_ops` on the same seeded
numpy inputs (the linalg decompositions through invariants where the
factors are unique only up to signs: SVD and eigh reconstructions,
sorted eigenvalues); the random ops by dtype, shape, determinism under
`seed` and moments against JAX's draws; the 51 names still to port raise
naming ROADMAP.md item 12; and the pin that the case table covers
exactly the 332 ported names."""

import numpy as np
import pytest
import yaml

import paddle_tpu
import paddle_tpu_torch
import _torch_op_cases as oc
from _torch_op_sweep import check, cpu_sweep

ROUND2 = [c for c in oc.CASES[oc.FIRST_BLOCK_CASES:] if not c.rng]
RNG = [c for c in oc.CASES if c.rng]
JAX_TABLE = [e["name"] for e in yaml.safe_load(open(
    paddle_tpu.__path__[0] + "/ops/ops.yaml"))["ops"]]


@pytest.fixture(scope="module", autouse=True)
def _sweep():
    with cpu_sweep():
        yield


@pytest.mark.parametrize("case", ROUND2, ids=[c.id for c in ROUND2])
def test_op_matches_jax(case):
    check(case)


@pytest.mark.parametrize("case", RNG, ids=[c.id for c in RNG])
def test_random_op_follows_jax(case):
    """Same dtype and shape as JAX's draw, moments within six standard
    errors (mean) and 10 % (std) of it, and the same draw again after the
    same seed."""
    paddle_tpu.seed(11)
    ref = oc.draw(paddle_tpu, case)
    paddle_tpu_torch.seed(11)
    got = oc.draw(paddle_tpu_torch, case)
    assert oc.moments_agree(ref, got), (case.id, ref[:2], got[:2],
                                        ref[2].mean(), got[2].mean(),
                                        ref[2].std(), got[2].std())
    paddle_tpu_torch.seed(11)
    again = oc.draw(paddle_tpu_torch, case)
    np.testing.assert_array_equal(again[2], got[2])
    if case.op == "randperm":
        np.testing.assert_array_equal(np.sort(got[2]), np.arange(1000))


@pytest.mark.parametrize("name", oc.DEFERRED)
def test_deferred_op_raises_naming_item_12(name):
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md 'Still to port' item 12"):
        getattr(paddle_tpu_torch._C_ops, name)(paddle_tpu_torch.zeros([2]))
    assert not hasattr(paddle_tpu_torch.Tensor, name)


def test_the_cases_cover_exactly_the_ported_ops():
    """The first block (223 ops) and the first 109 of the round-2 block
    are ported and each has a case; the last 51 are the deferred names."""
    assert len(JAX_TABLE) == 383
    ported, deferred = JAX_TABLE[:332], JAX_TABLE[332:]
    assert tuple(deferred) == oc.DEFERRED
    assert {c.op for c in oc.CASES} == set(ported)
    assert len(oc.CASES[:oc.FIRST_BLOCK_CASES]) and {
        c.op for c in oc.CASES[:oc.FIRST_BLOCK_CASES]} == set(JAX_TABLE[:223])
    ids = [c.id for c in oc.CASES]
    assert len(ids) == len(set(ids))
