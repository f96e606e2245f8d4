"""The port's CUDA kernels and its serving path on an NVIDIA card.

Every test here needs the card and skips without one. Run them on the
card, from the root of a checkout, without the JAX test configuration
(this file imports neither jax nor the JAX package):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors at max |kernel - plain| <= 1e-4 (fp32, summed in another order),
with rows past q_len and dead slots exactly 0; a small engine on the card
must equal its own naive_generate token for token, through the kernels.
"""

import numpy as np
import pytest
import torch

import paddle_tpu_torch.ops.paged_attention as k2
import paddle_tpu_torch.ops.ragged_paged_attention as k1
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.serving import (
    LlamaRunner, SamplingParams, ServingEngine, naive_generate,
)

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _operands(gen, B, T, n_kv, n_rep, d, ps, pages):
    nb = 1 + B * pages
    kp = torch.randn(nb, ps, n_kv, d, device="cuda", generator=gen)
    vp = torch.randn(nb, ps, n_kv, d, device="cuda", generator=gen)
    perm = torch.randperm(nb - 1, device="cuda", generator=gen) + 1
    table = perm.reshape(B, pages).int()
    q = torch.randn(B, T, n_kv * n_rep, d, device="cuda", generator=gen)
    return q, kp, vp, table


@pytest.mark.parametrize("d", [8, 64, 128, 136, 256])
@pytest.mark.parametrize("n_kv,n_rep,ps", [(2, 1, 16), (2, 4, 8), (1, 3, 1)])
def test_ragged_kernel_matches_plain(gen, d, n_kv, n_rep, ps):
    T = 16
    starts, qlens = [0, 5, 30, 3], [16, 1, 9, 0]
    pages = (T + max(starts)) // ps + 2
    q, kp, vp, table = _operands(gen, 4, T, n_kv, n_rep, d, ps, pages)
    table[3] = 0                                   # dead slot: all scratch
    st = torch.tensor(starts, dtype=torch.int32, device="cuda")
    ql = torch.tensor(qlens, dtype=torch.int32, device="cuda")
    k1.COUNTS.reset()
    out = k1.ragged_paged_attention(q, kp, vp, table, st, ql)
    assert k1.COUNTS.kernel_launches == 1 and k1.COUNTS.plain_launches == 0
    ref = k1.ragged_reference(q, kp, vp, table, st, ql)
    assert (out - ref).abs().max().item() <= TOL
    for b, n in enumerate(qlens):
        assert bool((out[b, n:] == 0).all()), f"sequence {b}: rows >= {n}"


@pytest.mark.parametrize("d", [8, 64, 128, 256])
@pytest.mark.parametrize("ps", [1, 16])
def test_paged_decode_kernel_matches_plain(gen, d, ps):
    b, h, pages = 6, 4, 40 // ps + 1
    q, kp, vp, table = _operands(gen, b, 1, h, 1, d, ps, pages)
    table[5] = 0                                   # dead slot: all scratch
    pos = torch.tensor([0, ps - 1, ps, 17, 39, 0], dtype=torch.int32,
                       device="cuda")
    k2.COUNTS.reset()
    out = k2.paged_decode_attention(q[:, 0], kp, vp, table, pos)
    assert k2.COUNTS.kernel_launches == 1 and k2.COUNTS.plain_launches == 0
    ref = k2.paged_decode_reference(q[:, 0], kp, vp, table, pos)
    assert torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= TOL


def test_kernels_refuse_what_they_cannot_tile(gen):
    q, kp, vp, table = _operands(gen, 1, 8, 1, 1, 264, 4, 2)
    z = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        k1.ragged_paged_attention(q, kp, vp, table, z, z + 1)
    with pytest.raises(TypeError, match="fp32"):
        k2.paged_decode_attention(q[:, 0].double(), kp.double(),
                                  vp.double(), table, z)


@pytest.mark.parametrize("n_kv", [4, 2], ids=["mha", "gqa"])
def test_engine_on_the_card_matches_naive_through_the_kernels(gen, n_kv):
    cfg = LlamaConfig(vocab_size=211, hidden_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=n_kv, max_seq_len=128)
    runner = LlamaRunner(Llama(cfg, device="cuda", seed=0), block_size=16)
    eng = ServingEngine(runner, num_blocks=24, max_batch_size=4,
                        max_prefill_tokens_per_step=32, audit=True)
    rng = np.random.default_rng(0)
    work = [(rng.integers(1, 211, int(rng.integers(5, 70))).tolist(),
             int(rng.integers(2, 12))) for _ in range(8)]
    for counts in (k1.COUNTS, k2.COUNTS):
        counts.reset()
    ids = [eng.add_request(p, SamplingParams(max_tokens=n)) for p, n in work]
    outs = eng.run()
    assert k1.COUNTS.kernel_launches > 0
    assert (k2.COUNTS.kernel_launches > 0) == (n_kv == cfg.num_heads)
    assert k1.COUNTS.plain_launches == k2.COUNTS.plain_launches == 0
    for rid, (p, n) in zip(ids, work):
        assert outs[rid].output_tokens == naive_generate(
            runner, p, SamplingParams(max_tokens=n))
    assert eng.pool.allocator.check_no_leaks()
