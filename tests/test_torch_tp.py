"""Tensor-parallel serving in the port, against the JAX package, on the CPU.

Ports every test of tests/test_serving_tp.py and the TP cases of
tests/test_serving_qcomm.py, test_serving_weight_quant.py,
test_serving_quant.py, test_serving_offload.py and test_serving_router.py
onto the port, whose mesh is `serving_mesh(1, tp, devices=["cpu"] * tp)`:
several shards on one device, each with its own weight views and pool
slices, the collectives explicit reductions over the shards' tensors.
The sharded engines are held against the port's single-device engine and
their own `naive_generate`; across the frameworks, on the same numpy
weights, the port's tp = 2 engine gives the JAX tp = 2 engine's greedy
tokens (fp32, int8 comm, an int8 pool), its fp32 prefill and decode
logits lie within 1e-4 of max|logit| of the JAX sharded runner's (int8
comm within `QCOMM_LOGIT_TOL`), and `per_shard_memory_bytes` and the six
`tp_*` metrics equal the JAX engine's for the same traffic, exactly
(host-side accounting). The JAX references are built once per module.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.parallel.mesh import serving_mesh as jax_serving_mesh
from paddle_tpu.serving import LlamaRunner as JaxLlamaRunner
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving import SpecLayout as JaxSpecLayout
from paddle_tpu_torch.inference import (
    create_serving_engine, create_serving_router, restore_serving_engine,
)
from paddle_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig
from paddle_tpu_torch.parallel import Mesh
from paddle_tpu_torch.serving import (
    FaultInjector, GPTRunner, InvariantViolation, KVCachePool, LlamaRunner,
    SamplingParams, ServingEngine, SpecLayout, audit_engine, audit_router,
    create_engine, naive_generate, paged_attend, replica_submeshes,
    serving_mesh,
)
from paddle_tpu_torch.serving.model_runner import SCALE_SUFFIX
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

VOCAB, BLOCK, MAXLEN = 96, 8, 64
SIZES = dict(vocab_size=VOCAB, hidden_size=64, num_layers=2, num_heads=8,
             num_kv_heads=4, max_seq_len=MAXLEN)
# int8-comm logits of the two frameworks, as a share of max|logit|: the
# port's int8-comm runner reads at most 1.1e-6 from the JAX int8-comm
# runner's (the primitives are bit-equal, only fp32 rounding of the
# partials differs), its fp32-comm runner at least 4.1e-3 (the int8
# reduction's own error), over four prompts' prefill and three decode
# steps each: the tolerance lies between, so it holds the int8 path and
# fails a runner that reduces in fp32
QCOMM_LOGIT_TOL = 1e-3


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


def cpu_mesh(tp, data=1, **kw):
    return serving_mesh(data, tp, devices=["cpu"] * (data * tp), **kw)


@pytest.fixture(scope="module")
def pair():
    """(JAX Llama, the port's Llama holding its weights): GQA, 8 q-heads
    over 4 kv-heads, so tp in {1, 2, 4} splits cleanly; vocab 96 divides,
    so the embedding and the head shard."""
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(dropout=0.0, **SIZES))
    jm.eval()
    pm = Llama(LlamaConfig(**SIZES), device="cpu", seed=1)
    load_params(pm, {k: np.asarray(v) for k, v in
                     functionalize(jm).param_values().items()})
    return jm, pm


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def runner(model, tp=1, comm_dtype="fp32", **kw):
    r = LlamaRunner(model, BLOCK, MAXLEN, **kw)
    if tp > 1:
        r.shard(cpu_mesh(tp), comm_dtype=comm_dtype)
    return r


def workload(rng, n=5):
    """Greedy + seeded temperature + shared prefixes + a long prompt
    (chunked under the budget): every sharded code path in one batch."""
    work = []
    header = [7, 8, 9, 10]
    for i in range(n):
        plen = int(rng.integers(4, 14)) if i != 2 else 20
        p = list(map(int, rng.integers(1, VOCAB, plen)))
        if i % 2:
            p[:4] = header
        sp = SamplingParams(max_tokens=int(rng.integers(4, 8)),
                            temperature=(0.8 if i == 4 else 0.0), seed=11)
        work.append((f"r{i}", p, sp))
    return work


def run_engine(r, work, **kw):
    kw.setdefault("num_blocks", 40)
    kw.setdefault("max_batch_size", 3)
    kw.setdefault("max_model_len", MAXLEN)
    kw.setdefault("enable_prefix_cache", True)
    kw.setdefault("max_prefill_tokens_per_step", 6)
    kw.setdefault("decode_horizon", 4)
    eng = ServingEngine(r, **kw)
    assert eng.audit, "TP tests run under the invariant auditor"
    for rid, p, sp in work:
        eng.add_request(p, sp, request_id=rid)
    outs = eng.run()
    eng.release_prefix_cache()
    assert eng.pool.allocator.check_no_leaks()
    return eng, {rid: outs[rid].output_tokens for rid, _, _ in work}


def greedy_prompts(seed=3, n=4):
    r = np.random.default_rng(seed)
    return [list(map(int, r.integers(1, VOCAB, int(r.integers(6, 20)))))
            for _ in range(n)]


def serve_greedy(r, prompts, max_tokens=8, **kw):
    eng = ServingEngine(r, num_blocks=48, max_batch_size=4,
                        max_model_len=MAXLEN, **kw)
    rids = [eng.add_request(p, SamplingParams(max_tokens=max_tokens))
            for p in prompts]
    outs = eng.run()
    assert eng.pool.allocator.check_no_leaks()
    return [outs[i].output_tokens for i in rids], eng


# ------------------------------------------------------------ the mesh


def test_kv_heads_not_divisible_is_loud():
    """The GQA rule: tp must divide n_kv_heads (and n_heads)."""
    m = Llama(LlamaConfig(vocab_size=31, hidden_size=48, num_layers=1,
                          num_heads=6, num_kv_heads=3, max_seq_len=32),
              device="cpu")
    r = LlamaRunner(m, BLOCK, 32)
    with pytest.raises(ValueError, match="n_kv_heads=3.*kv-head"):
        r.shard(cpu_mesh(2))
    with pytest.raises(ValueError, match="n_kv_heads"):
        r.shard(cpu_mesh(4))
    with pytest.raises(ValueError, match="kv-heads"):
        KVCachePool(1, 4, 4, 3, 8, mesh=cpu_mesh(2), device="cpu")


def test_mesh_axis_and_device_validation():
    with pytest.raises(ValueError, match="needs 4 devices, have 2"):
        serving_mesh(data=2, model=2, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="must be >= 1"):
        serving_mesh(data=0, model=2, devices=["cpu"] * 2)
    # the default device list is the cards': none here, so tp = 2 needs
    # devices as it needs chips in JAX on one chip
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="needs"):
            serving_mesh(model=2)
    with pytest.raises(ValueError, match="one device type"):
        Mesh(np.array(["cpu", "cuda:0"], dtype=object).reshape(1, 2),
             ("data", "model"))
    with pytest.raises(NotImplementedError, match="item 26"):
        serving_mesh(1, 2, devices=["cuda:0", "cuda:1"])
    one_card = serving_mesh(1, 2, devices=[torch.device("cuda", 0)] * 2)
    assert one_card.axis_devices("model") == [torch.device("cuda", 0)] * 2
    assert serving_mesh(1, 2, devices=["cuda"] * 2) == one_card
    m = Llama(LlamaConfig(vocab_size=31, hidden_size=32, num_layers=1,
                          num_heads=2, num_kv_heads=2, max_seq_len=32),
              device="cpu")
    r = LlamaRunner(m, BLOCK, 32)
    mesh = cpu_mesh(2, data_axis="dp", model_axis="tp")
    with pytest.raises(ValueError, match="lack"):
        r.shard(mesh)
    r.shard(mesh, data_axis="dp", model_axis="tp")
    assert r.tp_size == 2 and r.model_axis == "tp" and r.is_sharded
    assert dict(mesh.shape) == {"dp": 1, "tp": 2}


def test_spec_layout_matches_colwise_rowwise():
    lay, ref = SpecLayout(model_axis="tp"), JaxSpecLayout(model_axis="tp")
    assert lay.column_parallel() == (None, "tp") == ref.column_parallel()
    assert lay.row_parallel() == ("tp", None) == ref.row_parallel()
    assert lay.bias_column() == ("tp",) == ref.bias_column()
    assert lay.embeddings() == ("tp", None) == ref.embeddings()
    assert lay.kv_pool() == (None, None, "tp", None) == ref.kv_pool()
    assert lay.heads() == ref.heads()
    assert lay.replicated() == () == ref.replicated()


# ------------------------------------------------- token-exact tp sweep


def test_llama_token_exact_tp_sweep(model):
    """tp in {1, 2, 4} engines equal the single-device engine and its
    naive oracle with greedy + seeded temperature + prefix cache +
    chunked prefill + decode_horizon > 1; each shard holds exactly 1/tp
    of the pool bytes, in tensors of n_kv/tp heads, and reads 1/tp of
    the attention bytes."""
    work = workload(np.random.default_rng(7))
    base = runner(model)
    eng1, ref = run_engine(base, work)
    base_bytes = base.attn_kv_bytes_read
    assert base_bytes > 0
    for rid, p, sp in work:
        assert ref[rid] == naive_generate(base, p, sp, max_model_len=MAXLEN)
    for tp in (1, 2, 4):
        r = runner(model, tp)
        eng, got = run_engine(r, work)
        assert got == ref, f"tp={tp} diverged from the single-device engine"
        if tp == 1:
            assert not r.is_sharded
            continue
        assert r.is_sharded and r.tp_size == tp
        pool = eng.pool
        assert pool.per_shard_memory_bytes() == \
            eng1.pool.memory_bytes() // tp
        assert len(pool.shards) == tp
        for shard in pool.shards:
            assert {tuple(a.shape) for layer in shard for a in layer} == {
                (pool.num_blocks, BLOCK, SIZES["num_kv_heads"] // tp,
                 pool.head_dim)}
            assert all(a.is_contiguous() for layer in shard for a in layer)
        assert r.attn_kv_bytes_read == pytest.approx(base_bytes / tp)
        assert eng.metrics.snapshot()["attn_kv_bytes_read"] == \
            pytest.approx(base_bytes / tp)
        for rid, p, sp in work:       # after the counters: naive adds
            assert got[rid] == naive_generate(r, p, sp,
                                              max_model_len=MAXLEN), rid


def test_gpt_token_exact_and_vocab_sharded():
    """GPT at tp = 2 on a data = 2 x model = 2 mesh (state replicated over
    data): token-exact, the vocab matrices really sharded (96 divides),
    the fused QKV replicated, fc1 and its bias column-parallel."""
    cfg = GPTConfig(vocab_size=96, hidden_size=64, num_layers=2,
                    num_heads=4, max_seq_len=MAXLEN)
    gm = GPT(cfg, device="cpu")
    work = workload(np.random.default_rng(3), n=4)
    base = GPTRunner(gm, BLOCK, MAXLEN)
    _, ref = run_engine(base, work)
    tp = GPTRunner(gm, BLOCK, MAXLEN).shard(cpu_mesh(2, data=2))
    assert tp._specs["wte.weight"] == ("model", None)
    assert tp._specs["blocks.0.mlp.fc1.bias"] == ("model",)
    assert tp._specs["blocks.0.attn.qkv.weight"] == ()
    assert tp._shard_params[1]["wte.weight"].shape == (48, 64)
    # the JAX rule: every param whose spec is the row placement, the
    # vocab-sharded table too (its lookup's psum counts in tp_comm_bytes)
    assert tp._row_names == frozenset(
        [f"blocks.{i}.{n}" for i in range(2)
         for n in ("attn.out.weight", "mlp.fc2.weight")] + ["wte.weight"])
    _, got = run_engine(tp, work)
    assert got == ref


def test_weights_shard_as_views(model):
    """Each shard's weights are views of the runner's tensors (same
    storage, no copy) or the tensors themselves; a non-dividing vocab
    stays replicated with a warning, and its matmul runs once."""
    r = runner(model, 2)
    for name, v in r.params.items():
        for sp in r._shard_params:
            assert sp[name].untyped_storage().data_ptr() == \
                v.untyped_storage().data_ptr(), name
    assert r._shard_params[1]["layers.0.self_attn.q_proj.weight"].shape \
        == (64, 32)
    assert r._shard_params[1]["layers.0.mlp.down_proj.weight"].shape[0] \
        == r.params["layers.0.mlp.down_proj.weight"].shape[0] // 2
    odd = Llama(LlamaConfig(**dict(SIZES, vocab_size=97)), device="cpu")
    ro = LlamaRunner(odd, BLOCK, MAXLEN).shard(cpu_mesh(2))
    assert ro._specs["embed_tokens.weight"] == ()
    assert ro._gather_names == frozenset()
    prompts = greedy_prompts()
    got, _ = serve_greedy(ro, prompts, max_tokens=5)
    want, _ = serve_greedy(LlamaRunner(odd, BLOCK, MAXLEN), prompts,
                           max_tokens=5)
    assert got == want


# ----------------------------------------------- capacity + invariants


def test_auditor_catches_unsharded_pool(model):
    """A full-head tensor smuggled into a shard's place is an
    InvariantViolation naming the per-shard shapes."""
    eng = ServingEngine(runner(model, 2), num_blocks=20, max_batch_size=2,
                        max_model_len=MAXLEN)
    audit_engine(eng)
    k, v = eng.pool.shards[0][0]
    eng.pool.shards[0][0] = (torch.zeros(k.shape[:2] + (SIZES[
        "num_kv_heads"], k.shape[3])), v)
    with pytest.raises(InvariantViolation, match="per-shard"):
        audit_engine(eng)


def test_auditor_catches_a_sharded_scale_pool_of_the_wrong_dtype(model):
    """On an int8 pool at tp = 2, a shard's scale pool of the right
    per-shard shape but not float32 is an InvariantViolation."""
    eng = ServingEngine(runner(model, 2, kv_dtype="int8"), num_blocks=20,
                        max_batch_size=2, max_model_len=MAXLEN)
    audit_engine(eng)
    k, v, ks, vs = eng.pool.shards[1][0]
    eng.pool.shards[1][0] = (k, v, ks.half(), vs)
    with pytest.raises(InvariantViolation, match="shard 1 layer 0 k-scale "
                                                 "pool dtype"):
        audit_engine(eng)


def test_sharded_pool_pages_keep_the_logical_layout(model):
    """Every byte that leaves a sharded pool is in the logical layout:
    pages written through `write_pages` come back from `gather_pages`
    bit-equal to an unsharded pool's, and the host tier's buffers and
    `page_layout` are the unsharded pool's."""
    rng = np.random.default_rng(0)
    for kv_dtype in ("fp32", "int8", "fp8", "mixed"):
        one = KVCachePool(2, 6, 4, 4, 8, kv_dtype=kv_dtype, device="cpu")
        two = KVCachePool(2, 6, 4, 4, 8, mesh=cpu_mesh(2), kv_dtype=kv_dtype,
                          device="cpu")
        assert two.page_layout() == one.page_layout()
        data = []
        for shape, dt in one.page_layout()[0]:
            raw = rng.integers(0, 255, (3,) + shape + (dt.itemsize,),
                               dtype=np.uint8)
            t = torch.from_numpy(raw).view(dt).reshape((3,) + shape)
            if dt == torch.bool:
                t = torch.from_numpy(raw[..., 0] % 2 == 1)
            elif dt.is_floating_point:
                t = torch.from_numpy(rng.standard_normal(
                    (3,) + shape).astype(np.float32)).to(dt)
            data.append(t)
        for pool in (one, two):
            pool.write_pages([1, 3, 4], [tuple(data)] * 2)
            pool.copy_page(3, 5)
        for a, b in zip(one.gather_pages([1, 3, 4, 5]),
                        two.gather_pages([1, 3, 4, 5])):
            for x, y in zip(a, b):
                assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
        assert two.shards[1][0][0].shape[2] == 2
        assert two.per_shard_memory_bytes() == one.memory_bytes() // 2
        tier1, tier2 = one.enable_host_tier(4), two.enable_host_tier(4)
        assert [tuple(b.shape) for layer in tier1._bufs for b in layer] == \
            [tuple(b.shape) for layer in tier2._bufs for b in layer]
        s1, s2 = tier1.spill_pages([1, 4]), tier2.spill_pages([1, 4])
        assert [tier1.content_hash(s) for s in s1] == \
            [tier2.content_hash(s) for s in s2]


# --------------------------------------------- snapshot / restore / faults


def test_snapshot_roundtrips_mesh_and_restores_token_exact(model):
    """Kill-and-restore mid-run on the mesh: the snapshot records the
    mesh axes, the restored tp = 2 engine (and one restored onto tp = 4
    through the bridge) finish token-exact vs naive."""
    eng = ServingEngine(runner(model, 2), num_blocks=40, max_batch_size=2,
                        max_model_len=MAXLEN)
    rng = np.random.default_rng(9)
    work = []
    for i in range(3):
        p = list(map(int, rng.integers(1, VOCAB, int(rng.integers(4, 10)))))
        sp = SamplingParams(max_tokens=6)
        work.append((eng.add_request(p, sp, request_id=f"r{i}"), p, sp))
    for _ in range(3):
        eng.step()
    state = json.loads(json.dumps(eng.snapshot()))
    assert state["config"]["mesh_axes"] == {"data": 1, "model": 2}
    base = runner(model)
    for eng2 in (ServingEngine.restore(eng.runner, state),
                 restore_serving_engine(model, state, mesh=cpu_mesh(4),
                                        device="cpu")):
        outs = eng2.run()
        for rid, p, sp in work:
            assert outs[rid].output_tokens == naive_generate(
                base, p, sp, max_model_len=MAXLEN), rid
    assert eng2.runner.tp_size == 4


def test_fault_injected_sharded_decode_retries_exactly(model):
    """Injected device errors on the sharded launches retry and stay
    token-exact; the injector delegates the mesh, so the pools shard."""
    inj = FaultInjector(runner(model, 2), error_every=3, error_target="both")
    assert (inj.tp_size, inj.model_axis) == (2, "model")
    eng = ServingEngine(inj, num_blocks=40, max_batch_size=2,
                        max_model_len=MAXLEN, retry_backoff_s=0.0,
                        sleep_fn=lambda _t: None)
    assert eng.pool.tp_size == 2
    rng = np.random.default_rng(2)
    work = []
    for i in range(3):
        p = list(map(int, rng.integers(1, VOCAB, 6)))
        sp = SamplingParams(max_tokens=6)
        work.append((eng.add_request(p, sp, request_id=f"r{i}"), p, sp))
    outs = eng.run()
    assert eng.metrics.snapshot()["step_retries"] > 0
    base = runner(model)
    for rid, p, sp in work:
        assert outs[rid].finish_reason == "length"
        assert outs[rid].output_tokens == naive_generate(
            base, p, sp, max_model_len=MAXLEN), rid
    assert eng.pool.allocator.check_no_leaks()


# ------------------------------------------------- kernel + staging paths


def test_sharded_ragged_kernel_path_token_exact(model):
    """attn_impl="ragged" at tp = 2: the ragged kernel's plain version runs
    once a shard on its kv-head slice; tokens equal the single-device
    reference path. A shard's call with another shard's head count
    raises."""
    base = runner(model, attn_impl="reference")
    tpk = runner(model, 2, attn_impl="ragged")
    work = [(f"r{i}", [3 + i, 5, 8, 13, 21], SamplingParams(max_tokens=4))
            for i in range(2)]
    _, ref = run_engine(base, work, ragged_batch=True, decode_horizon=1)
    _, got = run_engine(tpk, work, ragged_batch=True, decode_horizon=1)
    assert got == ref
    pool = KVCachePool(1, 4, 4, 4, 8, mesh=cpu_mesh(2), device="cpu")
    q = torch.zeros(1, 1, 4, 8)
    full = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="own heads"):
        paged_attend(q, full, full, pool.shards[0][0],
                     torch.ones(1, 1, dtype=torch.int32),
                     torch.ones(1, 1, dtype=torch.long),
                     torch.zeros(1, 1, dtype=torch.long),
                     torch.zeros(1, dtype=torch.int32),
                     torch.ones(1, dtype=torch.int32), 1, "reference",
                     shard_ctx=(pool.mesh, "model"))


def test_host_array_staging_is_one_copy_to_the_mesh(model):
    """A sharded call stages its host operands once each onto the mesh's
    device, which every shard reads; unsharded runners stage onto theirs."""
    r = runner(model, 2)
    staged = r._stage(np.zeros((2,), np.int32), np.zeros((2, 4), np.int32),
                      np.arange(2, dtype=np.int32))
    assert len(staged) == 3
    for t in staged:
        assert t.device == r.mesh.axis_devices("model")[0]
    assert staged[2].tolist() == [0, 1]


# ------------------------------------------------ quantized collectives


def test_qcomm_engine_token_exact_and_gated(model):
    """int8 comm at tp = 2: token-exact vs its own oracle (the per-row
    chunk scales are batch-shape invariant), >= 2x fewer wire bytes with
    scale bytes counted, >= 99 % greedy agreement with the fp32 engine."""
    rq = runner(model, 2, comm_dtype="int8")
    prompts = greedy_prompts()
    toks, eng = serve_greedy(rq, prompts)
    snap = eng.metrics.snapshot()
    assert snap["tp_comm_bytes"] > 0
    assert snap["tp_comm_bytes_reduction_x"] >= 2.0
    assert snap["tp_gather_bytes_reduction_x"] >= 2.0
    for t, p in zip(toks, prompts):
        assert t == naive_generate(rq, p, SamplingParams(max_tokens=8),
                                   max_model_len=MAXLEN)
    base = runner(model)
    agree = total = 0
    for t, p in zip(toks, prompts):
        ref = naive_generate(base, p, SamplingParams(max_tokens=8),
                             max_model_len=MAXLEN)
        agree += sum(int(a == b) for a, b in zip(t, ref))
        total += len(ref)
    assert agree / total >= 0.99


def _teacher_forced(ref_runner, q_runner, steps=16):
    """Replay the reference greedy stream through both runners: (mean
    top-5 overlap, mean |dlogit|)."""
    p = list(map(int, np.random.default_rng(5).integers(1, VOCAB, 20)))
    pools, tbls = [], []
    for r in (ref_runner, q_runner):
        pool = KVCachePool(r.num_layers, 13, BLOCK, r.n_kv_heads, r.head_dim,
                           r.dtype, mesh=r.mesh, model_axis=r.model_axis,
                           kv_dtype=r.kv_dtype, device="cpu")
        tbls.append(pool.pad_table(pool.allocator.alloc(12), 12))
        pools.append(pool.shards)
    l_ref, pools[0] = ref_runner.prefill(p, tbls[0], pools[0])
    l_q, pools[1] = q_runner.prefill(p, tbls[1], pools[1])
    toks, overlaps, dl = list(p), [], []
    for _ in range(steps):
        a, b = l_ref.numpy(), l_q.numpy()
        dl.append(np.abs(a - b).mean())
        overlaps.append(len(set(np.argsort(a)[-5:].tolist())
                            & set(np.argsort(b)[-5:].tolist())) / 5.0)
        tok = int(np.argmax(a))
        pos = np.asarray([len(toks)], np.int32)
        toks.append(tok)
        l_ref, pools[0] = ref_runner.decode(
            np.asarray([tok], np.int32), np.asarray(tbls[0], np.int32)[None],
            pos, pools[0])
        l_q, pools[1] = q_runner.decode(
            np.asarray([tok], np.int32), np.asarray(tbls[1], np.int32)[None],
            pos, pools[1])
        l_ref, l_q = l_ref[0], l_q[0]
    return float(np.mean(overlaps)), float(np.mean(dl))


def test_qcomm_teacher_forced_top5_overlap(model):
    """Teacher-forced gate with the int8 psum AND fp8 pools on: top-5
    overlap >= 0.99 and mean |dlogit| < 0.05 against the fp32 runner."""
    rq = runner(model, 2, comm_dtype="int8", kv_dtype="fp8")
    overlap, dl = _teacher_forced(runner(model), rq)
    assert overlap >= 0.99 and dl < 0.05


def test_tp_fp32_default_bit_exact_pin(model):
    """comm_dtype default: no scale params, the sharded fp32 engine serves
    the single-device engine's tokens."""
    rtp = runner(model, 2)
    assert rtp.comm_dtype == "fp32"
    assert not any(k.endswith(SCALE_SUFFIX) for k in rtp.params)
    assert rtp.weight_bytes_reduction_x() == 1.0
    prompts = greedy_prompts()[:2]
    assert serve_greedy(rtp, prompts)[0] == \
        serve_greedy(runner(model), prompts)[0]


def test_snapshot_roundtrip_comm_and_fp8_knobs(model):
    rq = runner(model, 2, comm_dtype="int8", kv_dtype="fp8")
    eng = ServingEngine(rq, num_blocks=64, max_batch_size=4,
                        max_model_len=MAXLEN)
    ids = [eng.add_request(p, SamplingParams(max_tokens=6))
           for p in greedy_prompts()[:2]]
    eng.step()
    state = eng.snapshot()
    assert (state["config"]["kv_dtype"], state["config"]["comm_dtype"]) == \
        ("fp8", "int8")
    twin = ServingEngine.restore(rq, state)
    twin_outs = twin.run()
    outs = eng.run()
    for rid in ids:
        assert outs[rid].output_tokens == twin_outs[rid].output_tokens


def test_comm_dtype_validation(model):
    with pytest.raises(ValueError, match="comm_dtype"):
        LlamaRunner(model, BLOCK, MAXLEN).shard(cpu_mesh(2),
                                                comm_dtype="fp8")
    with pytest.raises(ValueError, match="mesh"):
        create_engine(model, num_blocks=16, block_size=BLOCK, device="cpu",
                      comm_dtype="int8")
    eng = create_engine(model, num_blocks=16, block_size=BLOCK,
                        max_model_len=MAXLEN, device="cpu",
                        mesh=cpu_mesh(2), comm_dtype="int8")
    assert (eng.runner.comm_dtype, eng.pool.tp_size) == ("int8", 2)


# ---------------------------------------------------- the weight ladder


def test_int4_engine_token_exact_across_tp(model):
    """tp = 2 int4 serves the single-device int4 engine's tokens: codes and
    group scales shard without requantizing (row-parallel shards own whole
    groups), the grouped epilogue runs in-shard before the reduce."""
    kw = dict(weight_dtype="int4", weight_group_size=16)
    rtp = runner(model, 2, **kw)
    assert rtp._specs["layers.0.mlp.down_proj.weight" + SCALE_SUFFIX] == \
        (None, "model")
    prompts = greedy_prompts()
    t_tp, eng = serve_greedy(rtp, prompts)
    assert t_tp == serve_greedy(runner(model, **kw), prompts)[0]
    audit_engine(eng)


def test_int8_weights_shard_with_their_scales(model):
    r1 = runner(model, weight_dtype="int8")
    r2 = runner(model, 2, weight_dtype="int8")
    assert r2._specs["layers.0.self_attn.q_proj.weight" + SCALE_SUFFIX] \
        == ("model",)
    assert not r2._sharded("layers.0.self_attn.o_proj.weight"
                           + SCALE_SUFFIX)
    prompts = greedy_prompts()
    assert serve_greedy(r2, prompts)[0] == serve_greedy(r1, prompts)[0]


def test_quantized_gather_engine_token_exact(model):
    """int4 weights + int8 comm at tp = 2: the quantized lm_head gather is
    batch-shape invariant, so the engine is token-exact vs its own
    oracle, and both directions' wire bytes shrink >= 2x."""
    rq = runner(model, 2, comm_dtype="int8", weight_dtype="int4",
                weight_group_size=16)
    assert rq._gather_names == frozenset({"lm_head.weight"})
    prompts = greedy_prompts()
    toks, eng = serve_greedy(rq, prompts)
    for t, p in zip(toks, prompts):
        assert t == naive_generate(rq, p, SamplingParams(max_tokens=8),
                                   max_model_len=MAXLEN)
    snap = eng.metrics.snapshot()
    assert snap["tp_gather_bytes"] > 0
    assert snap["tp_gather_bytes_reduction_x"] >= 2.0
    assert snap["tp_comm_bytes_reduction_x"] >= 2.0
    assert snap["weight_bytes_reduction_x"] >= 3.5
    audit_engine(eng)


def test_tp2_per_shard_scale_pool_pin(model):
    """Every shard holds ALL pages' scale rows at n_kv / tp heads: the
    scale pool shards exactly like its code pool."""
    r = runner(model, 2, kv_dtype="int8")
    toks, eng = serve_greedy(r, greedy_prompts())
    pool = eng.pool
    assert pool.per_shard_memory_bytes() == pool.memory_bytes() // 2
    for shard in pool.shards:
        for layer in shard:
            assert len(layer) == 4
            for arr in layer[2:]:
                assert tuple(arr.shape) == (pool.num_blocks,
                                            pool.n_kv_heads // 2)
    for t, p in zip(toks, greedy_prompts()):
        assert t == naive_generate(r, p, SamplingParams(max_tokens=8),
                                   max_model_len=MAXLEN)


def test_shadow_draft_follows_the_mesh(model):
    """A shadow:int8 draft of a sharded target is sharded over the same
    mesh (its pool too) and never rewrites the stream."""
    r = runner(model, 2)
    prompts = greedy_prompts()[:2]
    toks, eng = serve_greedy(r, prompts, num_speculative_tokens=2,
                             spec_draft_model="shadow:int8")
    draft = eng.proposer.runner
    assert draft.tp_size == 2 and draft.weight_dtype == "int8"
    assert draft._shard_params[0]["layers.0.mlp.up_proj.weight"].dtype == \
        torch.int8
    assert eng.proposer.pool.tp_size == 2
    assert toks == serve_greedy(runner(model), prompts)[0]


# ------------------------------------------------------------- offload


def test_tp2_sharded_offload_spill_pagein_token_exact():
    """The host tier over a sharded pool: spills gather each shard's head
    slice into the logical layout, page-ins scatter it back, and the
    streams stay exactly the oracle's."""
    m = Llama(LlamaConfig(vocab_size=97, hidden_size=32, num_layers=2,
                          num_heads=2, num_kv_heads=2, max_seq_len=64),
              device="cpu")
    r = LlamaRunner(m, 8, 64, attn_impl="reference").shard(cpu_mesh(2))
    eng = ServingEngine(r, num_blocks=9, max_batch_size=2, max_model_len=64,
                        host_tier_pages=16)
    wl = np.random.default_rng(1)
    work = []
    for _ in range(2):
        p = list(map(int, wl.integers(1, 97, 20)))
        sp = SamplingParams(max_tokens=16)
        work.append((eng.add_request(p, sp), p, sp))
    outs = eng.run()
    snap = eng.metrics.snapshot()
    assert snap["preemptions"] >= 1 and snap["offload_resumes"] >= 1
    for rid, p, sp in work:
        assert outs[rid].output_tokens == naive_generate(
            r, p, sp, max_model_len=64), rid
    assert eng.pool.allocator.check_no_leaks()
    assert eng.pool.host_tier.used_count == 0


# -------------------------------------------------------------- router


def test_replica_submeshes_partition():
    mesh = cpu_mesh(2, data=2)
    subs = replica_submeshes(mesh)
    assert len(subs) == 2
    for sub in subs:
        assert dict(sub.shape) == {"data": 1, "model": 2}
    assert sum(s.size for s in subs) == mesh.size
    with pytest.raises(ValueError):
        replica_submeshes(cpu_mesh(2), data_axis="nope")


def test_router_tp_submeshes_token_exact(model):
    """2 replicas x tp = 2 on a (data = 2, model = 2) mesh through the
    bridge: each replica on its sub-mesh, the template sharded once for
    the two equal sub-meshes, weights shared; streams exact vs naive. A
    data = 1 mesh shards every replica alike; too few meshes raise."""
    router = create_serving_router(
        model, replicas=2, mesh=cpu_mesh(2, data=2), block_size=BLOCK,
        max_model_len=MAXLEN, num_blocks=16, max_batch_size=2,
        device="cpu")
    try:
        runners = [rep.runner for rep in router._replicas]
        for r in runners:
            assert r.mesh is not None and dict(r.mesh.shape)["model"] == 2
        name = "layers.1.mlp.up_proj.weight"
        assert runners[0]._shard_params[1][name].data_ptr() == \
            runners[1]._shard_params[1][name].data_ptr()
        prompts = greedy_prompts(0)
        sp = SamplingParams(max_tokens=4)
        for i, p in enumerate(prompts):
            router.submit(p, sp, request_id=f"m{i}")
        outs = router.drain(timeout_s=300)
        audit_router(router)
        base = runner(model)
        for i, p in enumerate(prompts):
            assert outs[f"m{i}"].output_tokens == naive_generate(
                base, p, sp, max_model_len=MAXLEN)
    finally:
        router.shutdown()
    router = create_serving_router(
        model, replicas=2, mesh=cpu_mesh(2), block_size=BLOCK,
        max_model_len=MAXLEN, num_blocks=16, max_batch_size=2,
        device="cpu")
    try:
        assert [rep.runner.tp_size for rep in router._replicas] == [2, 2]
    finally:
        router.shutdown()
    with pytest.raises(ValueError, match="1 meshes for 2 replicas"):
        create_serving_router(model, replicas=2, meshes=[cpu_mesh(2)],
                              device="cpu")


# ------------------------------------------------- against the JAX engine


@pytest.fixture(scope="module")
def jax_tp2(pair):
    """The JAX tp = 2 runners (fp32, int8 comm, int8 pool) on the model's
    weights, built once."""
    jm, _ = pair
    mesh = jax_serving_mesh(data=1, model=2)
    return {name: JaxLlamaRunner(jm, block_size=BLOCK, max_model_len=MAXLEN,
                                 attn_impl="reference", **kw).shard(
                                     mesh, comm_dtype=comm)
            for name, comm, kw in (("fp32", "fp32", {}),
                                   ("int8", "int8", {}),
                                   ("pool8", "fp32", {"kv_dtype": "int8"}))}


def _jax_serve(r, prompts, max_tokens=8):
    eng = JaxServingEngine(r, num_blocks=48, max_batch_size=4,
                           max_model_len=MAXLEN, audit=False)
    rids = [eng.add_request(p, JaxSamplingParams(max_tokens=max_tokens))
            for p in prompts]
    outs = eng.run()
    return [outs[i].output_tokens for i in rids], eng


def _logits_pair(ours, ref, prompt, steps=3):
    """Teacher-forced prefill and decode logits of the two runners, each
    over its own pool: [(ours, ref)] numpy pairs."""
    from paddle_tpu.serving import KVCachePool as JaxKVCachePool
    pool = KVCachePool(ours.num_layers, 9, BLOCK, ours.n_kv_heads,
                       ours.head_dim, mesh=ours.mesh, device="cpu",
                       kv_dtype=ours.kv_dtype)
    jpool = JaxKVCachePool(ref.num_layers, 9, BLOCK, ref.n_kv_heads,
                           ref.head_dim, mesh=ref.mesh,
                           kv_dtype=ref.kv_dtype)
    table = list(range(1, 9))
    a, pools = ours.prefill(prompt, table, pool.shards)
    b, jpools = ref.prefill(prompt, table, jpool.pools)
    out = [(a.numpy(), np.asarray(b))]
    toks = list(prompt)
    for _ in range(steps):
        tok = int(np.argmax(out[-1][1]))
        pos = np.asarray([len(toks)], np.int32)
        toks.append(tok)
        tab = np.asarray(table, np.int32)[None]
        a, pools = ours.decode(np.asarray([tok], np.int32), tab, pos, pools)
        b, jpools = ref.decode(np.asarray([tok], np.int32), tab, pos, jpools)
        out.append((a[0].numpy(), np.asarray(b)[0]))
    return out


def test_tp2_engine_equals_the_jax_tp2_engine(model, jax_tp2):
    """The port's tp = 2 engine gives the JAX tp = 2 engine's greedy
    tokens, and the same per-shard pool bytes and tp_* metrics for the
    same traffic, exactly (fp32 and int8 comm)."""
    prompts = greedy_prompts()
    for name in ("fp32", "int8"):
        ours, eng = serve_greedy(runner(model, 2, comm_dtype=name), prompts)
        ref, jeng = _jax_serve(jax_tp2[name], prompts)
        assert ours == ref, name
        assert eng.pool.per_shard_memory_bytes() == \
            jeng.pool.per_shard_memory_bytes()
        snap, jsnap = eng.metrics.snapshot(), jeng.metrics.snapshot()
        keys = sorted(k for k in jsnap if k.startswith("tp_"))
        assert len(keys) == 6
        assert {k: snap[k] for k in keys} == {k: jsnap[k] for k in keys}
        assert snap["tp_comm_bytes"] > 0


def test_tp2_logits_match_the_jax_tp2_runner(model, jax_tp2):
    """fp32 prefill and decode logits within 1e-4 of max|logit| of the JAX
    sharded runner's; int8 comm within QCOMM_LOGIT_TOL."""
    prompt = greedy_prompts(11, 1)[0]
    for name, tol in (("fp32", 1e-4), ("int8", QCOMM_LOGIT_TOL)):
        for ours, ref in _logits_pair(runner(model, 2, comm_dtype=name,
                                             attn_impl="reference"),
                                      jax_tp2[name], prompt):
            scale = np.abs(ref).max()
            assert np.abs(ours - ref).max() <= tol * scale, name


@pytest.mark.parametrize("seed", [11, 3])
def test_fp32_comm_fails_the_int8_comm_tolerance(model, jax_tp2, seed):
    """The control of QCOMM_LOGIT_TOL: every step of the port's fp32-comm
    runner parts from the JAX int8-comm runner's logits, and from the
    port's int8-comm runner's, by more than the tolerance, while the
    port's int8-comm runner holds it."""
    prompt = greedy_prompts(seed, 1)[0]
    fp32 = runner(model, 2, attn_impl="reference")
    int8 = runner(model, 2, comm_dtype="int8", attn_impl="reference")
    for (ours, ref), (q, _) in zip(_logits_pair(fp32, jax_tp2["int8"],
                                                prompt),
                                   _logits_pair(int8, jax_tp2["int8"],
                                                prompt)):
        scale = np.abs(ref).max()
        assert np.abs(q - ref).max() <= QCOMM_LOGIT_TOL * scale
        assert np.abs(ours - ref).max() > QCOMM_LOGIT_TOL * scale
        assert np.abs(ours - q).max() > QCOMM_LOGIT_TOL * scale


def test_int8_pool_tp2_engine_equals_the_jax_one(model, jax_tp2):
    """An int8 KV pool at tp = 2 (scale pools sharded with the codes)
    gives the JAX int8-pool tp = 2 engine's tokens."""
    prompts = greedy_prompts()
    ours, _ = serve_greedy(runner(model, 2, kv_dtype="int8"), prompts)
    assert ours == _jax_serve(jax_tp2["pool8"], prompts)[0]


def test_bridge_casts_then_shards(model):
    """create_serving_engine(mesh=, comm_dtype=, dtype=): the runner's dict
    is cast first, then sharded (the shards are views of the cast
    tensors); the bf16 tp = 2 engine serves its own naive tokens."""
    eng = create_serving_engine(model, dtype="bfloat16", device="cpu",
                                mesh=cpu_mesh(2), comm_dtype="int8",
                                block_size=BLOCK, max_model_len=MAXLEN,
                                num_blocks=32)
    r = eng.runner
    assert r.dtype == torch.bfloat16 and r.comm_dtype == "int8"
    assert r._shard_params[1]["layers.0.mlp.up_proj.weight"].dtype == \
        torch.bfloat16
    assert eng.pool.shards[1][0][0].dtype == torch.bfloat16
    p = greedy_prompts()[0]
    rid = eng.add_request(p, SamplingParams(max_tokens=5))
    assert eng.run()[rid].output_tokens == naive_generate(
        r, p, SamplingParams(max_tokens=5), max_model_len=MAXLEN)
