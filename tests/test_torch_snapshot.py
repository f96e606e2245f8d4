"""The port's engine snapshot / restore against the JAX package, on the
CPU.

The pins of tests/test_serving_resilience.py (:308 kill-and-restore
against naive_generate, :346 seeded streams across a restore, :370 an
unknown version) and tests/test_serving_offload.py:427 (the tier's knobs
survive a restore, its host pages do not), on the port's engine; the
port's snapshot of a scripted run equals the JAX snapshot's ``config``
and ``requests`` on the same workload and weights (timings, and arrival
indices up to their offset, excepted); `inference.restore_serving_engine`
rebuilds the runner with the recorded kv_dtype / weight_dtype.
"""

import itertools
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import create_serving_engine as jax_create
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.serving import EngineMetrics as JaxEngineMetrics
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu_torch.inference import (
    create_serving_engine, restore_serving_engine,
)
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.serving import (
    EngineMetrics, LlamaRunner, SamplingParams, ServingEngine,
    naive_generate,
)
from paddle_tpu_torch.weights import load_params
from test_torch_offload import TorchStubRunner, _add, _assert_oracle, \
    _engine, _workload

torch.set_num_threads(1)

SIZES = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             num_kv_heads=1, max_seq_len=64)
TIMINGS = ("elapsed_s", "first_token_elapsed_s", "ttft_s", "e2e_s")


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


@pytest.fixture(scope="module")
def pair():
    """(JAX GQA Llama, the port's Llama holding its weights)."""
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(dropout=0.0, **SIZES))
    jm.eval()
    arrays = {k: np.asarray(v)
              for k, v in functionalize(jm).param_values().items()}
    pm = Llama(LlamaConfig(**SIZES), device="cpu", seed=1)
    load_params(pm, arrays)
    return jm, pm


def test_kill_and_restore_matches_naive(pair):
    """Snapshot mid-workload with a preempted waiter and a running request,
    through JSON, restore on a fresh runner, finish: every request's
    tokens equal naive_generate's."""
    _, pm = pair
    runner = LlamaRunner(pm, 8, 64)
    eng = ServingEngine(runner, num_blocks=10, max_batch_size=4,
                        max_model_len=64)
    wl = np.random.default_rng(7)
    work = []
    for _ in range(16):
        p = list(map(int, wl.integers(1, 97, int(wl.integers(3, 25)))))
        sp = SamplingParams(max_tokens=int(wl.integers(2, 11)))
        work.append((eng.add_request(p, sp), p, sp))
    state = None
    for _ in range(300):
        eng.step()
        if (any(r.num_preemptions > 0 for r in eng.scheduler.waiting)
                and eng.scheduler.running):
            state = eng.snapshot()
            break
    assert state is not None
    assert any(r["num_preemptions"] > 0 for r in state["requests"])
    assert any(r["output_tokens"] for r in state["requests"])
    state = json.loads(json.dumps(state))
    eng2 = ServingEngine.restore(LlamaRunner(pm, 8, 64), state)
    outs = eng2.run()
    assert len(outs) == 16
    for rid, p, sp in work:
        assert outs[rid].finish_reason == "length"
        assert outs[rid].output_tokens == naive_generate(
            runner, p, sp, max_model_len=64), rid
    assert eng2.pool.allocator.check_no_leaks()


def test_restore_preserves_seeded_sample_streams():
    """Seedless sampling draws from the arrival index: a restore keeps it,
    and a request added after the restore gets a fresh one."""
    runner = TorchStubRunner(block_size=4, max_model_len=32)
    eng = ServingEngine(runner, num_blocks=16, max_batch_size=2,
                        max_model_len=32)
    sp = SamplingParams(max_tokens=6, temperature=0.9, top_k=8)
    ids = [eng.add_request([i + 2, i + 3], sp) for i in range(3)]
    seeds = {rid: eng._requests[rid].arrival_index for rid in ids}
    for _ in range(2):
        eng.step()
    state = json.loads(json.dumps(eng.snapshot()))
    eng2 = ServingEngine.restore(TorchStubRunner(block_size=4,
                                                 max_model_len=32), state)
    outs = eng2.run()
    for rid in ids:
        assert outs[rid].output_tokens == naive_generate(
            runner, eng._requests[rid].prompt_tokens, sp, max_model_len=32,
            fallback_seed=seeds[rid])
    new_rid = eng2.add_request([9, 9], SamplingParams(max_tokens=1))
    assert eng2._requests[new_rid].arrival_index > max(seeds.values())


def test_restore_rejects_unknown_version():
    with pytest.raises(ValueError):
        ServingEngine.restore(TorchStubRunner(), {"version": 99})


def test_snapshot_restore_round_trips_tier_config_host_pages_die():
    """The tier's knobs survive the round trip, its pages do not: every
    restored request recomputes, token for token, and the new tier
    refills from fresh spills."""
    eng = _engine(host_tier_headroom=True, pagein_prefetch=3,
                  spill_async=True)
    ids = _add(eng, _workload(seed=0))
    for _ in range(4):
        eng.step()
    snap = json.loads(json.dumps(eng.snapshot()))
    cfg = snap["config"]
    assert (cfg["host_tier_pages"], cfg["host_tier_headroom"],
            cfg["pagein_prefetch"], cfg["spill_async"]) == (32, True, 3,
                                                             True)
    restored = ServingEngine.restore(eng.runner, snap)
    tier = restored.pool.host_tier
    assert tier is not None and tier.used_count == 0 and tier.async_spill
    assert restored.scheduler.count_host_headroom is True
    _assert_oracle(restored.runner, ids, restored.run())
    assert restored.pool.allocator.check_no_leaks()
    assert tier.used_count == 0


def _clock():
    ticks = itertools.count()
    return lambda: float(next(ticks))


@pytest.mark.parametrize("knobs", [
    {}, {"enable_prefix_cache": True, "max_prefill_tokens_per_step": 16,
         "host_tier_pages": 12, "decode_horizon": 4}],
    ids=["default", "prefix-chunked-tier-horizon"])
def test_snapshot_equals_the_jax_snapshot_of_the_same_run(pair, knobs):
    """The same scripted run through the port's and the JAX engine: the
    snapshots' config equal, and their requests and finished outputs
    equal but for the timings (arrival indices up to their offset: each
    package counts its own)."""
    jm, pm = pair
    kw = dict(block_size=8, max_model_len=64, num_blocks=10,
              max_batch_size=3, **knobs)
    eng = create_serving_engine(pm, device="cpu",
                                metrics=EngineMetrics(clock=_clock()), **kw)
    jeng = jax_create(jm, metrics=JaxEngineMetrics(clock=_clock()), **kw)
    wl = np.random.default_rng(5)
    for i in range(7):
        p = list(map(int, wl.integers(1, 97, int(wl.integers(5, 20)))))
        n = int(wl.integers(3, 12))
        eng.add_request(p, SamplingParams(max_tokens=n), f"r{i}")
        jeng.add_request(p, JaxSamplingParams(max_tokens=n), f"r{i}")
    for _ in range(6):
        eng.step()
        jeng.step()
    ours, ref = eng.snapshot(), jeng.snapshot()
    assert ours["version"] == ref["version"] == 1
    assert ours["config"] == ref["config"]

    def strip(items):
        base = min([r["arrival_index"] for r in items
                    if "arrival_index" in r] or [0])
        out = []
        for r in items:
            r = {k: v for k, v in r.items() if k not in TIMINGS}
            if "arrival_index" in r:
                r["arrival_index"] -= base
            out.append(r)
        return out

    assert strip(ours["requests"]) == strip(ref["requests"])
    assert strip(ours["finished"]) == strip(ref["finished"])
    assert ours["requests"] and ours["finished"]


@pytest.mark.parametrize("kv_dtype,weight_dtype", [("int8", "int8"),
                                                   ("fp8", "fp32")])
def test_restore_serving_engine_rebuilds_with_the_recorded_dtypes(
        pair, kv_dtype, weight_dtype):
    """inference.restore_serving_engine builds the fresh runner with the
    snapshot's kv_dtype and weight_dtype; the restored run finishes as the
    uninterrupted one does."""
    _, pm = pair
    kw = dict(block_size=8, max_model_len=64, num_blocks=24,
              max_batch_size=2, kv_dtype=kv_dtype, weight_dtype=weight_dtype)
    prompts = [[5, 9, 2, 33, 41, 7], [3, 1, 4, 1, 5, 9, 2, 6]]
    whole = create_serving_engine(pm, device="cpu", **kw)
    ids = [whole.add_request(p, SamplingParams(max_tokens=6))
           for p in prompts]
    want = whole.run()
    eng = create_serving_engine(pm, device="cpu", **kw)
    for p in prompts:
        eng.add_request(p, SamplingParams(max_tokens=6))
    eng.step()
    eng.step()
    state = json.loads(json.dumps(eng.snapshot()))
    restored = restore_serving_engine(pm, state, device="cpu")
    assert restored.kv_dtype == kv_dtype
    assert restored.runner.weight_dtype == weight_dtype
    assert restored.runner.device.type == "cpu"
    got = restored.run()
    new_ids = [r for r in got]
    assert len(new_ids) == 2
    for rid_w, rid_g in zip(ids, sorted(got, key=lambda r: int(r[4:]))):
        assert got[rid_g].output_tokens == want[rid_w].output_tokens
    # onto a runner over a mesh (item 10, ported; one kv head: one
    # shard): the mesh may differ from the snapshot's, the streams do not
    from paddle_tpu_torch.serving import serving_mesh
    on_mesh = restore_serving_engine(
        pm, state, mesh=serving_mesh(1, 1, devices=["cpu"]), device="cpu")
    assert on_mesh.runner.is_sharded and on_mesh.pool.mesh is not None
    got = on_mesh.run()
    for rid_w, rid_g in zip(ids, sorted(got, key=lambda r: int(r[4:]))):
        assert got[rid_g].output_tokens == want[rid_w].output_tokens
