"""The pipelined loop, seeded-temperature horizons and on-device early
stop in the port, on the CPU.

Follows tests/test_serving_pipeline.py: `pipelined=True` plans a step
while the previous step's launch is in flight and commits it next step
(one launch in flight), `horizon_sampling=True` runs temperature > 0
batches inside the horizon with the per-step seeded streams bit for bit,
and `horizon_early_stop=True` freezes a done row on the device. None of
them changes a token. Pinned on a small Llama bridged from JAX:

  * the one-in-flight invariant;
  * pipelined streams equal the unpipelined streams and `naive_generate`;
  * `step` returns the previous launch's tokens; `flush` fences;
  * the auditor holds with a launch in flight;
  * the seeded temperature horizon equals the per-step stream, and the
    JAX engine's with the same knobs on seeds 0-3;
  * heterogeneous top_k falls back to the per-step path;
  * early stop gives zero overshoot;
  * dispatch-time and drain-time faults; an abort mid-flight;
  * the fuzz oracle (a seeded mix of every knob against naive_generate).

The JAX file's asynchronous-spill cases (the host tier, ROADMAP item 9)
and its snapshot / kill-and-restore cases (item 15) are left out: the
port carries neither yet. Every engine runs under the invariant auditor.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import create_serving_engine as jax_create_engine
from paddle_tpu.jit.functionalize import functionalize
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.serving import SamplingParams as JaxSamplingParams
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.serving import (
    LlamaRunner, SamplingParams, ServingEngine, audit_engine, naive_generate,
)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.weights import load_params

torch.set_num_threads(1)

SIZES = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=2,
             max_seq_len=64)
MAX_LEN = 64


@pytest.fixture(autouse=True)
def _audit_every_engine(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_SERVING_AUDIT", "1")


@pytest.fixture(scope="module")
def pair():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(num_kv_heads=2, dropout=0.0, **SIZES))
    jm.eval()
    arrays = {k: np.asarray(v)
              for k, v in functionalize(jm).param_values().items()}
    pm = Llama(LlamaConfig(num_kv_heads=2, **SIZES), device="cpu", seed=1)
    load_params(pm, arrays)
    return jm, pm


@pytest.fixture(scope="module")
def runner(pair):
    return LlamaRunner(pair[1], 8, MAX_LEN)


def _engine(runner, **kw):
    kw = {"num_blocks": 40, "max_batch_size": 3, "max_model_len": MAX_LEN,
          **kw}
    return ServingEngine(runner, **kw)


def _match_naive(eng, work, runner, max_model_len=MAX_LEN):
    for rid, p, sp in work:
        assert eng.outputs()[rid].output_tokens == naive_generate(
            runner, p, sp, max_model_len=max_model_len), rid


def _drain(eng, pending):
    work = [(eng.add_request(p, sp), p, sp) for p, sp in pending]
    eng.run()
    assert eng._inflight is None
    assert eng.pool.allocator.check_no_leaks()
    return work


def _workload(seed, n):
    rng = np.random.default_rng(seed)
    return [(list(map(int, rng.integers(1, 97, int(rng.integers(2, 9))))),
             SamplingParams(max_tokens=int(rng.integers(2, 14))))
            for _ in range(n)]


# ------------------------------------------------------- the pipeline


def test_one_launch_in_flight_invariant(runner, monkeypatch):
    state = {"outstanding": 0, "max": 0, "commits": 0}

    class Tracking:
        def __getattr__(self, name):
            return getattr(runner, name)

        def _launch(self, fn, *a, **kw):
            state["outstanding"] += 1
            state["max"] = max(state["max"], state["outstanding"])
            return fn(*a, **kw)

        def decode(self, *a, **kw):
            return self._launch(runner.decode, *a, **kw)

        def decode_multi(self, *a, **kw):
            return self._launch(runner.decode_multi, *a, **kw)

    real = engine_mod._to_host

    def draining(x):
        if state["outstanding"]:
            state["outstanding"] -= 1
            state["commits"] += 1
        return real(x)

    monkeypatch.setattr(engine_mod, "_to_host", draining)
    eng = _engine(Tracking(), decode_horizon=4, pipelined=True)
    for i in range(3):
        eng.add_request([1 + i, 2, 3], SamplingParams(max_tokens=8))
    while eng.has_work():
        eng.step()
        assert state["outstanding"] <= 1
    assert state["max"] == 1 and state["commits"] > 0
    assert eng._inflight is None
    assert eng.pool.allocator.check_no_leaks()


@pytest.mark.parametrize("s", [1, 4])
def test_pipelined_streams_match_unpipelined_and_naive(runner, s):
    outs = {}
    for pipelined in (False, True):
        eng = _engine(runner, decode_horizon=s, pipelined=pipelined)
        work = _drain(eng, _workload(7, 6))
        outs[pipelined] = [eng.outputs()[rid].output_tokens
                           for rid, _, _ in work]
        if pipelined:
            _match_naive(eng, work, runner)
            assert eng.metrics.planned_ahead_steps.value > 0
    assert outs[False] == outs[True]


def test_step_returns_previous_launch_tokens_and_flush_fences(runner):
    eng = _engine(runner, max_batch_size=2, decode_horizon=4,
                  pipelined=True)
    eng.add_request([3, 1, 4], SamplingParams(max_tokens=8))
    ev1 = eng.step()   # admit + prefill (token 0) + a decode in flight
    assert [e.index for e in ev1] == [0]
    ev2 = eng.step()   # commits token 1, leaves a horizon in flight
    assert [e.index for e in ev2] == [1]
    assert eng._inflight is not None and eng._inflight.s == 4
    fl = eng.flush()
    assert [e.index for e in fl] == [2, 3, 4, 5]
    assert eng._inflight is None
    assert eng.flush() == []
    eng.run()
    assert eng.outputs()[next(iter(eng.outputs()))].output_tokens == \
        naive_generate(runner, [3, 1, 4], SamplingParams(max_tokens=8),
                       max_model_len=MAX_LEN)


def test_auditor_holds_with_launch_in_flight(runner):
    eng = _engine(runner, max_batch_size=2, decode_horizon=8,
                  pipelined=True)
    eng.add_request([3, 1, 4], SamplingParams(max_tokens=12))
    eng.step()
    eng.step()
    assert eng._inflight is not None and eng._inflight.s > 1
    audit_engine(eng)
    eng.flush()
    audit_engine(eng)


# ------------------------------------------ seeded-temperature horizons


def _sampled_work(temps=(0.0, 0.7, 1.3), top_k=None, top_p=None, base=50):
    return [([5 + i, 9, 2], SamplingParams(
        max_tokens=11, temperature=t, seed=base + i if t else None,
        top_k=top_k if t else None, top_p=top_p if t else None))
        for i, t in enumerate(temps)]


@pytest.mark.parametrize("top_k,top_p", [(None, None), (8, 0.9)])
def test_seeded_temperature_horizon_matches_per_step_stream(runner, top_k,
                                                            top_p):
    outs = []
    for s, kw in ((1, {}), (6, {"horizon_sampling": True}),
                  (6, {"horizon_sampling": True, "pipelined": True,
                       "horizon_early_stop": True})):
        eng = _engine(runner, decode_horizon=s, **kw)
        work = _drain(eng, _sampled_work(top_k=top_k, top_p=top_p))
        outs.append([eng.outputs()[rid].output_tokens for rid, _, _ in work])
        if s > 1:
            assert eng.metrics.decode_horizon_steps.value > 0
            _match_naive(eng, work, runner)
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("seed", range(4))
def test_seeded_horizon_equals_the_jax_engine(pair, runner, seed):
    jm, _ = pair
    knobs = dict(decode_horizon=6, horizon_sampling=True,
                 horizon_early_stop=True, pipelined=True)
    work = [([7, 3, 11], SamplingParams(max_tokens=10, temperature=0.9,
                                        seed=seed, top_k=20)),
            ([4, 4], SamplingParams(max_tokens=10, temperature=1.2,
                                    seed=seed + 10, top_k=20)),
            ([2, 8, 1], SamplingParams(max_tokens=10))]
    eng = _engine(runner, **knobs)
    got = [eng.outputs()[rid].output_tokens
           for rid, _, _ in _drain(eng, work)]
    jeng = jax_create_engine(jm, block_size=8, max_model_len=MAX_LEN,
                             num_blocks=40, max_batch_size=3, **knobs)
    ids = [jeng.add_request(p, JaxSamplingParams(
        max_tokens=sp.max_tokens, temperature=sp.temperature, seed=sp.seed,
        top_k=sp.top_k)) for p, sp in work]
    jout = jeng.run()
    assert [jout[i].output_tokens for i in ids] == got
    assert jeng.metrics.snapshot()["decode_horizon_steps"] == \
        eng.metrics.decode_horizon_steps.value


def test_heterogeneous_topk_falls_back_to_per_step(runner):
    eng = _engine(runner, max_batch_size=2, decode_horizon=8,
                  horizon_sampling=True)
    work = _drain(eng, [
        ([2, 3, 4], SamplingParams(max_tokens=8, temperature=0.7, seed=5,
                                   top_k=4)),
        ([2, 3, 4], SamplingParams(max_tokens=8, temperature=0.7, seed=6,
                                   top_k=8))])
    assert eng.metrics.decode_horizon_steps.value == 0
    _match_naive(eng, work, runner)


def test_temperature_without_horizon_sampling_takes_per_step(runner):
    eng = _engine(runner, max_batch_size=2, decode_horizon=8)
    work = _drain(eng, _sampled_work(temps=(0.0, 0.7)))
    assert eng.metrics.decode_horizon_steps.value == 0
    _match_naive(eng, work, runner)


# ------------------------------------------------------- early stop


def test_early_stop_zero_overshoot(runner):
    ref = naive_generate(runner, [5, 9], SamplingParams(max_tokens=24),
                         max_model_len=MAX_LEN)
    sp = SamplingParams(max_tokens=24, stop_token_ids=(ref[3],))
    for early in (False, True):
        eng = _engine(runner, max_batch_size=2, decode_horizon=8,
                      horizon_early_stop=early)
        rid = eng.add_request([5, 9], sp)
        out = eng.run()[rid]
        assert out.finish_reason == "stop"
        assert out.output_tokens == naive_generate(runner, [5, 9], sp,
                                                   max_model_len=MAX_LEN)
        over = eng.metrics.horizon_overshoot_tokens.value
        assert (over == 0) if early else (over > 0)
        assert eng.pool.allocator.check_no_leaks()


def test_early_stop_mixed_budgets_run_full_horizons(runner):
    eng = _engine(runner, max_batch_size=2, decode_horizon=8,
                  horizon_early_stop=True, pipelined=True)
    work = _drain(eng, [([2, 3, 4], SamplingParams(max_tokens=3)),
                        ([2, 3, 4], SamplingParams(max_tokens=21))])
    assert eng.metrics.horizon_overshoot_tokens.value == 0
    _match_naive(eng, work, runner)


# ------------------------------------------------- faults and aborts


class FlakyDecode:
    """Every ``every``-th decode call raises before it runs."""

    def __init__(self, runner, every):
        self._runner, self.every, self.calls = runner, every, 0

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def _pre(self):
        self.calls += 1
        if self.calls % self.every == 0:
            raise RuntimeError("injected device error")

    def decode(self, *a, **kw):
        self._pre()
        return self._runner.decode(*a, **kw)

    def decode_multi(self, *a, **kw):
        self._pre()
        return self._runner.decode_multi(*a, **kw)


def test_dispatch_time_fault_retries_token_exact(runner):
    eng = _engine(FlakyDecode(runner, 4), max_batch_size=2,
                  decode_horizon=4, pipelined=True, retry_backoff_s=0.0)
    sp = SamplingParams(max_tokens=12)
    work = _drain(eng, [([5, 9, 2], sp)])
    assert eng.metrics.step_retries.value > 0
    _match_naive(eng, work, runner)


def test_drain_time_fault_reruns_the_step(runner, monkeypatch):
    eng = _engine(runner, max_batch_size=2, decode_horizon=4,
                  pipelined=True, retry_backoff_s=0.0)
    sp = SamplingParams(max_tokens=12)
    rid = eng.add_request([5, 9, 2], sp)
    real = engine_mod._to_host
    state = {"armed": 0, "fired": 0}

    def flaky(x):
        if state["armed"]:
            state["armed"] -= 1
            state["fired"] += 1
            raise RuntimeError("injected drain-time device error")
        return real(x)

    monkeypatch.setattr(engine_mod, "_to_host", flaky)
    steps = 0
    while eng.has_work():
        steps += 1
        if steps == 3:
            assert eng._inflight is not None
            state["armed"] = 1
        eng.step()
    assert state["fired"] == 1
    assert eng.metrics.step_retries.value >= 1
    assert eng.outputs()[rid].output_tokens == naive_generate(
        runner, [5, 9, 2], sp, max_model_len=MAX_LEN)
    assert eng.pool.allocator.check_no_leaks()


def test_abort_mid_flight_discards_inflight_tokens(runner):
    eng = _engine(runner, max_batch_size=2, decode_horizon=4,
                  pipelined=True)
    rid = eng.add_request([5, 9, 2], SamplingParams(max_tokens=20))
    eng.step()
    eng.step()
    assert eng._inflight is not None
    n_before = len(eng._requests[rid].output_tokens)
    assert eng.abort(rid)
    assert eng.outputs()[rid].finish_reason == "aborted"
    eng.run()
    assert len(eng.outputs()[rid].output_tokens) == n_before
    assert eng.pool.allocator.check_no_leaks()


def test_pipelined_syncs_per_token_at_horizon_8(runner):
    eng = _engine(runner, max_batch_size=2, decode_horizon=8,
                  pipelined=True, horizon_early_stop=True)
    gen = 40
    work = _drain(eng, [([7, 3], SamplingParams(max_tokens=gen)),
                        ([4, 4], SamplingParams(max_tokens=gen))])
    m = eng.metrics.snapshot()
    assert m["tokens_generated"] == 2 * gen
    assert m["host_syncs_per_token"] <= 0.15
    _match_naive(eng, work, runner)


# ---------------------------------------------------------------- fuzz


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_pipeline_oracle_equivalence(pair, trial):
    """Random horizons, prefill budgets, temperatures, stop sets, early
    stop and pipelining: every stream equals naive_generate's, no page
    leaks, the auditor armed."""
    rng = np.random.default_rng(1234 + trial)
    block = int(rng.choice([4, 8]))
    max_len = 48
    r = LlamaRunner(pair[1], block, max_len)
    kw = dict(num_blocks=max(-(-max_len // block) + 2,
                             int(rng.integers(10, 30))),
              max_batch_size=int(rng.integers(1, 4)), max_model_len=max_len,
              decode_horizon=int(rng.integers(1, 9)),
              pipelined=bool(rng.integers(0, 2)),
              horizon_sampling=bool(rng.integers(0, 2)),
              horizon_early_stop=bool(rng.integers(0, 2)),
              max_prefill_tokens_per_step=(int(rng.integers(2, 9))
                                           if rng.integers(0, 2) else None))
    eng = ServingEngine(r, **kw)
    pending = []
    for _ in range(int(rng.integers(2, 6))):
        plen = int(rng.integers(1, 10))
        temp = float(rng.choice([0.0, 0.0, 0.9]))
        pending.append((list(map(int, rng.integers(1, 97, plen))),
                        SamplingParams(
                            max_tokens=int(rng.integers(1, 16)),
                            temperature=temp,
                            seed=int(rng.integers(0, 1000)) if temp else None,
                            stop_token_ids=(
                                tuple(map(int, rng.integers(1, 97, 2)))
                                if rng.integers(0, 2) else ()))))
    work = []
    while pending or eng.has_work():
        for _ in range(int(rng.integers(0, 3))):
            if pending:
                p, sp = pending.pop(0)
                work.append((eng.add_request(p, sp), p, sp))
        eng.step()
    for rid, p, sp in work:
        req = eng._requests[rid]
        assert eng.outputs()[rid].output_tokens == naive_generate(
            r, p, sp, max_model_len=max_len,
            fallback_seed=req.arrival_index), (trial, kw, rid)
    assert eng.pool.allocator.check_no_leaks(), (trial, kw)
