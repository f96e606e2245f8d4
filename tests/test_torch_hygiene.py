"""The port's boundaries: what it imports, where it runs, which path each
kernel wrapper takes, and what it refuses.

  * nothing in paddle_tpu_torch/ (amp/ included) or chip_smoke.py imports
    jax or the JAX package (an AST scan, so a lazy import inside a
    function counts too); the port's AMP lists equal the JAX lists;
  * entry points default to "cuda" and raise where no card is usable;
  * CPU tensors run the plain versions: `plain_launches` moves and
    `kernel_launches` never does;
  * every engine knob the port does not carry raises NotImplementedError
    naming its ROADMAP item; the four horizon and pipeline knobs, and
    temperature > 0, are served;
  * the serving entry points take the JAX package's positional and
    keyword arguments (runner, runner_for, create_serving_engine,
    SamplingParams, naive_generate, KVCachePool), `device` only by
    keyword; FCFSScheduler, SequenceKV and paged_attend take the JAX
    parameters the port does not serve at their defaults and refuse any
    other value naming its ROADMAP item; rotary_embedding takes
    position_ids as the JAX op does;
  * the faults F5-F8 stay repaired: `Request` has the JAX fields in the
    JAX order and refuses the host-tier and prefix ones at other values
    (F5); `Optimizer` takes the JAX base's signature (F6); the kernel
    wrappers take the JAX `interpret` (and `block_q` / `block_k` for
    flash_attention) in their JAX slots, every `ops.*` wrapper's positional
    parameters are its `ops.pallas.*` twin's, and a 64-block block mask
    equals the JAX one on the CPU (F7); `paged_decode_attention` takes a
    scalar `pos` (F8);
  * chip_smoke.py fails, and prints no result, without a card or outside
    a checkout.
"""

import ast
import dataclasses
import importlib
import inspect
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.impl as jax_impl
import paddle_tpu_torch.ops.flash_attention as fa
import paddle_tpu_torch
import paddle_tpu_torch.ops.paged_attention as k2
import paddle_tpu_torch.ops.ragged_paged_attention as k1
from paddle_tpu.inference import create_serving_engine as \
    jax_create_serving_engine
from paddle_tpu.models.llama import Llama as JaxLlama
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.serving import LlamaRunner as JaxLlamaRunner
from paddle_tpu.serving import runner_for as jax_runner_for
from paddle_tpu.serving.kv_cache import KVCachePool as JaxKVCachePool
from paddle_tpu.serving.kv_cache import SequenceKV as JaxSequenceKV
from paddle_tpu.serving.model_runner import paged_attend as jax_paged_attend
from paddle_tpu.optimizer.optimizer import Optimizer as JaxOptimizer
from paddle_tpu.serving.scheduler import FCFSScheduler as JaxFCFSScheduler
from paddle_tpu.serving.scheduler import Request as JaxRequest
from paddle_tpu.serving.scheduler import SamplingParams as JaxSamplingParams
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    GPT, ErnieConfig, ErnieForPretraining, ErnieForSequenceClassification,
    ErnieForTokenClassification, ErnieModel, Llama, LlamaConfig,
    llama_loss_fn,
)
from paddle_tpu_torch.models.generation import PagedKVCache
from paddle_tpu_torch.models.llama import rope_tables
from paddle_tpu_torch.ops import _build, impl
from paddle_tpu_torch.optimizer import AdamW, Optimizer
from paddle_tpu_torch.serving import (
    SamplingParams, create_engine, naive_generate,
)
from paddle_tpu_torch.serving.engine import UNPORTED_KNOBS
from paddle_tpu_torch.serving.kv_cache import KVCachePool, SequenceKV
from paddle_tpu_torch.serving.model_runner import (
    LlamaRunner, paged_attend, runner_for,
)
from paddle_tpu_torch.serving.scheduler import (
    FCFSScheduler, Request, RequestState,
)

# the Pallas modules (the package re-exports functions of the same names)
jfa, jk1, jk2 = (importlib.import_module(f"paddle_tpu.ops.pallas.{m}") for m in
                 ("flash_attention", "ragged_paged_attention",
                  "paged_attention"))

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(Path(paddle_tpu_torch.__file__).parent.rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
SIZES = dict(vocab_size=61, hidden_size=32, num_layers=1, num_heads=2,
             max_seq_len=32)


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
                and getattr(node.func, "attr", getattr(node.func, "id", ""))
                in ("import_module", "__import__") and node.args
                and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_whole_port():
    names = {p.name for p in PORT_FILES}
    assert {"engine.py", "model_runner.py", "ragged_paged_attention.py",
            "paged_attention.py", "_build.py", "chip_smoke.py",
            "flash_attention.py", "impl.py", "flags.py", "optimizer.py",
            "clip.py", "api.py", "weights.py", "ernie.py",
            "random.py", "state.py"} <= names
    assert REPO / "paddle_tpu_torch" / "amp" / "__init__.py" in PORT_FILES


def test_amp_lists_equal_the_jax_lists():
    """The port keeps its own copy of the JAX package's AMP lists (it may
    not import them); the copies must stay equal by value."""
    from paddle_tpu.amp import state as jax_state
    from paddle_tpu_torch.amp import state
    assert state.WHITE_LIST == jax_state.WHITE_LIST
    assert state.BLACK_LIST == jax_state.BLACK_LIST


# ------------------------------------------------------------- devices


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda():
    for fn in (create_serving_engine, create_engine, Llama.__init__,
               KVCachePool.__init__, rope_tables, ErnieModel.__init__,
               ErnieForPretraining.__init__,
               ErnieForSequenceClassification.__init__,
               ErnieForTokenClassification.__init__, GPT.__init__,
               PagedKVCache.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cuda_without_a_card_raises_clearly(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Llama(LlamaConfig(**SIZES))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCachePool(1, 4, 4, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rope_tables(8, 8, 1e4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErnieForPretraining(ErnieConfig(vocab_size=16, hidden_size=8,
                                        num_layers=1, num_heads=2))
    model = Llama(LlamaConfig(**SIZES), device="cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        create_serving_engine(model, num_blocks=8)


def test_other_devices_are_refused():
    with pytest.raises(ValueError):
        paddle_tpu_torch.resolve_device("mps")
    q = torch.empty(1, 8, 2, 8, device="meta")
    pool = torch.empty(3, 4, 2, 8, device="meta")
    idx = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        k1.ragged_paged_attention(q, pool, pool, idx[None], idx, idx)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k2.paged_decode_attention(q[:, 0], pool, pool, idx[None], idx)


def test_mixed_devices_are_refused():
    q = torch.zeros(1, 8, 2, 8)
    pool = torch.zeros(3, 4, 2, 8)
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="several devices"):
        k1.ragged_paged_attention(q, pool, pool.to("meta"), idx[None], idx,
                                  idx)


def test_cpu_tensors_run_the_plain_versions_only():
    rng = np.random.default_rng(0)
    pool = torch.from_numpy(rng.standard_normal((5, 4, 2, 8), np.float32))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    pos = torch.tensor([5, 2], dtype=torch.int32)
    for counts in (k1.COUNTS, k2.COUNTS):
        counts.reset()
    k1.ragged_paged_attention(torch.zeros(2, 8, 2, 8), pool, pool, table,
                              pos, pos)
    k2.paged_decode_attention(torch.zeros(2, 2, 8), pool, pool, table, pos)
    assert (k1.COUNTS.plain_launches, k1.COUNTS.kernel_launches) == (1, 0)
    assert (k2.COUNTS.plain_launches, k2.COUNTS.kernel_launches) == (1, 0)


def test_nothing_is_built_on_import_or_on_the_cpu():
    assert _build._LIB is None
    assert not list(_build.BUILD_DIR.glob("*.so")) or \
        torch.cuda.is_available()


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.mark.parametrize("attn_impl", ["auto", "pallas", "ragged"])
def test_untileable_shape_raises_on_cuda_runner(attn_impl):
    # head_dim 4 fails both kernel gates: the CPU runner takes the gather
    # path as the JAX package does, a CUDA runner refuses to
    model = Llama(LlamaConfig(**{**SIZES, "hidden_size": 8}), device="cpu")
    runner = LlamaRunner(model, block_size=8, attn_impl=attn_impl)
    assert runner._attn_impl_for(1) == runner._attn_impl_for(8) \
        == "reference"
    runner.device = torch.device("cuda")
    for bucket in (1, 8):
        with pytest.raises(ValueError, match="head_dim 4"):
            runner._attn_impl_for(bucket)
    asked = LlamaRunner(model, block_size=8, attn_impl="reference")
    asked.device = torch.device("cuda")
    assert asked._attn_impl_for(1) == "reference"


# ------------------------------------------------------ unported knobs


def _other(default):
    if isinstance(default, bool):
        return not default
    if isinstance(default, int):
        return default + 2
    if isinstance(default, str):
        return default + "-other"
    return object()


@pytest.fixture(scope="module")
def model():
    return Llama(LlamaConfig(**SIZES), device="cpu")


def _engine(model, **kw):
    return create_serving_engine(model, device="cpu", block_size=8,
                                 max_model_len=32, num_blocks=8, **kw)


@pytest.mark.parametrize("knob", sorted(UNPORTED_KNOBS))
def test_unported_engine_knob_raises(model, knob):
    default, item = UNPORTED_KNOBS[knob]
    _engine(model, **{knob: default})            # the default is accepted
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _engine(model, **{knob: _other(default)})


@pytest.mark.parametrize("knob", ["num_speculative_tokens", "spec_max_ngram",
                                  "spec_adaptive_k"])
def test_speculation_knobs_name_item_7_part_b(model, knob):
    with pytest.raises(NotImplementedError, match="item 7 part B"):
        _engine(model, **{knob: _other(UNPORTED_KNOBS[knob][0])})


def _serve(eng, prompts, sp):
    ids = [eng.add_request(p, sp) for p in prompts]
    outs = eng.run()
    assert eng.pool.allocator.check_no_leaks()
    return [outs[i].output_tokens for i in ids]


PROMPTS = ([1, 2, 3], [4, 5, 6, 7, 8], [9, 10])


@pytest.mark.parametrize("knob,value", [
    ("decode_horizon", 4), ("pipelined", True), ("horizon_sampling", True),
    ("horizon_early_stop", True)])
def test_horizon_and_pipeline_knobs_are_served(model, knob, value):
    sp = SamplingParams(max_tokens=6)
    extra = {} if knob == "decode_horizon" else {"decode_horizon": 4}
    eng = _engine(model, max_batch_size=3, **{knob: value}, **extra)
    assert getattr(eng, knob) == value
    assert _serve(eng, PROMPTS, sp) == _serve(
        _engine(model, max_batch_size=3), PROMPTS, sp)


def test_sampled_decoding_is_served(model):
    sp = SamplingParams(max_tokens=6, temperature=0.8, seed=1, top_k=20)
    eng = _engine(model)
    got = _serve(eng, PROMPTS[:1], sp)[0]
    assert got == naive_generate(eng.runner, PROMPTS[0], sp,
                                 max_model_len=32)


@pytest.mark.parametrize("kw", [
    # int8 / fp8 KV pools are served; quantized weights beside them are not
    dict(kv_dtype="int8", weight_dtype="int8"),
    dict(kv_dtype="fp8", weight_dtype="fp8"), dict(weight_dtype="int4"),
    dict(mesh=object()), dict(dtype="bfloat16"), dict(comm_dtype="int8"),
], ids=lambda kw: next(iter(kw)) + "=" + str(next(iter(kw.values())))[:8])
def test_unported_bridge_options_raise(model, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _engine(model, **kw)


def test_unported_model_and_pool_options_raise(model):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        create_engine(model, device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Llama(LlamaConfig(tensor_parallel=True, **SIZES), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        KVCachePool(1, 4, 4, 1, 8, dtype=torch.bfloat16, device="cpu")
    # bf16 AMP is ported; the fp16 one still raises, naming its item
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TrainStep(model, llama_loss_fn, AdamW(parameters=model.parameters()),
                  amp_level="O1", amp_dtype="float16")


def test_unknown_knob_is_a_type_error(model):
    with pytest.raises(TypeError, match="no_such_knob"):
        _engine(model, no_such_knob=1)


# ------------------------------------------- the JAX entry signatures

# block_size, max_model_len, attn_impl and kv_dtype by position (the fifth
# positional is kv_dtype in both packages), the rest by keyword
RUNNER_ARGS = (8, 32, "auto", "int8")
RUNNER_KW = dict(weight_dtype="fp32", weight_group_size=128)


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(dropout=0.0, **SIZES))
    jm.eval()
    return jm


def _positional_names(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]


def _runner_fields(runner):
    return (runner.block_size, runner.max_model_len, runner.attn_impl,
            runner.kv_dtype, runner.weight_group_size)


@pytest.mark.parametrize("entry", ["LlamaRunner", "runner_for"])
def test_runner_entry_points_take_the_jax_arguments(model, jax_model,
                                                    entry):
    jax_fn, port_fn = {"LlamaRunner": (JaxLlamaRunner, LlamaRunner),
                       "runner_for": (jax_runner_for, runner_for)}[entry]
    assert _positional_names(port_fn) == _positional_names(jax_fn)
    assert inspect.signature(port_fn).parameters["device"].kind \
        is inspect.Parameter.KEYWORD_ONLY
    jr = jax_fn(jax_model, *RUNNER_ARGS, **RUNNER_KW)
    pr = port_fn(model, *RUNNER_ARGS, **RUNNER_KW)
    assert _runner_fields(pr) == _runner_fields(jr) \
        == (8, 32, "auto", "int8", 128)
    assert type(pr).__name__ == type(jr).__name__ == "LlamaRunner"


def test_create_serving_engine_takes_the_jax_arguments(model, jax_model):
    kw = dict(block_size=8, max_model_len=32, kv_dtype="int8",
              weight_group_size=128, num_blocks=8)
    jeng = jax_create_serving_engine(jax_model, **kw)
    peng = create_serving_engine(model, device="cpu", **kw)
    assert _runner_fields(peng.runner) == _runner_fields(jeng.runner)
    assert peng.pool.kv_dtype == jeng.pool.kv_dtype == "int8"


@pytest.mark.parametrize("entry", ["LlamaRunner", "runner_for",
                                   "create_serving_engine"])
def test_other_weight_group_sizes_raise_naming_item_8(model, entry):
    build = {"LlamaRunner": LlamaRunner, "runner_for": runner_for,
             "create_serving_engine": _engine}[entry]
    with pytest.raises(NotImplementedError, match="item 8"):
        build(model, weight_group_size=64)


def test_session_id_raises_naming_item_11(model):
    eng = _engine(model)
    with pytest.raises(NotImplementedError, match="item 11"):
        eng.add_request([1, 2], SamplingParams(session_id="s"))
    rid = eng.add_request([1, 2], SamplingParams(max_tokens=3,
                                                 session_id=None))
    assert len(eng.run()[rid].output_tokens) == 3


def test_naive_generate_fallback_seed_is_read_on_sampled_paths_only(model):
    runner = LlamaRunner(model, 8, 32)
    greedy = SamplingParams(max_tokens=8)
    assert naive_generate(runner, [1, 2], greedy, fallback_seed=1) \
        == naive_generate(runner, [1, 2], greedy)
    sampled = SamplingParams(max_tokens=8, temperature=1.5)
    streams = {tuple(naive_generate(runner, [1, 2], sampled,
                                    fallback_seed=seed)) for seed in range(4)}
    assert len(streams) > 1
    seeded = SamplingParams(max_tokens=8, temperature=1.5, seed=7)
    assert naive_generate(runner, [1, 2], seeded, fallback_seed=1) \
        == naive_generate(runner, [1, 2], seeded, fallback_seed=2)


def test_sampling_params_fields_follow_the_jax_order():
    assert [f.name for f in dataclasses.fields(SamplingParams)] == \
        [f.name for f in dataclasses.fields(JaxSamplingParams)]
    # kv_dtype is the ninth positional argument in both packages
    args = (4, 0.0, None, None, None, (), None, None, "fp8")
    for sp in (SamplingParams(*args), JaxSamplingParams(*args)):
        assert (sp.kv_dtype, sp.session_id) == ("fp8", None)


def test_kv_cache_pool_takes_the_jax_arguments():
    assert _positional_names(KVCachePool) == \
        _positional_names(JaxKVCachePool)
    assert inspect.signature(KVCachePool).parameters["device"].kind \
        is inspect.Parameter.KEYWORD_ONLY
    # (…, dtype, mesh, model_axis, kv_dtype) by position
    ours = KVCachePool(1, 4, 4, 1, 8, torch.float32, None, "model", "int8",
                       device="cpu")
    ref = JaxKVCachePool(1, 4, 4, 1, 8, jnp.float32, None, "model", "int8")
    assert (ours.kv_dtype, ours.mesh, ours.model_axis) == \
        (ref.kv_dtype, ref.mesh, ref.model_axis) == ("int8", None, "model")
    assert len(ours.pools[0]) == len(ref.pools[0]) == 4
    with pytest.raises(NotImplementedError, match="item 10"):
        KVCachePool(1, 4, 4, 1, 8, mesh=object(), device="cpu")


def _attend_args(pool):
    """paged_attend's operands for one decode token of one sequence."""
    q, k_new, v_new = (torch.ones(1, 1, 1, 8) for _ in range(3))
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    one = torch.tensor([[1]]), torch.tensor([[0]])
    pos = torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    return (q, k_new, v_new, pool.pools[0], tables, *one, *pos, 1,
            "reference")


@pytest.mark.parametrize("entry,param,other,item", [
    ("FCFSScheduler", "count_host_headroom", True, "item 9"),
    ("SequenceKV", "kv_tag", "fp8", "item 8"),
    ("paged_attend", "shard_ctx", (object(), "model"), "item 10"),
])
def test_unported_jax_parameters_take_their_default_only(entry, param,
                                                         other, item):
    port_fn, jax_fn = {
        "FCFSScheduler": (FCFSScheduler, JaxFCFSScheduler),
        "SequenceKV": (SequenceKV, JaxSequenceKV),
        "paged_attend": (paged_attend, jax_paged_attend)}[entry]
    assert _positional_names(port_fn) == _positional_names(jax_fn)
    assert inspect.signature(port_fn).parameters[param].default \
        == inspect.signature(jax_fn).parameters[param].default
    pool = KVCachePool(1, 4, 4, 1, 8, device="cpu")
    call = {"FCFSScheduler": lambda **kw: FCFSScheduler(pool, 1, 2, **kw),
            "SequenceKV": lambda **kw: SequenceKV(pool, **kw),
            "paged_attend": lambda **kw: paged_attend(*_attend_args(pool),
                                                      **kw)}[entry]
    default = inspect.signature(port_fn).parameters[param].default
    call(**{param: default})
    with pytest.raises(NotImplementedError, match=item):
        call(**{param: other})


def test_rotary_embedding_takes_position_ids_as_jax_does():
    rng = np.random.default_rng(11)
    q, k = (rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
            for _ in range(2))
    cos, sin = (rng.standard_normal((12, 8)).astype(np.float32)
                for _ in range(2))
    ids = rng.integers(0, 12, (2, 5))
    ours = impl.rotary_embedding(*map(torch.from_numpy, (q, k, cos, sin)),
                                 position_ids=torch.from_numpy(ids))
    ref = jax_impl.rotary_embedding(*map(jnp.asarray, (q, k, cos, sin)),
                                    position_ids=jnp.asarray(ids))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------- faults F5-F8, repaired


def test_request_fields_follow_the_jax_order():
    """F5: the JAX host-tier and prefix fields sit before admission_index,
    so the 12th positional argument is `offload` in both packages."""
    assert [f.name for f in dataclasses.fields(Request)] == \
        [f.name for f in dataclasses.fields(JaxRequest)]
    args = ([1, 2], SamplingParams(), "r", 5, RequestState.WAITING, [],
            None, None, None, "prefill", False, None)
    req = Request(*args)
    assert (req.offload, req.pending_pagein, req.admit_prefix_tokens,
            req.admit_pagein_tokens, req.admission_index) == \
        (None, [], 0, 0, -1)


@pytest.mark.parametrize("field,value,item", [
    ("offload", object(), "item 9"), ("pending_pagein", [(1, 2)], "item 9"),
    ("admit_prefix_tokens", 3, "item 5"), ("admit_pagein_tokens", 3,
                                           "item 9")])
def test_request_host_tier_and_prefix_fields_take_their_defaults_only(
        field, value, item):
    with pytest.raises(NotImplementedError, match=item):
        Request([1, 2], **{field: value})


@pytest.mark.parametrize("param", ["learning_rate", "parameters",
                                   "weight_decay", "grad_clip", "name"])
def test_optimizer_takes_the_jax_base_signature(param):
    """F6: the JAX base's parameters, in its order, with its defaults;
    multi_precision only by keyword after them."""
    ours = inspect.signature(Optimizer).parameters
    ref = inspect.signature(JaxOptimizer).parameters
    assert _positional_names(Optimizer) == _positional_names(JaxOptimizer)
    assert ours[param].default == ref[param].default
    assert ours["multi_precision"].kind is inspect.Parameter.KEYWORD_ONLY
    opt = Optimizer(0.1, [torch.zeros(2)], None, None, "opt")
    assert opt.get_lr() == 0.1 and opt._weight_decay == 0.0


# the kernel wrappers and their ops.pallas.* twins
WRAPPERS = {"ragged_paged_attention": (k1.ragged_paged_attention,
                                       jk1.ragged_paged_attention),
            "paged_decode_attention": (k2.paged_decode_attention,
                                       jk2.paged_decode_attention),
            "flash_attention": (fa.flash_attention, jfa.flash_attention)}


def _shared_functions():
    """(id, port function, JAX function) of every public function an
    `ops.*` kernel module shares by name with its `ops.pallas.*` twin."""
    out = []
    for label, ours, ref in (("flash_attention", fa, jfa),
                             ("ragged_paged_attention", k1, jk1),
                             ("paged_attention", k2, jk2)):
        for n in sorted(dir(ours)):
            a, b = getattr(ours, n), getattr(ref, n, None)
            if not n.startswith("_") and inspect.isfunction(a) \
                    and inspect.isfunction(b):
                out.append((f"{label}.{n}", a, b))
    return out


SHARED = _shared_functions()


@pytest.mark.parametrize("name,ours,ref", SHARED, ids=[s[0] for s in SHARED])
def test_wrappers_take_the_pallas_positional_parameters(name, ours, ref):
    assert len(SHARED) >= 8
    assert _positional_names(ours) == _positional_names(ref)
    for p in inspect.signature(ref).parameters.values():
        if p.default is not inspect.Parameter.empty:
            assert inspect.signature(ours).parameters[p.name].default \
                == p.default, p.name


@pytest.mark.parametrize("name,param", [
    ("ragged_paged_attention", "interpret"),
    ("paged_decode_attention", "interpret"),
    ("flash_attention", "interpret"), ("flash_attention", "block_q"),
    ("flash_attention", "block_k")])
def test_jax_wrapper_parameters_sit_in_their_jax_slot(name, param):
    """F7: each parameter at the JAX position, so a positional call binds
    it (ragged_paged_attention's k_scale no longer sits where JAX has
    interpret)."""
    ours, ref = WRAPPERS[name]
    assert _positional_names(ours).index(param) == \
        _positional_names(ref).index(param)


def test_interpret_runs_the_plain_version_on_the_cpu_only():
    q = torch.randn(2, 4, 8)
    pool = torch.randn(4, 4, 4, 8)
    table = torch.arange(4, dtype=torch.int32).reshape(2, 2)
    pos = torch.tensor([3, 6], dtype=torch.int32)
    out = k2.paged_decode_attention(q, pool, pool, table, pos, None, True)
    assert torch.equal(out, k2.paged_decode_attention(q, pool, pool, table,
                                                      pos))
    # what the wrappers read of a CUDA operand: its device
    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="interpret mode"):
        _build.refuse_interpret("paged_decode_attention", True, cuda)
    _build.refuse_interpret("paged_decode_attention", False, cuda)


def test_block_mask_on_a_64_grid_equals_jax():
    """F7: flash_attention(..., block_mask, 64, 64) reads the mask at
    64 x 64 blocks, as the JAX kernel does (interpret mode)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, 256, 2, 16)).astype(np.float32)
               for _ in range(3))
    bm = np.ones((4, 4), np.int32)
    bm[0, 1] = bm[2, 0] = bm[3, 3] = 0
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              False, None, None, None, bm, 64, 64, True)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), False, None, None, None,
                             bm, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    default = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), False, None, None,
                                 None, np.ones((2, 2), np.int32))
    assert not np.allclose(got.numpy(), default.numpy())
    with pytest.raises(ValueError, match="tile grid"):
        fa.flash_attention(torch.from_numpy(q), torch.from_numpy(q),
                           torch.from_numpy(q), False, block_mask=bm)


@pytest.mark.parametrize("case", ["uniform_64", "coarse_256", "mixed_64"])
def test_block_mask_on_another_grid_is_restated_where_it_can_be(case):
    """A block mask whose every 128-block is all live or all dead is
    restated on the kernels' 128-grid (no dense mask); one that is not
    becomes the dense additive mask. Either way the output equals the
    JAX kernel's at that grid (interpret mode), within 1e-5."""
    rng = np.random.default_rng(7)
    s, blk = {"uniform_64": (256, 64), "coarse_256": (512, 256),
              "mixed_64": (256, 64)}[case]
    q, k, v = (rng.standard_normal((1, s, 2, 16)).astype(np.float32)
               for _ in range(3))
    if case == "uniform_64":
        bm = np.kron(np.asarray([[1, 0], [1, 1]], np.int32),
                     np.ones((2, 2), np.int32))
    elif case == "coarse_256":
        bm = np.asarray([[1, 0], [1, 1]], np.int32)
    else:
        bm = np.ones((4, 4), np.int32)
        bm[0, 1] = 0
    t = torch.from_numpy
    m = fa.canonical_masks(t(q), t(k), t(v), False, block_mask=bm,
                           block_q=blk, block_k=blk)
    if case == "mixed_64":
        assert m.block_mask is None and tuple(m.mask.shape) == (1, 1, s, s)
    else:
        assert m.mask is None and tuple(m.block_mask.shape) == (s // 128,
                                                                s // 128)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              False, None, None, None, bm, blk, blk, True)
    got = fa.flash_attention(t(q), t(k), t(v), False, None, None, None, bm,
                             blk, blk)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pos", [7, "0-d"], ids=["int", "0-d"])
def test_paged_decode_takes_a_scalar_pos(pos):
    """F8: a scalar pos broadcasts to every sequence, equal to the [b]
    pos and to the JAX kernel in interpret mode."""
    rng = np.random.default_rng(6)
    b, h, d, bs = 3, 2, 16, 4
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp, vp = (rng.standard_normal((b * 3, bs, h, d)).astype(np.float32)
              for _ in range(2))
    table = np.arange(b * 3, dtype=np.int32).reshape(b, 3)
    scalar = torch.tensor(7) if pos == "0-d" else 7
    t = torch.from_numpy
    got = k2.paged_decode_attention(t(q), t(kp), t(vp), t(table), scalar)
    per_seq = k2.paged_decode_attention(t(q), t(kp), t(vp), t(table),
                                        torch.full((b,), 7,
                                                   dtype=torch.int32))
    assert torch.equal(got, per_seq)
    ref = jk2.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(table), 7,
                                     interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------- chip_smoke


def _run_smoke(cwd, **env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin", **env})


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(REPO, CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
