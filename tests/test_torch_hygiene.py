"""The port's boundaries: what it imports, where it runs, which path each
kernel wrapper takes, and what it refuses.

  * nothing in paddle_tpu_torch/ (amp/ included) or chip_smoke.py imports
    jax or the JAX package (an AST scan, so a lazy import inside a
    function counts too), nor yaml (the card's machine has none); the
    port's AMP lists equal the JAX lists; the port's ops.yaml, read by
    its own parser, equals the JAX table entry by entry;
  * entry points default to "cuda" and raise where no card is usable;
  * CPU tensors run the plain versions: `plain_launches` moves and
    `kernel_launches` never does;
  * every engine knob of the JAX engine is carried: the host-wide
    store's (item 11 part B2: kv_store, kv_store_owner), the host tier's
    and the detokenizer's (items 9 and 15), the disaggregated role and
    session ids (item 11 part A), the four
    horizon and pipeline knobs, the prefix cache, fused ragged steps,
    speculation and temperature > 0 are served; every knob of the process
    tier has its JAX default; the process backend's (item 11 part B1: the
    backend, the RPC timeouts and retries, the child environment) and the
    host-wide store's (part B2: `shared_kv_*`, `HostKVTier(store=)`,
    `spill_pages(publish=)`) are live, and
    `create_serving_router(mesh= | meshes=)` puts replicas on meshes
    (item 10);
  * the serving entry points take the JAX package's positional and
    keyword arguments (runner, runner_for, create_serving_engine,
    SamplingParams, naive_generate, KVCachePool), `device` only by
    keyword; paged_attend's shard_ctx (item 10, ported) takes a shard's
    call, FCFSScheduler's count_host_headroom and SequenceKV's kv_tag (ported)
    act as the JAX ones do; rotary_embedding takes position_ids as the
    JAX op does;
  * the faults F5-F11 stay repaired: `Request` has the JAX fields in the
    JAX order and takes the host-tier ones as the JAX Request does (F5); `Optimizer` takes the JAX base's signature (F6); the kernel
    wrappers take the JAX `interpret` (and `block_q` / `block_k` for
    flash_attention) in their JAX slots, every `ops.*` wrapper's positional
    parameters are its `ops.pallas.*` twin's, and a 64-block block mask
    equals the JAX one on the CPU (F7); `paged_decode_attention` takes a
    scalar `pos` (F8); `serving.create_engine` takes the JAX parameters
    in the JAX order, each at its JAX default, and `comm_dtype` other than
    "fp32" without a mesh raises ValueError as JAX does (F9); `GPTBlock`
    takes (cfg, use_moe=False) (F10) and `RMSNorm` (hidden, eps=1e-6)
    (F11), `device` (and `gen`) keyword-only after them; float16 serving
    (item 21's serving half, ported) builds an fp16 engine over fp16
    pools;
  * the faults F12-F15 stay repaired: a name a JAX package exports and
    the port defines imports from the port's package of the same path
    (F12: the draft proposers, `quantized_page_write`, `GPTBlock`);
    `get_flags` and `flags_version` follow JAX's (F13); the engine
    snapshot has the JAX keys, the six `tp_*` ones included, and
    `overlapped_plan_seconds` and `device_idle_fraction` are set as JAX
    sets them on a scripted clock (F14); `create_serving_engine` refuses
    `comm_dtype` without a mesh with a ValueError, as JAX does (F15);
  * chip_smoke.py fails, and prints no result, without a card or outside
    a checkout.
"""

import ast
import dataclasses
import importlib
import inspect
import itertools
import pkgutil
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
    OffloadRecord, SamplingParams, create_engine, naive_generate,
    serving_mesh,
)
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


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_no_yaml(path):
    """The card's machine has no PyYAML: the port reads its ops.yaml with
    a parser of its own."""
    bad = [m for m in _imported_modules(path) if m.split(".")[0] == "yaml"]
    assert not bad, f"{path.name} imports {bad}"


def test_the_op_table_equals_the_jax_table():
    """ops/ops.yaml as the port's parser reads it equals yaml.safe_load of
    the JAX package's, entry by entry and field by field."""
    import yaml

    from paddle_tpu_torch.ops import registry

    fields = ("name", "diff", "dynamic", "rng", "method", "inplace")
    defaults = {"diff": True, "dynamic": False, "rng": False,
                "method": True, "inplace": None}

    def norm(entries):
        return [tuple(e.get(f, defaults.get(f)) for f in fields)
                for e in entries]

    jax_path = Path(paddle.__file__).parent / "ops" / "ops.yaml"
    ours_path = Path(paddle_tpu_torch.__file__).parent / "ops" / "ops.yaml"
    ref = yaml.safe_load(jax_path.read_text())["ops"]
    ours = registry.parse_table(ours_path.read_text())
    assert norm(ours) == norm(ref) and len(ref) == 383
    assert all(set(e) <= set(fields) for e in ours)
    # the JAX OPS also holds ops other JAX modules register at import
    jax_ops = __import__("paddle_tpu.ops.registry", fromlist=["OPS"]).OPS
    assert set(registry.OPS) == {e["name"] for e in ref} | {"_getitem"}
    for name, op in registry.OPS.items():
        ref_op = jax_ops[name]
        assert (op.diff, op.dynamic, op.rng, op.method, op.inplace) == (
            ref_op.diff, ref_op.dynamic, ref_op.rng, ref_op.method,
            ref_op.inplace), name


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


@pytest.fixture(scope="module")
def model():
    return Llama(LlamaConfig(**SIZES), device="cpu")


@pytest.fixture(scope="module")
def twin():
    """A JAX Llama and the port's on the same numpy weights."""
    from paddle_tpu.jit.functionalize import functionalize
    from paddle_tpu_torch.weights import load_params
    paddle.seed(0)
    jm = JaxLlama(JaxLlamaConfig(dropout=0.0, **SIZES))
    jm.eval()
    pm = Llama(LlamaConfig(**SIZES), device="cpu")
    load_params(pm, {k: np.asarray(v) for k, v in
                     functionalize(jm).param_values().items()})
    return jm, pm


def _engine(model, **kw):
    return create_serving_engine(model, device="cpu", block_size=8,
                                 max_model_len=32, num_blocks=8, **kw)


# the JAX engine's knobs of the host tier (item 9), the detokenizer (item
# 15) and the disaggregated role (item 11 part A), refused until they were
# ported: a value other than the default is now served ("decode" is a
# routing designation, an engine that prefills and decodes)
HOST_TIER_AND_DETOKENIZER_KNOBS = {
    "host_tier_pages": 8, "host_tier_headroom": True, "pagein_prefetch": 4,
    "spill_async": True, "tokenizer": types.SimpleNamespace(
        id_to_bytes=lambda tok: bytes([65 + tok % 26])), "role": "decode"}


# the host-wide store's knobs (item 11 part B2), refused until it was ported
STORE_KNOBS = ("kv_store", "kv_store_owner")


@pytest.mark.parametrize("knob", sorted(set(STORE_KNOBS)
                                        | set(HOST_TIER_AND_DETOKENIZER_KNOBS)))
def test_unported_engine_knob_raises(model, knob):
    """No engine knob is left unported: those of items 9, 15, 11 part A and
    11 part B2 (the host-wide store) are served at the JAX default and at
    another value, token for token; the store's knobs have the JAX
    defaults."""
    if knob in STORE_KNOBS:
        from paddle_tpu.serving import ServingEngine as JaxServingEngine
        from paddle_tpu_torch.serving import ServingEngine
        from paddle_tpu_torch.serving.kv_cache import SharedKVStore
        assert inspect.signature(ServingEngine).parameters[knob].default \
            == inspect.signature(JaxServingEngine).parameters[knob].default
        sp = SamplingParams(max_tokens=6)
        plain = _engine(model, max_batch_size=3)
        store = SharedKVStore.for_runner(plain.runner, 16)
        eng = _engine(model, max_batch_size=3, kv_store=store,
                      kv_store_owner="r0" if knob == "kv_store_owner"
                      else None)
        assert eng.kv_store is store and eng.pool.host_tier.store is store
        assert eng.kv_store_owner == ("r0" if knob == "kv_store_owner"
                                      else f"eng-{id(eng):x}")
        assert _serve(eng, PROMPTS, sp) == _serve(plain, PROMPTS, sp)
        return
    if knob in HOST_TIER_AND_DETOKENIZER_KNOBS:
        value = HOST_TIER_AND_DETOKENIZER_KNOBS[knob]
        extra = ({"host_tier_pages": 8} if knob in ("host_tier_headroom",
                                                    "pagein_prefetch",
                                                    "spill_async") else {})
        sp = SamplingParams(max_tokens=6)
        eng = _engine(model, max_batch_size=3, **{knob: value}, **extra)
        assert getattr(eng, knob) == value
        assert _serve(eng, PROMPTS, sp) == _serve(
            _engine(model, max_batch_size=3), PROMPTS, sp)
        return
    raise AssertionError(f"{knob}: no such knob")   # pragma: no cover


def _serve(eng, prompts, sp):
    ids = [eng.add_request(p, sp) for p in prompts]
    outs = eng.run()
    assert eng.pool.allocator.check_no_leaks()
    return [outs[i].output_tokens for i in ids]


PROMPTS = ([1, 2, 3], [4, 5, 6, 7, 8], [9, 10])

# a tensor-parallel mesh of two shards on the CPU
CPU_MESH2 = serving_mesh(1, 2, devices=["cpu"] * 2)


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
    dict(kv_dtype="int8", weight_dtype="int8"),
    dict(kv_dtype="fp8", weight_dtype="fp8"), dict(weight_dtype="int4"),
    dict(mesh=CPU_MESH2), dict(dtype="bfloat16"), dict(comm_dtype="int8"),
], ids=["kv_dtype=int8", "kv_dtype=fp8", "weight_dtype=int4",
        "mesh=<object ", "dtype=bfloat16", "comm_dtype=int8"])
def test_unported_bridge_options_raise(twin, kw):
    """Every bridge option is ported: a mesh (item 10) serves a
    tensor-parallel engine, with a quantized collective too; a quantized
    collective without a mesh is an error of the call (ValueError, as in
    JAX: F15); quantized KV beside quantized weights, int4 weights and
    dtype="bfloat16" serve. Each token for token as its naive_generate
    and as the JAX bridge on the same weights (over a JAX mesh of the same
    shape)."""
    jm, pm = twin
    if next(iter(kw)) == "comm_dtype":
        with pytest.raises(ValueError, match="mesh"):
            _engine(pm, **kw)
        kw = dict(kw, mesh=CPU_MESH2)
    sp = SamplingParams(max_tokens=4)
    eng = _engine(pm, **kw)
    if "mesh" in kw:
        assert eng.runner.tp_size == eng.pool.tp_size == 2
    got = _serve(eng, PROMPTS, sp)
    assert got == [naive_generate(eng.runner, p, sp) for p in PROMPTS]
    if "mesh" in kw:
        from paddle_tpu.parallel.mesh import serving_mesh as jax_mesh
        kw = dict(kw, mesh=jax_mesh(data=1, model=2))
    jeng = jax_create_serving_engine(jm, block_size=8, max_model_len=32,
                                     num_blocks=8, **kw)
    ids = [jeng.add_request(p, JaxSamplingParams(max_tokens=4))
           for p in PROMPTS]
    outs = jeng.run()
    assert got == [outs[i].output_tokens for i in ids]


def test_unported_model_and_pool_options_raise(model):
    # a mesh shards the serving runner (item 10, ported); the model's own
    # tensor-parallel layers are item 13's
    assert create_engine(model, device="cpu", mesh=CPU_MESH2,
                         num_blocks=8).pool.tp_size == 2
    with pytest.raises(NotImplementedError, match="item 13"):
        Llama(LlamaConfig(tensor_parallel=True, **SIZES), device="cpu")
    # bf16 and fp16 pools are ported (a bf16 or fp16 runner's, item 21's
    # serving half)
    assert KVCachePool(1, 4, 4, 1, 8, dtype=torch.bfloat16,
                       device="cpu").pools[0][0].dtype == torch.bfloat16
    pool = KVCachePool(1, 4, 4, 1, 8, dtype=torch.float16, device="cpu")
    assert pool.pools[0][0].dtype == pool.pools[0][1].dtype == torch.float16
    # bf16 and fp16 AMP train; another AMP dtype is an error of the call
    opt = AdamW(parameters=model.parameters())
    assert TrainStep(model, llama_loss_fn, opt, amp_level="O1",
                     amp_dtype="float16").amp_level == "O1"
    with pytest.raises(ValueError, match="amp_dtype"):
        TrainStep(model, llama_loss_fn, opt, amp_level="O1",
                  amp_dtype="float32")


# the JAX router's knobs of the process tier (item 11 part B), each with a
# value other than its JAX default
PROCESS_TIER_KNOBS = {
    "backend": "process", "shared_kv_pages": 8, "shared_kv_shm": True,
    "shared_kv_geometry": {"num_layers": 1}, "rendezvous_timeout_s": 5.0,
    "command_timeout_s": 5.0, "rpc_fast_timeout_s": 1.0,
    "rpc_max_retries": 5, "child_env": {"A": "1"}}
# those of the host-wide store (part B2)
SHARED_KV_KNOBS = ("shared_kv_pages", "shared_kv_shm", "shared_kv_geometry")


@pytest.mark.parametrize("knob", sorted(PROCESS_TIER_KNOBS))
def test_process_tier_router_knob_raises_naming_item_11(model, knob):
    """Each process-tier knob of the JAX ServingRouter has the JAX default
    in the port's signature and is accepted there. At another value the
    host-wide store's knobs (part B2) are live: with shared_kv_pages the
    thread tier builds one store of that many pages over the first
    runner's geometry (shared memory with shared_kv_shm=True; a geometry
    is the process backend's and the thread tier reads none, as in JAX);
    the process backend's (part B1) are live too: backend="process" through the
    model bridge raises TypeError as the JAX bridge does (a callable
    factory cannot cross a process boundary; the JSON spec serves it, see
    tests/test_torch_procs.py), and the timeouts, retries and child
    environment are taken on the thread backend, which reads none of them,
    as in JAX."""
    from paddle_tpu.serving import ServingRouter as JaxServingRouter
    from paddle_tpu_torch.inference import create_serving_router
    from paddle_tpu_torch.serving import ServingRouter
    default = inspect.signature(ServingRouter).parameters[knob].default
    assert default == \
        inspect.signature(JaxServingRouter).parameters[knob].default
    kw = dict(replicas=1, supervise=False, block_size=8, max_model_len=32,
              num_blocks=8, device="cpu")
    create_serving_router(model, **kw, **{knob: default}).shutdown()
    other = {knob: PROCESS_TIER_KNOBS[knob]}
    if knob in SHARED_KV_KNOBS:
        other.setdefault("shared_kv_pages", 8)
        router = create_serving_router(model, **kw, **other)
        try:
            store = router.kv_store
            assert store.max_pages == 8
            assert store.use_shm == (knob == "shared_kv_shm")
            assert router._replicas[0].engine.pool.host_tier.store is store
        finally:
            router.shutdown()
    elif knob == "backend":
        with pytest.raises(TypeError, match="JSON spec"):
            create_serving_router(model, **kw, **other)
    else:
        router = create_serving_router(model, **kw, **other)
        assert router.backend == "thread"
        router.shutdown()


def test_process_tier_store_parameters_raise_naming_item_11():
    """HostKVTier(store=) and spill_pages(publish=) (the host-wide store,
    item 11 part B2) have the JAX defaults and are live: a store-backed
    tier publishes a spilled page under its chain hash (a private tier,
    which keeps its own index, refuses a publication with ValueError);
    mesh= and meshes= of create_serving_router (item 10) put the replicas
    on meshes, too few meshes a ValueError as in JAX."""
    from paddle_tpu_torch.serving.kv_cache import SharedKVStore
    from paddle_tpu.serving.kv_cache import HostKVTier as JaxHostKVTier
    from paddle_tpu_torch.inference import create_serving_router
    from paddle_tpu_torch.serving import HostKVTier
    for fn, jfn, name in ((HostKVTier, JaxHostKVTier, "store"),
                          (HostKVTier.spill_pages, JaxHostKVTier.spill_pages,
                           "publish")):
        assert inspect.signature(fn).parameters[name].default == \
            inspect.signature(jfn).parameters[name].default
    pool = KVCachePool(1, 4, 4, 1, 8, device="cpu")
    tier = pool.enable_host_tier(2)
    assert tier.spill_pages([], publish=()) == []
    with pytest.raises(ValueError, match="store-backed"):
        tier.spill_pages([1], publish=[(0, 7)])
    store = SharedKVStore(SharedKVStore.layout_for(1, 4, 1, 8), 2)
    stier = HostKVTier(pool, 2, store=store, owner="e0")
    slots = stier.spill_pages([1], publish=[(0, 7)])
    assert store.has_prefix(7) and store.refcount(slots[0]) == 2
    assert store.slot_hash(slots[0]) == store.content_hash(slots[0])
    m = Llama(LlamaConfig(**SIZES), device="cpu")
    for kw in ({"mesh": CPU_MESH2}, {"meshes": [CPU_MESH2] * 2}):
        router = create_serving_router(m, device="cpu", num_blocks=8, **kw)
        try:
            assert [r.runner.tp_size for r in router._replicas] == [2, 2]
        finally:
            router.shutdown()
    with pytest.raises(ValueError, match="meshes for 2 replicas"):
        create_serving_router(m, device="cpu", meshes=[CPU_MESH2])


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
def test_other_weight_group_sizes_raise_naming_item_8(twin, entry):
    """Other weight_group_size values are ported (the weight ladder, item
    8): an int4 runner groups its scales by it, as the JAX runner does;
    a size below 1 is a ValueError in both packages."""
    jm, pm = twin
    build = {"LlamaRunner": LlamaRunner, "runner_for": runner_for,
             "create_serving_engine": _engine}[entry]
    made = build(pm, weight_dtype="int4", weight_group_size=16,
                 **({} if entry == "create_serving_engine"
                    else {"device": "cpu"}))
    runner = getattr(made, "runner", made)
    jr = JaxLlamaRunner(jm, 8, 32, weight_dtype="int4", weight_group_size=16)
    assert runner.weight_group_size == jr.weight_group_size == 16
    for name in jr._quantized_names:
        scale = name + "::scale"
        assert tuple(runner.params[scale].shape) == \
            tuple(jr.params[scale].shape)
        np.testing.assert_array_equal(runner.params[name].numpy(),
                                      np.asarray(jr.params[name]))
    with pytest.raises(ValueError, match="weight_group_size"):
        build(pm, weight_group_size=0,
              **({} if entry == "create_serving_engine"
                 else {"device": "cpu"}))


def test_session_id_raises_naming_item_11(model):
    """A session id is served since item 11 part A (the tier routes on it,
    one engine ignores it: same tokens as without), and since part B2 over
    the host-wide store a session's pages live in across replicas: an
    engine over a store serves the same tokens, and a store of another
    page geometry is refused loudly."""
    eng = _engine(model)
    with_sid = eng.add_request([1, 2], SamplingParams(max_tokens=3,
                                                      session_id="s"))
    without = eng.add_request([1, 2], SamplingParams(max_tokens=3,
                                                     session_id=None))
    outs = eng.run()
    assert outs[with_sid].output_tokens == outs[without].output_tokens
    assert len(outs[with_sid].output_tokens) == 3
    from paddle_tpu_torch.serving.kv_cache import SharedKVStore
    store = SharedKVStore.for_runner(eng.runner, 16)
    over = _engine(model, kv_store=store)
    sid = over.add_request([1, 2], SamplingParams(max_tokens=3,
                                                  session_id="s"))
    assert over.run()[sid].output_tokens == outs[with_sid].output_tokens
    with pytest.raises(ValueError, match="layout mismatch"):
        _engine(model, kv_store=SharedKVStore(
            SharedKVStore.layout_for(1, 4, 1, 16), 4))


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
    # a mesh splits the pools on the kv-head axis (item 10, ported)
    from paddle_tpu.parallel.mesh import serving_mesh as jax_mesh
    ours = KVCachePool(1, 4, 4, 2, 8, torch.float32, CPU_MESH2, "model",
                       "int8", device="cpu")
    ref = JaxKVCachePool(1, 4, 4, 2, 8, jnp.float32, jax_mesh(1, 2),
                         "model", "int8")
    assert ours.tp_size == ref.tp_size == 2
    assert ours.per_shard_memory_bytes() == ref.per_shard_memory_bytes()
    assert ours.shards[1][0][2].shape == (4, 1)


def _attend_args(pool):
    """paged_attend's operands for one decode token of one sequence."""
    q, k_new, v_new = (torch.ones(1, 1, 1, 8) for _ in range(3))
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    one = torch.tensor([[1]]), torch.tensor([[0]])
    pos = torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    return (q, k_new, v_new, pool.pools[0], tables, *one, *pos, 1,
            "reference")


@pytest.mark.parametrize("entry,param,other,item", [
    ("FCFSScheduler", "count_host_headroom", True, "item 9"),  # ported
    ("SequenceKV", "kv_tag", "fp8", "item 8"),
    ("paged_attend", "shard_ctx", (CPU_MESH2, "model"), "item 10"),
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
    if entry == "FCFSScheduler":
        # ported with the host tier (item 9): free host slots lift the
        # admission watermark as they lift the JAX one
        jpool = JaxKVCachePool(1, 4, 4, 1, 8)
        for pl in (pool, jpool):
            pl.enable_host_tier(5)
        ours = FCFSScheduler(pool, 1, 2, admission_watermark=0.5,
                             **{param: other})
        ref = JaxFCFSScheduler(jpool, 1, 2, admission_watermark=0.5,
                               **{param: other})
        assert ours.count_host_headroom is ref.count_host_headroom is True
        assert ours._effective_watermark() == ref._effective_watermark() \
            == 3
        return
    if entry == "SequenceKV":
        # ported with the mixed pool (item 8): the tag stamps every page
        # the sequence allocates, as the JAX SequenceKV stamps them
        mixed = KVCachePool(1, 4, 4, 1, 8, device="cpu", kv_dtype="mixed")
        jmixed = JaxKVCachePool(1, 4, 4, 1, 8, kv_dtype="mixed")
        ours, ref = SequenceKV(mixed, kv_tag=other), \
            JaxSequenceKV(jmixed, kv_tag=other)
        ours.grow(5)
        ref.grow(5)
        assert ours.pages == ref.pages
        assert [mixed.page_tag(p) for p in ours.pages] == \
            [jmixed.page_tag(p) for p in ref.pages] == [other] * 2
        assert mixed.pools[0][2].tolist() == \
            np.asarray(jmixed.pools[0][2]).tolist()
        return
    # paged_attend (item 10, ported): shard_ctx marks one shard's call, at
    # the shard's own heads, the same call as an unsharded one
    plain = paged_attend(*_attend_args(pool))[0]
    fresh = KVCachePool(1, 4, 4, 1, 8, device="cpu")
    assert torch.equal(paged_attend(*_attend_args(fresh), **{param: other})
                       [0], plain)


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


# ---------------------------------------------- faults F5-F9, repaired


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
    ("offload", OffloadRecord(0, 4, [1]), "item 9"),
    ("pending_pagein", [(1, 2)], "item 9"),
    ("admit_pagein_tokens", 3, "item 9")])
def test_request_host_tier_and_prefix_fields_take_their_defaults_only(
        field, value, item):
    """The host-tier fields (item 9, ported) take any value, as the JAX
    Request's do, and keep it."""
    ours, ref = Request([1, 2], **{field: value}), \
        JaxRequest([1, 2], **{field: value})
    assert getattr(ours, field) == getattr(ref, field) == value


@pytest.mark.parametrize("param", ["data_axis", "model_axis",
                                   "weight_group_size", "comm_dtype"])
def test_create_engine_takes_the_jax_parameter(model, param):
    """F9: serving.create_engine has each JAX parameter in its JAX slot
    with the JAX default, and accepts it there; weight_group_size reaches
    the runner."""
    from paddle_tpu.serving import create_engine as jax_create_engine
    ours = inspect.signature(create_engine).parameters
    ref = inspect.signature(jax_create_engine).parameters
    names = [n for n, p in ours.items() if n != "device"
             and p.kind is inspect.Parameter.KEYWORD_ONLY]
    assert names == [n for n, p in ref.items()
                     if p.kind is inspect.Parameter.KEYWORD_ONLY]
    assert ours["device"].kind is inspect.Parameter.KEYWORD_ONLY
    assert ours[param].default == ref[param].default
    eng = create_engine(model, device="cpu", block_size=8, max_model_len=32,
                        num_blocks=8, **{param: ref[param].default})
    assert eng.runner.weight_group_size == 128
    if param == "weight_group_size":
        # the weight ladder is ported: another group size reaches it
        eng = create_engine(model, device="cpu", block_size=8,
                            max_model_len=32, num_blocks=8,
                            weight_dtype="int4", weight_group_size=16)
        assert eng.runner.weight_group_size == 16
        assert eng.runner.params["layers.0.mlp.up_proj.weight::scale"
                                 ].shape[1] == SIZES["hidden_size"] // 16
    else:
        # with a mesh (item 10, ported) the parameter reaches the shard
        eng = create_engine(model, device="cpu", block_size=8,
                            max_model_len=32, num_blocks=8, mesh=CPU_MESH2,
                            **{param: ref[param].default})
        assert eng.runner.tp_size == 2
        assert getattr(eng.runner, param) == ref[param].default


def test_comm_dtype_without_a_mesh_is_a_value_error(model, jax_model):
    """F9, F15: the quantized collective needs a mesh; both packages refuse
    it without one as an error of the call, through `create_engine` and
    through `inference.create_serving_engine`; with a mesh (item 10) both
    serve it."""
    from paddle_tpu.serving import create_engine as jax_create_engine
    kw = dict(block_size=8, max_model_len=32, num_blocks=8,
              comm_dtype="int8")
    with pytest.raises(ValueError, match="mesh"):
        create_engine(model, device="cpu", **kw)
    with pytest.raises(ValueError, match="mesh"):
        jax_create_engine(jax_model, **kw)
    with pytest.raises(ValueError, match="mesh"):
        create_serving_engine(model, device="cpu", **kw)
    with pytest.raises(ValueError, match="mesh"):
        jax_create_serving_engine(jax_model, **kw)
    eng = create_serving_engine(model, device="cpu", mesh=CPU_MESH2, **kw)
    assert eng.runner.comm_dtype == "int8"


# the JAX snapshot's keys the port leaves out: none since the tensor-
# parallel ones (item 10) were ported
UNPORTED_METRIC_PREFIXES = ()


def _scripted_clock():
    """A clock that reads 0.0, 1.0, 2.0, ... on successive calls."""
    ticks = itertools.count()
    return lambda: float(next(ticks))


def _metrics_run(pm, jm, **kw):
    """The same requests through the port's and the JAX engine, each with a
    scripted clock: (port snapshot, JAX snapshot)."""
    from paddle_tpu.serving import EngineMetrics as JaxEngineMetrics
    from paddle_tpu_torch.serving import EngineMetrics
    sp = SamplingParams(max_tokens=6)
    eng = _engine(pm, max_batch_size=3, metrics=EngineMetrics(
        clock=_scripted_clock()), **kw)
    _serve(eng, PROMPTS, sp)
    jeng = jax_create_serving_engine(
        jm, block_size=8, max_model_len=32, num_blocks=8, max_batch_size=3,
        metrics=JaxEngineMetrics(clock=_scripted_clock()), **kw)
    for p in PROMPTS:
        jeng.add_request(p, JaxSamplingParams(max_tokens=6))
    jeng.run()
    return eng.metrics.snapshot(), jeng.metrics.snapshot()


def test_snapshot_keys_equal_the_jax_keys(twin):
    """F14: the port's EngineMetrics.snapshot() keys are the JAX ones (and
    no stray pool_utilization): the host tier's (item 9), the host-wide
    store's (item 11) and tensor parallelism's (item 10) are required."""
    ours, ref = _metrics_run(*twin[::-1])
    ref_keys = {k for k in ref if not k.startswith(UNPORTED_METRIC_PREFIXES)}
    assert set(ours) == ref_keys
    assert "pool_utilization" not in ours


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["serial", "pipelined"])
def test_overlapped_plan_and_device_idle_fraction_follow_jax(twin,
                                                             pipelined):
    """F14: on a scripted clock, overlapped_plan_seconds (planning under an
    in-flight launch: none without the pipelined loop) and
    device_idle_fraction = 1 - min((drain waits + overlapped planning) /
    step seconds, 1), set as the JAX engine sets them."""
    kw = dict(decode_horizon=4, pipelined=True) if pipelined else {}
    ours, ref = _metrics_run(*twin[::-1], **kw)
    for snap in (ours, ref):
        blocked = snap["drain_wait_seconds"] + snap["overlapped_plan_seconds"]
        assert snap["device_idle_fraction"] == pytest.approx(
            max(0.0, 1.0 - min(blocked / snap["step_seconds"], 1.0)))
        assert (snap["overlapped_plan_seconds"] > 0) == pipelined
        assert snap["overlapped_plan_seconds"] <= snap["host_plan_seconds"]
    assert (ours["planned_ahead_steps"] > 0) == (ref["planned_ahead_steps"]
                                                 > 0) == pipelined


def _package_names(pkg):
    """A package's public names: its __all__, else every name it binds
    that is not a module and does not start with an underscore."""
    if hasattr(pkg, "__all__"):
        return list(pkg.__all__)
    return [k for k, v in vars(pkg).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)]


def _port_definitions():
    """{name: [modules]} of every top-level class and function a port
    module defines (not one it imports)."""
    defined = {}
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        mod = importlib.import_module(info.name)
        for k, v in vars(mod).items():
            if getattr(v, "__module__", None) == mod.__name__:
                defined.setdefault(k, []).append(info.name)
    return defined


# the op table's functions carry Paddle's op names, which other JAX
# packages reuse for other things (parallel's gather / scatter / split)
OP_MODULES = ("paddle_tpu_torch.ops.impl", "paddle_tpu_torch.ops.impl_extra")


def _ported(ref, name, defined):
    """The port module defining ``name`` as the counterpart of the JAX
    package's ``ref.name``: the port module of the JAX object's own module
    path, else any port module but the op table's, or None."""
    mods = defined.get(name, [])
    home = getattr(getattr(ref, name), "__module__", None)
    if isinstance(home, str) and home.startswith("paddle_tpu."):
        want = home.replace("paddle_tpu", "paddle_tpu_torch", 1)
        if want in mods:
            return want
    others = [m for m in mods if m not in OP_MODULES]
    return others[0] if others else None


PORT_PACKAGES = sorted(
    info.name for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                                "paddle_tpu_torch.")
    if info.ispkg)


@pytest.mark.parametrize("package", PORT_PACKAGES)
def test_ported_names_import_from_the_package_of_the_jax_path(package):
    """F12: a name the JAX package exports from a package (its __all__, or
    what its __init__ binds) and that the port defines (`_ported`: a
    function of the op table counts only as the JAX op's counterpart)
    imports from the port's package of the same path, and is in that
    package's __all__."""
    ours = importlib.import_module(package)
    ref = importlib.import_module(package.replace("paddle_tpu_torch",
                                                  "paddle_tpu", 1))
    defined = _port_definitions()
    ported = {n: _ported(ref, n, defined) for n in _package_names(ref)}
    ported = {n: m for n, m in ported.items() if m is not None}
    missing = [(n, m) for n, m in ported.items() if not hasattr(ours, n)]
    assert not missing, f"{package} lacks {missing}"
    unlisted = [n for n in ported if hasattr(ours, "__all__")
                and n not in ours.__all__]
    assert not unlisted, f"{package}.__all__ lacks {unlisted}"


def test_the_proposers_and_gpt_block_import_from_their_packages():
    """F12, by name: the four names of serving/speculate.py,
    quantized_page_write and GPTBlock."""
    from paddle_tpu_torch.models import GPTBlock
    from paddle_tpu_torch.serving import (
        AdaptiveK, DraftModelProposer, NgramProposer, quantized_page_write,
        shadow_runner,
    )
    from paddle_tpu_torch.serving import kv_cache, speculate
    from paddle_tpu_torch.models import gpt
    assert GPTBlock is gpt.GPTBlock
    assert quantized_page_write is kv_cache.quantized_page_write
    assert (AdaptiveK, DraftModelProposer, NgramProposer, shadow_runner) == (
        speculate.AdaptiveK, speculate.DraftModelProposer,
        speculate.NgramProposer, speculate.shadow_runner)


def test_get_flags_and_flags_version_follow_jax():
    """F13: get_flags takes a name or an iterable and returns a dict equal
    to the JAX one on the same flags; set_flags bumps flags_version by one
    in both packages, an unknown name raises KeyError in both."""
    from paddle_tpu.utils import flags as jax_flags
    from paddle_tpu_torch.utils import flags, flags_version, get_flags
    name = "FLAGS_use_flash_attention"
    assert get_flags(name) == jax_flags.get_flags(name) == {name: True}
    # the framework's three flags, with the JAX defaults
    three = ["FLAGS_check_nan_inf", "FLAGS_eager_op_jit",
             "FLAGS_default_dtype"]
    assert get_flags(three) == jax_flags.get_flags(three) == {
        "FLAGS_check_nan_inf": False, "FLAGS_eager_op_jit": True,
        "FLAGS_default_dtype": "float32"}
    assert get_flags([name]) == jax_flags.get_flags((n for n in [name]))
    v0, j0 = flags_version(), jax_flags.flags_version()
    try:
        flags.set_flags({name: False})
        jax_flags.set_flags({name: False})
        assert get_flags(name) == jax_flags.get_flags(name) == {name: False}
        assert flags_version() - v0 == jax_flags.flags_version() - j0 == 1
    finally:
        flags.set_flags({name: True})
        jax_flags.set_flags({name: True})
    assert flags_version() - v0 == jax_flags.flags_version() - j0 == 2
    for n, v in (("FLAGS_check_nan_inf", True),
                 ("FLAGS_default_dtype", "float16")):
        old = get_flags(n)
        try:
            flags.set_flags({n: v})
            jax_flags.set_flags({n: v})
            assert get_flags(n) == jax_flags.get_flags(n) == {n: v}
        finally:
            flags.set_flags(old)
            jax_flags.set_flags(old)
    assert flags_version() - v0 == jax_flags.flags_version() - j0 == 6
    with pytest.raises(KeyError):
        get_flags("FLAGS_no_such_flag")
    with pytest.raises(KeyError):
        jax_flags.get_flags("FLAGS_no_such_flag")


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


def test_gpt_block_takes_the_jax_signature():
    """F10: GPTBlock takes the JAX (cfg, use_moe=False), device and gen
    keyword-only after it, so the positional MoE flag reaches use_moe
    (where it set the port's device before) and the JAX call GPTBlock(cfg)
    builds a block."""
    from paddle_tpu.models.gpt import GPTBlock as JaxGPTBlock
    from paddle_tpu_torch.models.gpt import GPTBlock, GPTConfig
    assert _positional_names(GPTBlock) == _positional_names(JaxGPTBlock)
    ours = inspect.signature(GPTBlock).parameters
    assert ours["use_moe"].default is \
        inspect.signature(JaxGPTBlock).parameters["use_moe"].default
    assert {ours[n].kind for n in ("device", "gen")} == {
        inspect.Parameter.KEYWORD_ONLY}
    cfg = GPTConfig(vocab_size=61, hidden_size=32, num_layers=1, num_heads=2,
                    max_seq_len=32)
    with pytest.raises(NotImplementedError, match="MoE"):
        GPTBlock(cfg, True, device="cpu")
    blk = GPTBlock(cfg, device="cpu")
    assert blk.ln1.weight.device.type == "cpu"


def test_rms_norm_takes_the_jax_signature():
    """F11: RMSNorm takes the JAX (hidden, eps=1e-6), device keyword-only
    after it: RMSNorm(hidden) at the JAX default builds a norm (it raised
    TypeError) that equals the JAX one on the same input."""
    from paddle_tpu.models.llama import RMSNorm as JaxRMSNorm
    from paddle_tpu_torch.models.llama import RMSNorm
    assert _positional_names(RMSNorm) == _positional_names(JaxRMSNorm)
    assert inspect.signature(RMSNorm).parameters["eps"].default == \
        inspect.signature(JaxRMSNorm).parameters["eps"].default == 1e-6
    assert inspect.signature(RMSNorm).parameters["device"].kind is \
        inspect.Parameter.KEYWORD_ONLY
    norm = RMSNorm(8, device="cpu")
    assert norm.eps == 1e-6 and RMSNorm(8, 1e-5, device="cpu").eps == 1e-5
    x = np.random.default_rng(2).standard_normal((3, 8)).astype(np.float32)
    ref = JaxRMSNorm(8)(paddle.to_tensor(x)).numpy()
    np.testing.assert_allclose(norm(torch.from_numpy(x)).detach().numpy(),
                               ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float16", torch.float16])
def test_float16_serving_raises_naming_item_21(model, dtype):
    """float16 serving, which raised naming ROADMAP.md item 21's serving
    half until the fp16 serving kernels (K1-fp16, K2-fp16) were ported:
    "float16" and torch.float16 each build an fp16 engine over fp16
    pools, whose greedy tokens equal its naive_generate's through the
    fp16 variants' plain versions."""
    eng = _engine(model, dtype=dtype)
    assert eng.runner.dtype == torch.float16
    assert eng.pool.pools[0][0].dtype == torch.float16
    sp = SamplingParams(max_tokens=4)
    assert _serve(eng, PROMPTS, sp) == [naive_generate(eng.runner, p, sp)
                                       for p in PROMPTS]


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
