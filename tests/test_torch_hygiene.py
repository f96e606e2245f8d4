"""The port's boundaries: what it imports, where it runs, which path each
kernel wrapper takes, and what it refuses.

  * nothing in paddle_tpu_torch/ or chip_smoke.py imports jax or the JAX
    package (an AST scan, so a lazy import inside a function counts too);
  * entry points default to "cuda" and raise where no card is usable;
  * CPU tensors run the plain versions: `plain_launches` moves and
    `kernel_launches` never does;
  * every engine knob the port does not carry raises NotImplementedError
    naming its ROADMAP item;
  * chip_smoke.py fails, and prints no result, without a card or outside
    a checkout.
"""

import ast
import inspect
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch
import paddle_tpu_torch.ops.paged_attention as k2
import paddle_tpu_torch.ops.ragged_paged_attention as k1
from paddle_tpu_torch.inference import create_serving_engine
from paddle_tpu_torch.models import Llama, LlamaConfig
from paddle_tpu_torch.models.llama import rope_tables
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.serving import SamplingParams, create_engine
from paddle_tpu_torch.serving.engine import UNPORTED_KNOBS
from paddle_tpu_torch.serving.kv_cache import KVCachePool
from paddle_tpu_torch.serving.model_runner import LlamaRunner

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
            "paged_attention.py", "_build.py", "chip_smoke.py"} <= names


# ------------------------------------------------------------- devices


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda():
    for fn in (create_serving_engine, create_engine, Llama.__init__,
               KVCachePool.__init__, rope_tables):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cuda_without_a_card_raises_clearly(monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Llama(LlamaConfig(**SIZES))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCachePool(1, 4, 4, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rope_tables(8, 8, 1e4)
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


@pytest.mark.parametrize("kw", [
    dict(kv_dtype="int8"), dict(kv_dtype="fp8"), dict(weight_dtype="int4"),
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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Llama(LlamaConfig(**SIZES), device="cpu")(torch.zeros(1, 4).long())


def test_sampled_decoding_raises(model):
    eng = _engine(model)
    with pytest.raises(NotImplementedError, match="threefry"):
        eng.add_request([1, 2], SamplingParams(temperature=0.8, seed=1))


def test_unknown_knob_is_a_type_error(model):
    with pytest.raises(TypeError, match="no_such_knob"):
        _engine(model, no_such_knob=1)


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
