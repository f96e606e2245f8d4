"""Inference bridge: models into serving engines.

Counterpart of paddle_tpu/inference/__init__.py::create_serving_engine and
restore_serving_engine.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.model_runner import runner_for

_RUNNER_KNOBS = ("block_size", "max_model_len", "attn_impl", "kv_dtype",
                 "weight_dtype", "weight_group_size")

# the serving dtypes by name
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _serving_dtype(dtype):
    """``dtype`` as a torch dtype: fp32, bf16 or fp16 (a torch dtype or its
    name)."""
    dt = _DTYPES.get(dtype, dtype)
    if dt not in _DTYPES.values():
        raise ValueError(f"dtype={dtype!r}; expected one of "
                         f"{sorted(_DTYPES)} (or the torch dtypes)")
    return dt


def create_serving_engine(model, dtype=None, device="cuda", **kw):
    """Build a continuous-batching ServingEngine for a model on ``device``
    (default "cuda", which raises where no card is usable; pass "cpu" to
    run the kernels' plain versions). The model's parameters are moved to
    ``device`` unless they already live there. Runner knobs (block_size,
    max_model_len, attn_impl, kv_dtype, weight_dtype, weight_group_size)
    go to the runner, everything else to ServingEngine (decode_horizon,
    pipelined, horizon_sampling, horizon_early_stop, enable_prefix_cache,
    ragged_batch, num_speculative_tokens and the spec_* knobs among them);
    ``num_blocks`` defaults to 128.

    ``dtype`` (torch.float32, torch.bfloat16 or torch.float16, or their
    names) casts the runner's parameters, and so its compute and its KV
    pools, as the JAX bridge does: after the runner is built, every
    floating parameter is cast, the weight ladder's own included (fp8
    weights come back in ``dtype``, int8 and int4 scales become
    ``dtype``); integer codes stay. The runner's dict is cast, never the
    model. A ``mesh`` raises naming ROADMAP.md item 10, and a
    ``comm_dtype`` other than "fp32" without a mesh is a ValueError, as
    in JAX."""
    mesh = kw.pop("mesh", None)
    comm_dtype = kw.pop("comm_dtype", "fp32")
    if comm_dtype != "fp32" and mesh is None:
        raise ValueError(
            f"comm_dtype={comm_dtype!r} needs a tensor-parallel mesh: the "
            "quantized collective replaces the row-parallel allreduce, "
            "which only exists at tp > 1")
    if mesh is not None:
        raise NotImplementedError(
            f"mesh= (tensor-parallel serving, comm_dtype={comm_dtype!r}) is "
            "not ported yet: ROADMAP.md 'Still to port' item 10")
    dt = _serving_dtype(dtype) if dtype is not None else None
    runner = runner_for(model, device=device,
                        **{k: kw.pop(k) for k in _RUNNER_KNOBS if k in kw})
    if dt is not None:
        runner.params = {k: (v.to(dt) if v.is_floating_point() else v)
                         for k, v in runner.params.items()}
    kw.setdefault("num_blocks", 128)
    return ServingEngine(runner, **kw)


def restore_serving_engine(model, state, attn_impl: str = "auto",
                           mesh=None, *, device="cuda", **kw):
    """Rebuild a crashed or killed serving engine from
    ``engine.snapshot()``: a fresh runner for ``model`` on ``device``
    (default "cuda"), built with the snapshot's block size, model length,
    kv_dtype, weight_dtype and weight group size, then
    `ServingEngine.restore`, which replays every request through
    recompute-on-resume, token for token as an uninterrupted run. Other
    keywords (metrics, tokenizer, sleep_fn, audit) go to `restore`. A
    ``mesh`` raises naming ROADMAP.md item 10."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (restoring onto a tensor-parallel runner) is not ported "
            "yet: ROADMAP.md 'Still to port' item 10")
    cfg = state["config"]
    runner = runner_for(model, block_size=cfg["block_size"],
                        max_model_len=cfg["max_model_len"],
                        attn_impl=attn_impl,
                        kv_dtype=cfg.get("kv_dtype", "fp32"),
                        weight_dtype=cfg.get("weight_dtype", "fp32"),
                        weight_group_size=cfg.get("weight_group_size", 128),
                        device=device)
    return ServingEngine.restore(runner, state, **kw)
