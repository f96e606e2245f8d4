"""Inference bridge: models into serving engines.

Counterpart of paddle_tpu/inference/__init__.py::create_serving_engine.
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
