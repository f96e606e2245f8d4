"""Inference bridge: models into serving engines.

Counterpart of paddle_tpu/inference/__init__.py::create_serving_engine.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.model_runner import runner_for

_RUNNER_KNOBS = ("block_size", "max_model_len", "attn_impl", "kv_dtype",
                 "weight_dtype", "weight_group_size")


def create_serving_engine(model, dtype=None, device="cuda", **kw):
    """Build a continuous-batching ServingEngine for a model on ``device``
    (default "cuda", which raises where no card is usable; pass "cpu" to
    run the kernels' plain versions). The model's parameters are moved to
    ``device`` unless they already live there. Runner knobs (block_size,
    max_model_len, attn_impl, kv_dtype, weight_dtype, weight_group_size)
    go to the runner, everything else to ServingEngine (decode_horizon,
    pipelined, horizon_sampling, horizon_early_stop, enable_prefix_cache,
    ragged_batch, num_speculative_tokens and the spec_* knobs among them);
    ``num_blocks`` defaults to 128. fp32 weights on one device are
    ported, over fp32, int8 or fp8 KV pools (``kv_dtype``): another
    ``dtype``, ``weight_dtype``, ``weight_group_size`` or
    ``kv_dtype="mixed"``, or a ``mesh``, raises NotImplementedError naming
    its ROADMAP item."""
    if dtype is not None and dtype not in ("float32", torch.float32):
        raise NotImplementedError(
            f"dtype={dtype!r}: only fp32 serving is ported; lower-precision "
            "serving is ROADMAP.md 'Still to port' item 8")
    if kw.pop("mesh", None) is not None:
        raise NotImplementedError(
            "mesh= (tensor-parallel serving) is not ported yet: ROADMAP.md "
            "'Still to port' item 10")
    if kw.pop("comm_dtype", "fp32") != "fp32":
        raise NotImplementedError(
            "comm_dtype (quantized collectives) is not ported yet: "
            "ROADMAP.md 'Still to port' item 10")
    runner = runner_for(model, device=device,
                        **{k: kw.pop(k) for k in _RUNNER_KNOBS if k in kw})
    kw.setdefault("num_blocks", 128)
    return ServingEngine(runner, **kw)
