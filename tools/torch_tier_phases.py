#!/usr/bin/env python3
"""chip_smoke.py's phases 42-45 alone (the serving tier at LLaMA-2-7B fp32,
random weights; the int8 split arm at 8 of 32 layers; phase 45 the tier
over replica processes at 8 of 32 layers), after building the kernels: the
quickest way to re-run the tier's gates on the card.

    python3 tools/torch_tier_phases.py [42] [43] [44] [45]

With no argument it runs all four; without 42 the reference streams come
from one engine on the same traffic. Phase 45 alone builds no full-depth
model: its children build their own, and the parent frees its reference
engines before they start. Needs an NVIDIA card.
"""

import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402


def main():
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import LLAMA2_7B, Llama
    from paddle_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._LAP_CLOCK[0] = time.perf_counter()
    _build.library()
    cs.lap("build")
    cfg = LLAMA2_7B
    only = sys.argv[1:] or ["42", "43", "44", "45"]
    if only == ["45"]:
        cs.process_tier_phase(cfg, cs.router_requests(cfg))
        cs.log(f"time by part (s): {cs._LAPS}")
        cs.log("phases 45: ok")
        return
    model = Llama(cfg, device="cuda", seed=0)
    q_cfg = replace(cfg, num_layers=8)
    q_model = Llama(q_cfg, device="cuda", seed=0)
    cs.lap("models")
    if "42" in only:
        _, ref, reqs, runner = cs.tier_phase(model, cfg)
    else:
        reqs = cs.router_requests(cfg)
        single = create_serving_engine(model, device="cuda",
                                       **cs.ROUTER_KNOBS)
        for rid, p, sp in reqs:
            single.add_request(p, sp, request_id=rid)
        ref = {k: o.output_tokens for k, o in single.run().items()}
        runner = single.runner
        runner._graph_cache.clear()
        del single
        cs._free_the_card()
    if "43" in only:
        cs.disagg_phase(model, cfg, q_model, q_cfg, ref, reqs, runner)
    del q_model
    cs._free_the_card()
    if "44" in only:
        cs.durability_phase(model, cfg, ref, reqs, runner)
    if "45" in only:
        del model, runner
        cs._free_the_card()
        cs.process_tier_phase(cfg, reqs)
    cs.log(f"time by part (s): {cs._LAPS}")
    cs.log("phases " + " ".join(only) + ": ok")


if __name__ == "__main__":
    main()
