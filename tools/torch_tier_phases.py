#!/usr/bin/env python3
"""chip_smoke.py's phases 42-47 alone (the serving tier at LLaMA-2-7B fp32,
full width and 8 of 32 layers, random weights; phase 45 the tier over
replica processes and phase 46 the host-wide KV store, at the same depth;
phase 47 tensor-parallel serving at full depth and at 8 layers), after
building the kernels: the quickest way to re-run the tier's gates on the
card.

    python3 tools/torch_tier_phases.py [42] [43] [44] [45] [46] [47]

With no argument it runs 42-46; without 42 the reference streams come
from one engine on the same traffic. Phase 47 first serves phase 4's
traffic on one device (its reference streams and decode positions). Phase 45 builds no model here
(its children build their own, and the parent frees its reference engines
before they start); phase 46 frees its thread arms' model before its
children start. Needs an NVIDIA card.
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
    only = sys.argv[1:] or ["42", "43", "44", "45", "46"]
    if "47" in only:
        model = Llama(cfg, device="cuda", seed=0)
        q_cfg = replace(cfg, num_layers=8)
        q_model = Llama(q_cfg, device="cuda", seed=0)
        eng, _, positions, tokens, _, _ = cs.engine_phase(model, cfg)
        del eng
        cs._free_the_card()
        cs.lap("phase 4 reference")
        cs.tp_phase(model, cfg, q_model, q_cfg, tokens, positions)
        del model, q_model
        cs._free_the_card()
        only = [p for p in only if p != "47"]
        if not only:
            cs.log(f"time by part (s): {cs._LAPS}")
            cs.log("phases 47: ok")
            return
    if set(only) <= {"45", "46"}:
        reqs = cs.router_requests(cfg)
        if "45" in only:
            cs.process_tier_phase(cfg, reqs)
        if "46" in only:
            cs.store_tier_phase(cfg, reqs)
        cs.log(f"time by part (s): {cs._LAPS}")
        cs.log("phases " + " ".join(only) + ": ok")
        return
    # phases 42-44 run at 8 of the 32 layers, as in the smoke
    t_cfg = replace(cfg, num_layers=8)
    model = Llama(t_cfg, device="cuda", seed=0)
    cs.lap("models")
    if "42" in only:
        _, ref, reqs, runner = cs.tier_phase(model, t_cfg)
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
        cs.disagg_phase(model, t_cfg, reqs)
    if "44" in only:
        cs.durability_phase(model, t_cfg, ref, reqs, runner)
    del model, runner
    cs._free_the_card()
    if "45" in only:
        cs.process_tier_phase(cfg, reqs)
    if "46" in only:
        cs.store_tier_phase(cfg, reqs)
    cs.log(f"time by part (s): {cs._LAPS}")
    cs.log("phases " + " ".join(only) + ": ok")


if __name__ == "__main__":
    main()
