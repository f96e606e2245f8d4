#!/usr/bin/env python3
"""chip_smoke.py's phases 42-46 alone (the serving tier at LLaMA-2-7B fp32,
full width and 8 of 32 layers, random weights; phase 45 the tier over
replica processes and phase 46 the host-wide KV store, at the same depth),
after building the kernels: the quickest way to re-run the tier's gates on
the card.

    python3 tools/torch_tier_phases.py [42] [43] [44] [45] [46]

With no argument it runs all five; without 42 the reference streams come
from one engine on the same traffic. Phase 45 builds no model here
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
