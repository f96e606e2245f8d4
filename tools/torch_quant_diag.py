#!/usr/bin/env python3
"""Where a 1-byte KV model's kernel path and gather path part: the check
behind chip_smoke.py's phase 7, call by call, with the codes each path
wrote.

    python tools/torch_quant_diag.py [TREE]

TREE is a checkout of the repository (default: this one); its
paddle_tpu_torch is imported. For int8 and for fp8 KV pools it runs
chip_smoke.py::quant_paths on a 2-layer LLaMA-2-7B-width model: two
256-token prefill chunks and 8 decode steps through the K1-q kernel, then
the same steps on the plain gather path from fresh pools. Printed per
pool type: each call's max|logit diff| / max|logit| (the smoke's gate is
1e-4 on the worst), then for every layer how many K and V codes the two
runs wrote differently (and, for int8, the largest relative difference of
their page scales). Each path writes its own pools, so a last-bit
difference of one layer's attention can flip codes of the next layer's
pools. Needs an NVIDIA card.
"""

from __future__ import annotations

import importlib.util
import sys
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent


def _smoke():
    """chip_smoke.py of this checkout (it imports the port only inside its
    functions, so TREE's package is the one it drives)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else ROOT).resolve()
    sys.path.insert(0, str(tree))
    if not torch.cuda.is_available():
        print("torch_quant_diag: needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.models import LLAMA2_7B

    cs = _smoke()
    cfg = replace(LLAMA2_7B, num_layers=2)
    for kind in ("int8", "fp8"):
        out_k, out_r, pools_k, pools_r = cs.quant_paths(cfg, kind)
        per = [((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(out_k, out_r)]
        print(f"{tree.name} {kind}: per call (2 chunks, 8 decode steps) "
              + " ".join(f"{x:.3e}" for x in per), flush=True)
        for layer in range(cfg.num_layers):
            for name, a, b in zip(("k", "v"), pools_k[layer][:2],
                                  pools_r[layer][:2]):
                if kind == "fp8":
                    a, b = a.view(torch.uint8), b.view(torch.uint8)
                flips = int((a.int() != b.int()).sum())
                print(f"  layer {layer} {name}: {flips} codes differ of "
                      f"{a.numel()}", flush=True)
            if kind == "int8":
                for name, a, b in zip(("k_scale", "v_scale"),
                                      pools_k[layer][2:], pools_r[layer][2:]):
                    rel = ((a - b).abs() / b.abs().clamp_min(1e-30)).max()
                    print(f"  layer {layer} {name}: max relative difference "
                          f"{rel.item():.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
