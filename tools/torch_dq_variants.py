#!/usr/bin/env python3
"""Time the bf16 dq kernel on wgmma (K3b-dq-bf16) over design variants.

    python tools/torch_dq_variants.py [--out FILE]

Each variant in VARIANTS is csrc/flash_attention_wgmma.cu with a few lines
replaced ("as it is" replaces none). The package is copied once per variant
into paddle_tpu_torch/csrc/build/dq_variants/ (git-ignored), the text
replaced there, and each copy is built and run in its own process, in turn:
ptxas's spill report for flash_bwd_dq_bf16_wgmma_kernel<64> and <128>, the
bf16 kernels against fp64 (chip_smoke.py's check_bf16: within 2x the bf16
plain version's error, misround at most 1/16) at sq = sk = 1, 65 / 200 and
200 / 65 (d 64 and 128, causal) and 4096 x 4096 (d 128, two heads), then
dq alone with chip_smoke.py's median_ms (L2 flushed, median of 20
CUDA-event timings) at the two dq rows of tools/torch_kernel_ab.py: q/k/v
[1, 4096, 32, 128] causal and [16, 512, 12, 64] with the ERNIE batch's
key-padding bias. A variant whose checks fail is reported and timed
anyway. Prints one line per variant, the card's name and power limit and,
last, one JSON object {"card": ..., "variants": {name: {...}}}.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = "paddle_tpu_torch/csrc/flash_attention_wgmma.cu"
OUT = ROOT / "paddle_tpu_torch" / "csrc" / "build" / "dq_variants"
_TILE = "struct DqWg {\n  static constexpr int BN = 32, ST = 4;"
# name -> [(text of the source, its replacement)]
VARIANTS = {
    "as it is": [],
    "64-key tiles": [(_TILE, _TILE.replace("BN = 32", "BN = 64"))],
    "6 stages": [(_TILE, _TILE.replace("ST = 4", "ST = 6"))],
    # dQ's product waited for in its own turn, its stage released there
    "dQ waited in its turn": [
        ("    wgmma_split<BN>(acc, hi, lo, kt);   // dQ += dS K, waited for "
         "next turn\n    prev = st;",
         "    wgmma_split<BN>(acc, hi, lo, kt);\n    wgmma_wait<0>();\n"
         "    reg_fence(acc);\n    if (lane == 0) mbar_arrive(empty(st));")],
}


def child(tree: Path) -> dict:
    """Build and run the variant in ``tree``; its spills, checks and ms."""
    sys.path.insert(0, str(tree))
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    assert Path(fa.__file__).resolve().is_relative_to(tree.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    spills, name = {}, None
    for ln in _build.BUILD.log.splitlines():
        if "Compiling entry function" in ln:
            name = cs._kernel_label(ln.split("'")[1])
        elif name and name.startswith("flash_bwd_dq_bf16_wgmma_kernel") \
                and "spill" in ln:
            spills[name] = [int(x) for x in
                            re.findall(r"(\d+) bytes spill", ln)]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = "ok"
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            for d in (64, 128):
                for sq, sk in ((1, 1), (65, 200), (200, 65)):
                    cs.check_bf16(gen, "variant", 1, sq, sk, 4, d, True)
            cs.check_bf16(gen, "variant", 1, 4096, 4096, 2, 128, True)
    except AssertionError as e:
        checks = str(e)[:300]
    ms = {}
    att = cs.ernie_batch(40000, 16, 512, 0)[2]
    for row, (b, s, h, d, causal, ernie) in (
            ("Llama", (1, 4096, 32, 128, True, False)),
            ("ERNIE", (16, 512, 12, 64, False, True))):
        q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(4))
        kbias = ((1.0 - att.float()) * -1e4).contiguous() if ernie else None
        m = fa.Masks(kbias=kbias)
        o, lse = fa.flash_forward(q, k, v, causal, kbias=kbias)
        delta = fa.backward_delta(o, do)
        dq = torch.empty_like(q)
        ms[row] = cs.median_ms(lambda: fa.launch_backward_dq(
            q, k, v, do, lse, delta, dq, causal, 1.0 / d ** 0.5, m))
    return {"spill_bytes": spills, "checks": checks, "ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.child))))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_dq_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    text = (ROOT / SOURCE).read_text()
    results = {}
    for name, edits in VARIANTS.items():
        tree = OUT / re.sub(r"\W+", "_", name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(ROOT / "paddle_tpu_torch", tree / "paddle_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        variant = text
        for old, new in edits:
            if variant.count(old) != 1:
                raise ValueError(f"variant {name!r}: text not found once: "
                                 f"{old!r}")
            variant = variant.replace(old, new)
        (tree / SOURCE).write_text(variant)
        out = subprocess.run(
            [sys.executable, __file__, "--child", str(tree)],
            capture_output=True, text=True)
        if out.returncode != 0:
            results[name] = {"error": out.stderr.strip()[-500:]}
        else:
            results[name] = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{name}: {json.dumps(results[name])}", flush=True)
    print(f"card: {card}")
    summary = {"card": card, "variants": results}
    if args.out:
        Path(args.out).write_text(json.dumps(summary) + "\n")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
