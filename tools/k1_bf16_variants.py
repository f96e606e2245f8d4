#!/usr/bin/env python3
"""Time K1's bf16-q forms (csrc/ragged_paged_attention_bf16.cu) over design
variants of their tiling and grid on one card.

    python tools/k1_bf16_variants.py [--only NAME ...] [--out FILE]

Each variant in VARIANTS is the source with a few lines replaced ("as it
is" replaces none). The package is copied once per variant into
paddle_tpu_torch/csrc/build/k1_variants/ (git-ignored), the text replaced
there, and each copy is built and run in its own process, in turn:
ptxas's register and spill report for ragged_span_bf16_kernel,
ragged_decode_split_kernel and ragged_decode_row_kernel, the bf16 gates of chip_smoke.py's
check_ragged (within 2x the bf16 plain version's error against fp64,
misround at most 1/16) at the chunk, a GQA layout, the verify spans and
key counts across the 256-key splits over bf16, int8 and fp8 pools, then
the bf16 rows of tools/torch_kernel_ab.py (K1_BF16_ROWS, chip_smoke.py's
median_ms: L2 flushed, median of 20 CUDA-event timings). A variant whose
checks fail is reported and timed anyway. Prints one line per variant,
the card's name and power limit and, last, one JSON object {"card": ...,
"variants": {name: {...}}}.
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
SOURCE = "paddle_tpu_torch/csrc/ragged_paged_attention_bf16.cu"
OUT = ROOT / "paddle_tpu_torch" / "csrc" / "build" / "k1_variants"
_SPAN = "static constexpr int KG = 2, BN = 32, STAGES = 3;"
_DEC = "static constexpr int NW = 4, KT = 16, ST = 3, PER_SM = 2;"
_ROW = "static constexpr int NW = 4, KT = 8, ST = 3, PER_SM = 8;"
# name -> [(text of the source, its replacement)]
VARIANTS = {
    "as it is": [],
    # the span form: one key group (one warpgroup a block), a shallower or
    # a deeper ring
    "span one key group": [(_SPAN, _SPAN.replace("KG = 2", "KG = 1"))],
    "span 2 stages": [(_SPAN, _SPAN.replace("STAGES = 3", "STAGES = 2"))],
    "span 4 stages": [(_SPAN, _SPAN.replace("STAGES = 3", "STAGES = 4"))],
    # the decode form: eight warps a block, two stages; its one-row walk
    # (MHA decode): two blocks an SM, 4-key tiles
    "decode 8 warps": [(_DEC, _DEC.replace("NW = 4", "NW = 8"))],
    "decode 2 stages": [(_DEC, _DEC.replace("ST = 3", "ST = 2"))],
    "row walk 2 blocks an SM": [(_ROW, _ROW.replace("PER_SM = 8",
                                                    "PER_SM = 2"))],
    "row walk 4-key tiles": [(_ROW, _ROW.replace("KT = 8", "KT = 4"))],
}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def child(tree: Path) -> dict:
    """Build and run the variant in ``tree``; its registers, checks and
    ms."""
    sys.path.insert(0, str(tree))
    import torch

    cs = _load("chip_smoke", ROOT / "chip_smoke.py")
    ab = _load("torch_kernel_ab", ROOT / "tools" / "torch_kernel_ab.py")
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import ragged_paged_attention as k1

    assert Path(k1.__file__).resolve().is_relative_to(tree.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    ptxas, name = {}, None
    for ln in _build.BUILD.log.splitlines():
        if "Compiling entry function" in ln:
            name = cs._kernel_label(ln.split("'")[1])
        elif name and name.startswith(("ragged_span_bf16_kernel",
                                       "ragged_decode_split_kernel",
                                       "ragged_decode_row_kernel")):
            regs = re.search(r"Used (\d+) registers", ln)
            spill = re.findall(r"(\d+) bytes spill", ln)
            if regs:
                ptxas.setdefault(name, {})["registers"] = int(regs.group(1))
            if spill:
                ptxas.setdefault(name, {})["spill_bytes"] = [int(x)
                                                             for x in spill]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = "ok"
    split = ([0, 254, 255, 256, 4095, 100, 0, 511], [1, 1, 1, 1, 1, 0, 1, 1],
             1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            for kind in ("bf16", "int8", "fp8"):
                cs.check_ragged(32, 32, gen, "chunk", kind, cs.SPANS_CHUNK,
                                bf16=True)
                cs.check_ragged(32, 8, gen, "GQA", kind, bf16=True)
                cs.check_ragged(16, 16, gen, "verify", kind,
                                cs.SPANS_VERIFY, bf16=True)
                cs.check_ragged(32, 8, gen, "splits", kind, split,
                                bf16=True)
    except AssertionError as e:
        checks = str(e)[:300]
    ms = ab.time_k1_bf16(cs, gen, k1.ragged_paged_attention)
    return {"ptxas": ptxas, "checks": checks, "ms": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child")
    ap.add_argument("--only", nargs="*", help="the variants to run")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(Path(args.child))))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("k1_bf16_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    text = (ROOT / SOURCE).read_text()
    results = {}
    for name, edits in VARIANTS.items():
        if args.only and name not in args.only:
            continue
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
            results[name] = {"error": out.stderr.strip()[-800:]}
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
