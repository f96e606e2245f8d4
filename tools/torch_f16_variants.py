#!/usr/bin/env python3
"""Hold the fp16 flash kernels' range design against variants without it.

    python tools/torch_f16_variants.py [--out FILE]

The fp16 kernels (K3a, K3b-dq, K3b-dkv on wgmma at d <= 128) differ from
the bf16 ones in two pieces of arithmetic (csrc/flash_common.cuh): P is
multiplied by kPScale = 2^14 before its two-term split, and dS by a power
of two per accumulator row (ops/flash_attention.py::ds_scales). Each
variant in VARIANTS takes one piece out ("as it is" takes none), or keeps
a single fp16 term of P and dS. The package is copied once per variant
into
paddle_tpu_torch/csrc/build/f16_variants/ (git-ignored), the text replaced
there, and each copy is built and run in its own process, in turn:
chip_smoke.py's check_half at fp16 (within 2x the fp16 plain version's
error against fp64, misround at most 1/16, finite exactly where the plain
version is) on the cases of CASES, each case's result or the reason it
failed, then the three kernels alone (and ds_scales) with chip_smoke.py's
median_ms at q/k/v [1, 4096, 32, 128] causal. Prints one line per variant, the card's
name and power limit and, last, one JSON object {"card": ...,
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
CSRC = "paddle_tpu_torch/csrc/"
OUT = ROOT / "paddle_tpu_torch" / "csrc" / "build" / "f16_variants"
# name -> [(source under csrc/, its text, the replacement)]
VARIANTS = {
    "as it is": [],
    "P not scaled": [
        ("flash_common.cuh", "constexpr float kPScale = 16384.f;",
         "constexpr float kPScale = 1.f;")],
    # every row's factor 1: dS split as it comes
    "dS not scaled": [
        ("flash_common.cuh",
         "      if (row < n_rows) f = __ldg(dm.ds_scale + (int64_t)bh * n_rows "
         "+ row);\n", "")],
    "one fp16 term of P and dS": [
        ("bf16_mma.cuh", "    lo = pack_f16(x0 - hf.x, x1 - hf.y);",
         "    lo = 0u;")],
}
# (label, b, s, h, d, do_scale, v_scale): causal cases at fp16
CASES = (("1000, d 64", 1, 1000, 4, 64, 1.0, 1.0),
         ("1000, d 128", 1, 1000, 4, 128, 1.0, 1.0),
         ("4096, d 128", 1, 4096, 2, 128, 1.0, 1.0),
         ("dO x2^15 of 2^-3, v x4, d 128", 1, 1000, 4, 128, 2.0 ** 12, 4.0),
         ("dO x2^-15 of 2^-3, d 128", 1, 1000, 4, 128, 2.0 ** -18, 1.0))


def child(tree: Path) -> dict:
    """Build and run the variant in ``tree``: its checks and ms."""
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
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    checks = {}
    for label, b, s, h, d, do_scale, v_scale in CASES:
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                ratio, _, share = cs.check_half(
                    gen, label, b, s, s, h, d, True, dtype=torch.float16,
                    do_scale=do_scale, v_scale=v_scale)
            checks[label] = {"fp64_ratio": ratio, "misround": share}
        except AssertionError as e:
            checks[label] = {"failed": str(e)[-400:]}
    q, k, v, do = (torch.randn(1, 4096, 32, 128, device="cuda",
                               generator=gen).half() for _ in range(4))
    m, scale = fa.Masks(), 1.0 / 128 ** 0.5
    o, lse = fa.flash_forward(q, k, v, True)
    delta = fa.backward_delta(o, do)
    rows, keys = fa.ds_scales(v, do, scale)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    ms = {"flash_forward": cs.median_ms(lambda: fa.launch_forward(
              q, k, v, o, lse, True, scale, m)),
          "flash_backward_dq": cs.median_ms(lambda: fa.launch_backward_dq(
              q, k, v, do, lse, delta, dq, True, scale, m, rows)),
          "flash_backward_dkv": cs.median_ms(lambda: fa.launch_backward_dkv(
              q, k, v, do, lse, delta, dk, dv, True, scale, m, keys)),
          "ds_scales": cs.median_ms(lambda: fa.ds_scales(v, do, scale))}
    return {"checks": checks, "ms": ms}


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
        print("torch_f16_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    results = {}
    for name, edits in VARIANTS.items():
        tree = OUT / re.sub(r"\W+", "_", name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(ROOT / "paddle_tpu_torch", tree / "paddle_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        for source, old, new in edits:
            path = tree / CSRC / source
            text = path.read_text()
            if text.count(old) != 1:
                raise ValueError(f"variant {name!r}: text not found once in "
                                 f"{source}: {old!r}")
            path.write_text(text.replace(old, new))
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
