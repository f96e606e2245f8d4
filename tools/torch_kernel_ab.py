#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's attention kernels of two trees in turns on
one card: parent, change, change, parent.

    python tools/torch_kernel_ab.py PARENT_DIR CHANGE_DIR [--out FILE]

PARENT_DIR and CHANGE_DIR are checkouts of the repository (for example the
parent commit unpacked with `git archive` into a git-ignored directory, and
the working tree). Each turn runs in its own process, imports that tree's
paddle_tpu_torch, builds its kernels there (csrc/build of that tree) and
times every row below on the same seeded operands, through the tree's own
wrappers, with chip_smoke.py's median_ms (L2 flushed before each call,
median of 20 CUDA-event timings). It prints one line per row and turn, a
table and, last, one JSON object {"card": ..., "rows": {row: [ms of each
turn]}}; with --out the JSON goes to that file too.

Rows (LLaMA-2-7B heads, d = 128, pages of 16, a 1024-page pool):
  K1 fp32 chunk        q [1, 256, 32, 128] at start_pos 256, fp32 pools
  K1-q int8 chunk      the same over int8 pools with per-page scales
  K1-q fp8 chunk       the same over float8_e4m3fn pools
  K1-q int8 decode     q [8, 1, 32, 128] at DECODE_POS, int8 pools
  K1-q fp8 decode      the same over fp8 pools
  K1 fp32 decode GQA4  q [8, 1, 32, 128] at DECODE_POS over 8 kv heads
                       (n_rep 4), fp32 pools
  K2 fp32 decode       paged decode, q [8, 32, 128] at DECODE_POS, fp32
                       pools, a [8, 256] table
  K2 fp32 decode long  the same at LONG_POS (540 pages of the pool): the
                       walk at max_model_len 4096
  K3a Llama            flash forward, q/k/v [1, 4096, 32, 128], causal
  K3a-m ERNIE          flash forward, q/k/v [16, 512, 12, 64] with the
                       ERNIE batch's key-padding bias [16, 512], full
  K3a-bf16 Llama       the two K3a rows on bf16 q/k/v (the bf16 forward;
  K3a-m-bf16 ERNIE     fp32 kbias)
  K3b-dq-bf16 Llama    the bf16 dq and dk/dv kernels on the same bf16
  K3b-dq-m-bf16 ERNIE  operands and a bf16 dO, with the forward's lse and
  K3b-dkv-bf16 Llama   delta
  K3b-dkv-m-bf16 ERNIE
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# eight decode positions spread over the engine's range (chip_smoke.py's
# engine decodes at positions 124-542)
DECODE_POS = [124, 183, 242, 301, 360, 419, 478, 542]
# four sequences up to the engine's max_model_len of 4096 tokens
LONG_POS = [4095, 3000, 1500, 16]
ROWS = ("K1 fp32 chunk", "K1-q int8 chunk", "K1-q fp8 chunk",
        "K1-q int8 decode", "K1-q fp8 decode", "K1 fp32 decode GQA4",
        "K2 fp32 decode", "K2 fp32 decode long", "K3a Llama", "K3a-m ERNIE",
        "K3a-bf16 Llama", "K3a-m-bf16 ERNIE", "K3b-dq-bf16 Llama",
        "K3b-dq-m-bf16 ERNIE", "K3b-dkv-bf16 Llama", "K3b-dkv-m-bf16 ERNIE")


def _smoke():
    """chip_smoke.py of this checkout, for its timing and operand helpers
    (it imports the port only inside its functions)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def child(tree: str) -> dict:
    """Time every row with the paddle_tpu_torch of ``tree``."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops._build import library
    from paddle_tpu_torch.ops.paged_attention import paged_decode_attention
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs = _smoke()
    library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ms = {}
    d, ps, N, P = 128, 16, 1024, 256
    chunk = ([256], 256)
    decode = (DECODE_POS, 1)
    for row, kind, n_kv, (start, T) in (
            ("K1 fp32 chunk", "fp32", 32, chunk),
            ("K1-q int8 chunk", "int8", 32, chunk),
            ("K1-q fp8 chunk", "fp8", 32, chunk),
            ("K1-q int8 decode", "int8", 32, decode),
            ("K1-q fp8 decode", "fp8", 32, decode),
            ("K1 fp32 decode GQA4", "fp32", 8, decode)):
        B = len(start)
        k_pool, v_pool = cs._pools(N, ps, n_kv, d, gen)
        k, v, ks, vs = cs._as_kind(k_pool, v_pool, kind, gen)
        del k_pool, v_pool
        table = cs._tables(B, P, N, gen,
                           used=[-(-(s + T) // ps) for s in start])
        q = torch.randn(B, T, 32, d, device="cuda", generator=gen)
        st = torch.tensor(start, dtype=torch.int32, device="cuda")
        ql = torch.full((B,), T, dtype=torch.int32, device="cuda")
        ms[row] = cs.median_ms(lambda: ragged_paged_attention(
            q, k, v, table, st, ql, k_scale=ks, v_scale=vs))
        del k, v, ks, vs
    k_pool, v_pool = cs._pools(N, ps, 32, d, gen)
    for row, positions in (("K2 fp32 decode", DECODE_POS),
                           ("K2 fp32 decode long", LONG_POS)):
        B = len(positions)
        table = cs._tables(B, P, N, gen, used=[p // ps + 1 for p in positions])
        q = torch.randn(B, 32, d, device="cuda", generator=gen)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        ms[row] = cs.median_ms(lambda: paged_decode_attention(
            q, k_pool, v_pool, table, pos))
    del k_pool, v_pool
    for row, (b, s, h, dh, causal, ernie), dtype in (
            ("K3a Llama", (1, 4096, 32, 128, True, False), torch.float32),
            ("K3a-m ERNIE", (16, 512, 12, 64, False, True), torch.float32),
            ("K3a-bf16 Llama", (1, 4096, 32, 128, True, False),
             torch.bfloat16),
            ("K3a-m-bf16 ERNIE", (16, 512, 12, 64, False, True),
             torch.bfloat16)):
        q, k, v, do = (torch.randn(b, s, h, dh, device="cuda", generator=gen)
                       .to(dtype) for _ in range(4))
        kbias = None
        if ernie:
            att = cs.ernie_batch(40000, b, s, 0)[2]
            kbias = ((1.0 - att.float()) * -1e4).contiguous()
        o, lse = fa.flash_forward(q, k, v, causal, kbias=kbias)
        m = fa.Masks(kbias=kbias)
        scale = 1.0 / dh ** 0.5
        ms[row] = cs.median_ms(lambda: fa.launch_forward(
            q, k, v, o, lse, causal, scale, m))
        if dtype == torch.bfloat16:
            delta = fa.backward_delta(o, do)
            dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
            ms[row.replace("K3a", "K3b-dq")] = cs.median_ms(
                lambda: fa.launch_backward_dq(q, k, v, do, lse, delta, dq,
                                              causal, scale, m))
            ms[row.replace("K3a", "K3b-dkv")] = cs.median_ms(
                lambda: fa.launch_backward_dkv(q, k, v, do, lse, delta, dk,
                                               dv, causal, scale, m))
        del q, k, v, do, o, lse
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--child", action="store_true",
                    help="time one tree (PARENT_DIR) and print its JSON")
    ap.add_argument("--out")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.parent)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs an NVIDIA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    turns = [("parent", args.parent), ("change", args.change),
             ("change", args.change), ("parent", args.parent)]
    results = []
    for label, tree in turns:
        out = subprocess.run(
            [sys.executable, __file__, tree, "--child"], capture_output=True,
            text=True, check=True).stdout.strip().splitlines()[-1]
        results.append(json.loads(out))
        for row in ROWS:
            print(f"{label:6s} {tree}: {row} {results[-1][row]:.4f} ms",
                  flush=True)
    print(f"card: {card}")
    print("| row | " + " | ".join(t for t, _ in turns) + " |")
    print("|---|" + "---|" * len(turns))
    for row in ROWS:
        print(f"| {row} | " + " | ".join(f"{r[row]:.4f}" for r in results)
              + " |")
    summary = {"card": card, "turns": [t for t, _ in turns],
               "rows": {row: [r[row] for r in results] for row in ROWS}}
    if args.out:
        Path(args.out).write_text(json.dumps(summary) + "\n")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
