#!/usr/bin/env python3
"""Time the paged-decode kernel (K2) over split sizes and design variants.

    python tools/k2_variants.py [--splits 64,128,256,512] [--out FILE]

Builds csrc/paged_decode_attention.cu as it is and each variant in
VARIANTS (the same source with a few lines replaced) with nvcc, all at
once, into csrc/build/variants/, and times each through its C entry point
with chip_smoke.py's median_ms (L2 flushed, median of 20 CUDA-event
timings) at the two K2 rows of tools/torch_kernel_ab.py: q [8, 32, 128] at
DECODE_POS and q [4, 32, 128] at LONG_POS, fp32 pools of 1024 pages of 16,
a [b, 256] table. The source as it is runs at every split size of
--splits, each variant at the wrapper's KEYS_PER_SPLIT. Every result is
held against the plain version (max |kernel - plain| <= 1e-4), except
those of the variants that take one part out to time what is left: "no
work" (no item: the launch, the scan of pos, the events), "no scoring"
(the copies without the math), "no merges" (no warp or split merge) and
"no table" (pages from a formula, not the page table). Last, a streaming read of 256 MiB
(torch.sum) as the card's practical read rate. Prints one line per
measurement, the card's name and power limit and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
CSRC = ROOT / "paddle_tpu_torch" / "csrc"
SOURCE = CSRC / "paged_decode_attention.cu"
OUT = CSRC / "build" / "variants"

_PREFETCH = '''__device__ __forceinline__ void cp_async16_pf(void* dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// One work item'''
# name -> [(text of the source, its replacement)]
VARIANTS = {
    "4 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "6 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 6;")],
    "8 warps": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    "2-key tiles": [("static constexpr int KT = 512 / MAXD;",
                     "static constexpr int KT = 256 / MAXD;")],
    "L2::256B hint": [("// One work item", _PREFETCH),
                      ("        cp_async16(kd + 4 * c, kp + 4 * c, live);\n"
                       "        cp_async16(vd + 4 * c, vp + 4 * c, live);",
                       "        cp_async16_pf(kd + 4 * c, kp + 4 * c, live);\n"
                       "        cp_async16_pf(vd + 4 * c, vp + 4 * c, live);")],
    "fence in every thread": [
        ("    __syncthreads();\n    if (tid == 0) {\n      __threadfence();\n"
         "      s_last",
         "    __threadfence();\n    __syncthreads();\n    if (tid == 0) {\n"
         "      s_last")],
    "no table prefetch": [('      asm volatile("prefetch.global.L2 [%0];\\n" '
                           '::"l"(a.table + line * 32));', "")],
    # what is left without one part (their outputs are not checked)
    "no work": [("  const int items = cum[a.b];", "  const int items = 0;")],
    "no scoring": [
        ("      for (int i = 0; i < QC; ++i) {\n        const int c = part + "
         "LPK * i;\n        if (c < d4) {",
         "      for (int i = 0; i < 0; ++i) {\n        const int c = part + "
         "LPK * i;\n        if (c < d4) {"),
        ("      for (int k2 = 0; k2 < KT; ++k2) {",
         "      for (int k2 = 0; k2 < 0; ++k2) {")],
    "no merges": [("    // merge the warps' (m, l, acc) in warp order",
                   "    if (acc[0].x != 12345.f) continue;\n"
                   "    // merge the warps' (m, l, acc) in warp order")],
    "no table": [("    const int page = __ldg(a.table + (int64_t)p_it.seq * "
                  "a.pages_per_seq +\n                           key / "
                  "a.page_size);",
                  "    const int page = 1 + (p_it.seq * 257 + key / "
                  "a.page_size) % 1023;")],
}
UNCHECKED = ("no work", "no scoring", "no merges", "no table")


def build(names_sources):
    """Compile each (name, source text) into its own library, in
    parallel; returns {name: the C entry point}."""
    from paddle_tpu_torch.ops._build import NVCC_FLAGS, SIGNATURES, _nvcc
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(names_sources):
        src = OUT / f"v{i}.cu"
        src.write_text(text)
        procs[name] = (OUT / f"libv{i}.so", subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-I", str(CSRC), str(src), "-o",
             str(OUT / f"libv{i}.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        regs = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "registers" in ln]
        print(f"built {name!r}: {regs}", flush=True)
        fn = ctypes.CDLL(str(lib)).paged_decode_attention_f32
        fn.argtypes = SIGNATURES["paged_decode_attention_f32"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", default="64,128,256,512")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k2_variants: needs an NVIDIA card", file=sys.stderr)
        return 2
    import torch_kernel_ab as ab
    from paddle_tpu_torch.ops import paged_attention as k2

    text = SOURCE.read_text()
    sources = [("kernel", text)]
    for name, reps in VARIANTS.items():
        v = text
        for old, new in reps:
            if old not in v:
                raise ValueError(f"variant {name!r}: {old!r} not in source")
            v = v.replace(old, new)
        sources.append((name, v))
    fns = build(sources)
    cs = ab._smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    d, ps, N, P, h = 128, 16, 1024, 256, 32
    k_pool, v_pool = cs._pools(N, ps, h, d, gen)
    tickets = torch.zeros(4096, dtype=torch.int32, device="cuda")
    res = {}
    for row, positions in (("K2 fp32 decode", ab.DECODE_POS),
                           ("K2 fp32 decode long", ab.LONG_POS)):
        B = len(positions)
        table = cs._tables(B, P, N, gen, used=[p // ps + 1 for p in positions])
        q = torch.randn(B, h, d, device="cuda", generator=gen)
        pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
        ref = k2.paged_decode_reference(q, k_pool, v_pool, table, pos)
        runs = [("kernel", int(ks)) for ks in args.splits.split(",")]
        runs += [(name, k2.KEYS_PER_SPLIT) for name in VARIANTS]
        for name, ks in runs:
            S = k2.n_splits(P, ps, ks)
            part = torch.empty(B * h * S * (d + 2), device="cuda")
            out = torch.empty_like(q)

            def call(fn=fns[name], ks=ks, S=S, part=part, out=out):
                err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                         table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                         part.data_ptr(), tickets.data_ptr(), B, h, d, ps, P,
                         ks, S, d ** -0.5,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError_t {err}")
            call()
            err = (out - ref).abs().max().item()
            if name not in UNCHECKED and not err <= 1e-4:
                raise AssertionError(f"{row} {name} ks={ks}: max_abs_err "
                                     f"{err}")
            ms = cs.median_ms(call)
            res[f"{row} | {name} | {ks} keys a split"] = ms
            print(f"{row} | {name} | {ks} keys a split: {ms:.4f} ms",
                  flush=True)
    del k_pool, v_pool
    big = torch.ones(64 * 2**20, device="cuda")
    ms = cs.median_ms(lambda: big.sum())
    res["torch.sum of 256 MiB"] = ms
    print(f"torch.sum of 256 MiB: {ms:.4f} ms = "
          f"{big.numel() * 4 / ms / 1e9:.3f} TB/s")
    print(f"card: {card}")
    summary = {"card": card, "ms": res}
    if args.out:
        Path(args.out).write_text(json.dumps(summary) + "\n")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
