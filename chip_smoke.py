#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. device   the card's name and power limit (nvidia-smi) and
              torch.cuda.get_device_name(0); no usable card raises.
  2. build    nvcc builds the kernels from paddle_tpu_torch/csrc (one
              process per source, started together); printed: the seconds
              it took, each kernel's registers and spills (ptxas), the
              backward kernels' shared memory per instantiation and the
              tensor-core instructions in the SASS (cuobjdump -sass: HMMA
              for mma.sync, HGMMA for wgmma) of every instantiation of the
              three flash kernels, their bf16 wgmma kernels (forward, dq
              and dk/dv at d <= 128, which must hold HGMMA and spill
              nothing) and the ragged span form; one without them, or
              missing, fails the run.
  3. kernels  each serving kernel's wrapper against its plain PyTorch
              version on the card: the ragged kernel over fp32 pools (K1)
              at LLaMA-2-7B heads and at a GQA layout over mixed spans
              (decode, chunks at start_pos > 0 crossing page boundaries, a
              dead slot, padded bucket rows); the ragged kernel over int8
              pools with per-page, per-kv-head scales and over
              float8_e4m3fn pools (K1-q) on the same codes and scales at
              LLaMA-2-7B heads (8 decode rows, T = 1, and a 256-row chunk
              at start_pos 256) and at the GQA layout; the paged-decode
              kernel (K2) at b=12, h=32, d=128 over a 4096-key table
              with pos on and off page and split boundaries, up to 4095
              and past the table, and a dead slot, then each of its
              sequences alone (bit for bit its batch output); then each
              at the shapes the engine gives it (phase 8). Tolerance: max |kernel - plain| <= 1e-4 in fp32
              (the two sum in different orders); padded and dead rows must
              be exactly 0. Times are medians of CUDA-event timings. The
              sweep over every head dim the gates admit, GQA group and page
              size is tests/test_torch_cuda.py.
 3s. sampler  the seeded sampler (the runner's _sampled_rows, which every
              sampled token goes through) on the card against the same
              function on the CPU: 64 rows of vocabulary 32000, seeds 0-7 x
              steps 0-31 x temperatures {0.3, 0.7, 1.0, 1.5} x (top_k,
              top_p) in {(None, None), (1, None), (50, None), (None, 0.9),
              (8, 0.9)}. Every token must be equal; one that parts prints
              its perturbed top-2 margin and fails the run.
  4. engine   LLaMA-2-7B at full width and depth, fp32, seeded random
              weights built on the card, served through
              inference.create_serving_engine: 8 requests with seeded
              prompt lengths 100-600 and max_tokens=32 under a 256-token
              prefill budget. Both kernels must have launched on this run
              (K2 once a layer on every decode call) and neither plain
              version; two requests must match
              naive_generate token for token (the first divergence, if
              any, is printed and fails the run).
  5. profile  where a serving step's time goes: torch.profiler over steps
              of one 256-token prefill chunk each and over decode-only
              steps of 8 sequences, device time by kernel group, each
              kernel's device time per launch, and the idle share against
              the wall of as many unprofiled steps. Decode steps run as
              replays of the runner's captured CUDA graph.
 5g. graphs   the same model, 8 sequences of 100-400 tokens prefilled into
              two copies of one pool: a decode step, a greedy horizon of 8
              (decode_multi) and a seeded early-stop horizon of 8, each run
              eagerly on one copy and through its graph on the other, twice
              (the first graphed call runs for real and captures, the second
              replays). Outputs and pools must be bitwise equal (max |diff|
              printed), and the launches a replay credits equal the eager
              call's. Each capture's seconds and graph pool are printed.
 5h. horizon  phase 4's 8 prompts with max_tokens 64: requests 0-3 greedy
              (a stop token each: their fp32 stream's 21st token), 4-7 at
              temperature 0.7, top_k 50, top_p 0.9, seeds 0-3 and a random
              stop token. Served by the per-step engine run eagerly and by
              the engine with decode_horizon=8, pipelined, horizon_sampling
              and horizon_early_stop, its decode kinds as CUDA graphs, each
              engine twice (its first round captures, its second replays).
              The streams must be equal token for token (the first
              divergence is printed), every request must finish and no
              page leak; the
              decode kernel (K2 over fp32 pools, K1-q's decode form over
              int8 / fp8) must launch once a layer on every inner decode
              step, and no plain version. Printed: tokens/s, TTFT, ms per
              decode token, host_syncs_per_token, horizon_overshoot_tokens,
              and a torch.profiler split of a horizon of 8 (device busy,
              host wall, idle share) beside phase 5's per-step decode.
  6. int8,    the same model, requests and budget served from an int8 and
     fp8      then an fp8 KV pool (kv_dtype="int8" / "fp8", 1024 pages of
              16, about 4 GiB each). Every prefill chunk and every decode
              step must launch the K1-q kernel of that dtype once per
              layer, and nothing else: no plain version, no K1 over fp32
              pools, no K2; chunks launch its span form and decode steps
              its decode form, both at least once. No page may leak. Each engine is then
              profiled as in phase 5. Reported, not gated: each
              engine's greedy agreement with the fp32 engine and with its
              own naive_generate on two requests. cuBLAS rounds a row of
              an fp32 x @ w differently for another row count (printed
              first), the batch-8 engine and naive_generate run other row
              counts, and 1-byte K/V turn those 1-ulp differences into
              whole quantization steps. Gated instead: an engine with one
              slot serves the two shortest prompts (one chunk each, then
              batch-1 decode steps, naive_generate's row counts) through
              K1-q alone and must equal naive_generate token for token,
              for int8 and for fp8. Each pool then runs phases 5g and 5h.
  7. check    a 2-layer model at full width over int8 and over fp8 pools:
              two 256-token prefill chunks and 8 decode steps (a dead slot
              beside the live one) through K1-q, then the same steps on the
              plain gather path (attn_impl="reference") from fresh pools;
              the logits of every call within 1e-4 * max|logit|; the
              kernel run launches K1-q on every call (span form for the
              chunks, decode form for the steps) and nothing else.
  8. timing   each serving kernel at the engine's shapes against its plain
              version, its bound and the library yardstick (SDPA on K/V
              gathered and dequantized beforehand), with L2 flushed before
              every timed call and the card held ~0.5 ms before it, so the
              host's launch overhead is not timed: K1 and K1-q at a
              256-token chunk at start_pos 256 (span form) and at the
              decode step of 8 sequences (decode form; over fp32 pools at
              GQA n_rep 4, the timed row, and MHA), K2 at that decode
              step. K1, K1-q and K2 are first held against the plain
              version in fp64 at each of these shapes: the kernel's max error
              within twice the fp32 plain version's own; the mean signed
              error of both is printed. Then the engine is freed: under
              1 GiB may stay allocated before the trainer is built.
  9. flash    the flash kernels (K3a forward, K3b-dq, K3b-dkv) through the
              autograd.Function and torch.autograd.grad against their
              plain versions: b=1, s=4096, h=32, d=128 causal, and a sweep
              over d in {64, 128, 256}, causal or not, s in {1, 100, 257,
              1000}
              and cross lengths sq=128 < sk=384 (and sq=384 > sk=128).
              o and lse within 1e-4; each of dq, dk, dv within 1e-4 *
              max|plain gradient| (with one key, where the exact dq and dk
              are 0, within 1e-4 * max|plain dv|).
 10. masked   the same three kernels in their masked forms (K3-m), each
              through the autograd.Function and then through the plain
              versions on the same operands on the card (the wrappers'
              plain branch), at phase 9's tolerances: ERNIE's -1e4 key
              padding and a bool key padding (both lowered to the per-key
              bias), a dense additive mask shared by the heads and one per
              head, a bool mask whose rows 50.. see no key (o and dq
              exactly 0 there), segment ids with causal, a block mask
              implied by a dense mask; then flash_attn_unpadded,
              flashmask_attention (row ranges; a window) and
              sparse_attention (CSR + key padding). d in {64, 128},
              lengths on and off multiples of 64, sq != sk.
 11. trainer  the training path: LLaMA-2-7B widths at 8 of 32 layers,
              fp32, seeded random weights on the card, jit.TrainStep with
              AdamW(1e-4, weight decay 0.01, global-norm clip 1.0) on one
              seeded batch of 4096 tokens, 2 warm-up and 6 timed steps.
              Losses must be finite and fall, each flash kernel must launch
              8 times per step and no plain version at all.
 12. profile  where a training step's time goes: torch.profiler over 2
              steps, device time by group (matmul, K3a, K3b-dq, K3b-dkv,
              optimizer, other), each flash kernel's ms per launch and the
              idle share against 2 unprofiled steps.
 13. check    a 2-layer model at full width, seq 1024, trained one step
              through the kernels and once on the dense path
              (FLAGS_use_flash_attention off) from the same weights and
              batch: loss within 1e-5 relative, every gradient within 1e-3
              * its max|grad|.
 14. timing   at the trainer's shape (b=1, s=4096, h=32, d=128, causal):
              first the kernels against their plain versions (phase 9's
              tolerances) and o, lse, dq, dk, dv against the plain versions
              in fp64, within twice the fp32 plain versions' own error
              (fp32-class products); then each flash kernel against its
              plain version, its bound and scaled_dot_product_attention
              as the yardstick, L2 flushed; the backward pair like for
              like: the whole flash_backward and the two kernels alone
              against SDPA's backward alone (autograd.grad of a retained
              graph).
 15. ERNIE    ERNIE-3.0-base pretraining (vocab 40000, hidden 768, 12
              layers, 12 heads, ffn 3072, 512 positions) at full width and
              depth, fp32, seeded random weights on the card, through
              jit.TrainStep(n_inputs=3) and AdamW(1e-4, weight decay 0.01)
              on bench.py::child_ernie's batch: 16 x 512 tokens at 85-100 %
              fill, 15 % masked, dropout 0; 2 warm-up and 6 timed steps.
              Losses must be finite and fall, each masked kernel must
              launch 12 times per step, and no dense flash kernel, plain
              version or dense attention at all.
 16. profile  where an ERNIE step's time goes, as phase 12 (groups K3a-m,
              K3b-dq-m, K3b-dkv-m).
 17. check    a 2-layer ERNIE at full width stepped once through the masked
              kernels and once on the dense path from the same weights and
              padded batch, phase 13's tolerances; then the outputs at
              real positions with the pad ids redrawn, within 2e-5.
 18. timing   phase 14 for the masked kernels at the ERNIE shape (q/k/v
              [16,512,12,64], the batch's kbias [16,512], full; SDPA with
              the broadcast float mask).
 20. bf16     the flash kernels' bf16 instantiations (AMP): (a) on bf16
              operands against the plain versions, both evaluated against
              the plain versions in fp64 on the same operands: o, lse, dq,
              dk and dv within twice the bf16 plain versions' own error,
              and o, dq, dk and dv misrounded (of the outputs the plain
              version rounds to bf16(exact), the share the kernel rounds
              elsewhere) at most 1/16 of the time, which sees the inner
              precision of the P and dS products that the max error
              cannot; at the Llama trainer's shape (causal), the ERNIE batch's
              shape and -1e4 key padding, a sweep over d in {64, 128} x
              causal / full x lengths 1, 100, 257, 1000 and 128 / 384
              crossed, phase 10's masked forms and one d = 256 case; each
              launch through the kernel `kernel_variant` names (wgmma at
              d <= 128, mma.sync above); (b) phase 14 and 18's timing at
              bf16 (plain versions and SDPA on the same bf16 operands; the
              bound at 2-byte operands and 989 TFLOP/s), then dq's time,
              its share of the bound and the pair's factor over SDPA's
              bf16 backward at both shapes.
 21. ERNIE O1 phase 15 at bf16 AMP O1 (child_ernie's amp_level), each masked
              bf16 kernel 12 times a step and nothing else (no fp32 flash
              kernel, plain version or dense attention); the forward, dq
              and dk/dv through their wgmma kernels (d = 64) every time
              (96 launches each), the mma.sync kernels of d > 128 never;
              profiled as 16.
 22. Llama O1 phase 11 at O1 through the dense bf16 kernels, the forward,
              dq and dk/dv through their wgmma kernels (d = 128) every
              time (64 launches each); profiled as 12.
 23. O2       a 2-layer Llama at full width after amp.decorate(level="O2"):
              bf16 parameters, fp32 master copies in AdamW, each parameter
              bit for bit its master cast to bf16 after every step; losses
              fall.
 24. twins    a 2-layer O1 step against the same step on the dense path
              (bf16) and against the fp32 step: loss within 1e-2, gradients
              within 5e-2 / 1e-1 of max|grad|.
 25. GPT      GPT-3 1.3B (GPT3_1_3B: vocab 50304, hidden 2048, 24 layers,
     serving  16 heads of 128, ffn 8192, 1024 positions, tied head) at full
              width and depth, fp32, seeded random weights, served as phase
              4 serves LLaMA-2-7B (1024 pages of 16, 8 slots, 256-token
              prefill budget, 8 requests of 100-600 prompt tokens, 32
              greedy tokens each; max_model_len 1024): every request
              finishes, no leak, K1 on every prefill chunk and K2 once a
              layer on every decode call, nothing else; two requests equal
              naive_generate; then one-slot int8 and fp8 engines through
              K1-q alone, token-exact against naive_generate (phase 6).
              The fp32 engine is profiled as in phase 5. Then K1, K1-q
              and K2 at the GPT shapes (16 heads) against their plain
              versions as phase 1 holds them: 256-token chunks, chunks of
              1-8 rows in the 8-row bucket, decode rows; and phase 7's
              check through GPTRunner: chunks of 256, 256, 8, 3 and 1
              tokens and 8 decode steps of 1-8 rows (the live sequence
              beside dead slots), the logits of every call within 1e-4 *
              max|logit| of the gather path's, at full depth over fp32
              pools and at 2 layers over int8 / fp8 (full depth there
              reported with the share of int8 / fp8 codes the two runs'
              own quantization parted, not gated); the kernel run
              launches K1's span form on the 256-token chunks and its
              decode form on the short ones, K2 (fp32) or K1-q's decode
              form (int8 / fp8) on the steps, and nothing else.
 26. gener-   the same model through models.generation at batch 8, prompt
     ators    256, 32 new tokens, caches of 512 positions:
              PagedGPTGenerator greedy launches K2 once a layer on every
              decode step and nothing else; GPTGenerator (dense cache)
              gives the same tokens, and both stepped on those tokens give
              logits within 1e-4 * max|logit| at every step (where a token
              parts, the top-2 margin there is printed and the run fails);
              a seeded sampled run equals the CPU sampler on the card's
              logits draw for draw; a beam run (num_beams 4) launches K2
              once a layer a step. ms per token step of each, and one
              greedy token step of each generator traced: host wall,
              device busy, idle share, host-to-device copies and stream
              waits a step.
 27. GPT      (a) GPT-3 1.3B at full depth, bf16 O1, [8, 1024] tokens,
     training AdamW(LinearWarmup(CosineAnnealingDecay(2e-4, 6, 2e-5), 2,
              0, 2e-4), weight decay 0.01, clip 1.0), 2 warm-up + 4 timed
              steps, the scheduler stepped after each: losses finite and
              falling, the rate each step reads equal to the scheduler's,
              each bf16 flash kernel once a layer a step on wgmma, nothing
              else; profiled as 12; (b) an fp32 2-layer GPT step at full
              width against the dense path (phase 13's tolerances); (c)
              the bf16 kernels at [8, 1024, 16, 128] causal against fp64
              (phase 20 (a)) and timed against their plain versions, their
              bound and SDPA (phase 20 (b)).
 28. summary  one JSON line of every kernel's launches, error and times
              (K1's decode-form times as extra decode_* keys, its engine
              launches by form under launches_by_form, the fp64 ratios
              under fp64_ratio; the masked kernels as *_masked rows with
              the ERNIE trainer's launches; the bf16 instantiations as
              *_bf16 and *_masked_bf16 rows with the O1 trainers'
              launches, by kernel variant under launches_by_variant (the
              kernel function under kernel), and their worst misround
              share under misround; the horizon engines' launches of the decode
              kernels under horizon_launches; each serving kernel's and the
              bf16 dense rows' launches on the GPT paths under
              gpt_launches, each serving kernel's error against its plain
              version at the GPT shapes under gpt_max_abs_err, the bf16
              dense rows' numbers at the GPT trainer's shape under
              gpt_shape), the nvidia-smi line, then
              the result line.

fp32 products stay fp32: TF32 is switched off for matmuls and cuDNN. Bounds
by operations are at fp32-accurate tensor-core products (3xTF32, 495 / 3
TFLOP/s), for the bf16 kernels at 989 TFLOP/s, by bytes at 3.35 TB/s. bf16
matmuls sum in fp32 (no reduced-precision split-K reduction).
"""

from __future__ import annotations

import contextlib
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# fp32-accurate products on the H100 SXM's tensor cores: 3xTF32 (three
# TF32 products per fp32 product) at a third of the 495 TFLOP/s TF32 peak
PEAK_FP32_ACCURATE_FLOP_PER_S = 495e12 / 3
# dense bf16 tensor-core products on the H100 SXM (NVIDIA data sheet): the
# bound of the bf16 flash kernels counts the JAX kernel's FLOPs at this
# rate, not the extra products of their two-term split of P and dS
PEAK_BF16_FLOP_PER_S = 989e12
TOL = 1e-4


def log(*parts):
    print(*parts, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_L2_FLUSH = []


def _flush_l2() -> None:
    """Read 128 MiB (over twice the H100's 50 MB L2) so the next launch
    reads its pages from device memory with the cache full of clean
    lines, as in the engine, where each attention call follows the
    layer's weight reads."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.ones(32 * 2**20, device="cuda"))
    _L2_FLUSH[0].sum()


# cycles the card spins before each timed call (~0.5 ms), so that the host
# has enqueued the call before the start event is reached
_HOLD_CYCLES = 1_000_000


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` with a cold L2 before each call
    (the flush runs outside the timed interval). Before the start event the
    card spins for ~0.5 ms (torch.cuda._sleep) while the host enqueues the
    call, so the interval holds the call's device time and not the host's
    launch overhead (a wrapper's checks and ctypes call, ~0.1 ms, which a
    kernel of a few microseconds would otherwise wait for)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        _flush_l2()
        torch.cuda._sleep(_HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------ kernels

def _pools(num_pages, page_size, n_kv, d, gen):
    shape = (num_pages, page_size, n_kv, d)
    return (torch.randn(shape, device=gen.device, generator=gen),
            torch.randn(shape, device=gen.device, generator=gen))


def _tables(B, P, num_pages, gen, used=None):
    """[B, P] block tables of distinct random pages (never the scratch
    page 0); with ``used``, sequence b maps used[b] pages and the rest of
    its row is scratch, as the engine pads a table."""
    used = used or [P] * B
    perm = (torch.randperm(num_pages - 1, generator=gen, device=gen.device)
            + 1).tolist()
    table = torch.zeros(B, P, dtype=torch.int32)
    for b, n in enumerate(used):
        table[b, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    return table.to(gen.device)


# (COUNTS attribute, label) of the ragged kernel per pool storage type
K1_VARIANTS = {"fp32": ("COUNTS", "K1 ragged"),
               "int8": ("COUNTS_I8", "K1-q int8 ragged"),
               "fp8": ("COUNTS_F8", "K1-q fp8 ragged")}
# spans (start_pos, q_len, padded T) of the kernel checks
SPANS_MIXED = ([37, 40, 0, 0, 100], [1, 50, 0, 64, 20], 64)
SPANS_DECODE = ([0, 15, 16, 17, 31, 100, 255, 600], [1] * 8, 1)
SPANS_CHUNK = ([256], [256], 256)
# the GPT engine's short chunks: 1-8 rows padded to the 8-row bucket
SPANS_SHORT = ([512, 520, 523, 0, 100, 7, 0, 40], [8, 3, 1, 8, 5, 8, 0, 2], 8)


def _as_kind(k_pool, v_pool, kind, gen):
    """fp32 pools -> (k, v, k_scale, v_scale) of a ``kind`` pool: int8
    codes with seeded per-page, per-kv-head scales in [1e-3, 5.1e-2], or
    the float8_e4m3fn cast of the values; fp32 as given."""
    if kind == "fp32":
        return k_pool, v_pool, None, None
    if kind == "fp8":
        return (k_pool.to(torch.float8_e4m3fn),
                v_pool.to(torch.float8_e4m3fn), None, None)
    codes = [torch.randint(-127, 128, k_pool.shape, device=gen.device,
                           generator=gen, dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.rand(k_pool.shape[0], k_pool.shape[2], device=gen.device,
                         generator=gen) * 0.05 + 1e-3 for _ in range(2)]
    return (*codes, *scales)


def check_ragged(n_q, n_kv, gen, label, kind="fp32", spans=SPANS_MIXED):
    """K1 (fp32 pools) or K1-q (int8 / fp8 pools) against ragged_reference
    on the same operands; returns the max abs error."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_reference,
    )
    d, ps = 128, 16
    start, qlen, T = spans
    B = len(start)
    P = -(-(max(start) + T) // ps)
    k_pool, v_pool = _pools(B * P + 1, ps, n_kv, d, gen)
    k, v, ks, vs = _as_kind(k_pool, v_pool, kind, gen)
    table = _tables(B, P, B * P + 1, gen)
    for b, n in enumerate(qlen):
        if n == 0:
            table[b] = 0                          # dead slot: all scratch
    q = torch.randn(B, T, n_q, d, device=gen.device, generator=gen)
    st = torch.tensor(start, dtype=torch.int32, device=gen.device)
    ql = torch.tensor(qlen, dtype=torch.int32, device=gen.device)
    out = ragged_paged_attention(q, k, v, table, st, ql, k_scale=ks,
                                 v_scale=vs)
    ref = ragged_reference(q, k, v, table, st, ql, k_scale=ks, v_scale=vs)
    err = (out - ref).abs().max().item()
    name = K1_VARIANTS[kind][1]
    for b in range(B):
        if not bool((out[b, qlen[b]:] == 0).all()):
            raise AssertionError(f"{name} {label}: rows past q_len of "
                                 f"sequence {b} are not exactly 0")
    log(f"kernel {name} {label} (n_q={n_q}, n_kv={n_kv}, d={d}, ps={ps}, "
        f"T={T}, spans start={start} q_len={qlen}): max_abs_err={err:.3e}, "
        "padded and dead rows exactly 0")
    if not err <= TOL:
        raise AssertionError(f"{name} {label}: max_abs_err {err} > {TOL}")
    return err


def check_paged(gen, h=32, label=""):
    """K2 at ``h`` heads against paged_decode_reference over the engine's
    4096-key table:
    pos on and off page and split boundaries, walks of one split and of
    many (up to the table's last key, 4095), pos past the table (capped)
    and a dead slot (all-scratch table, pos 0). Then batch invariance: each
    sequence alone must give its batch output bit for bit."""
    from paddle_tpu_torch.ops.paged_attention import (
        KEYS_PER_SPLIT, paged_decode_attention, paged_decode_reference,
    )
    b, d, ps, P = 12, 128, 16, 256
    pos = [0, 15, 16, 17, KEYS_PER_SPLIT - 1, KEYS_PER_SPLIT, 600, 1000,
           2049, 4095, 5000, 0]
    k_pool, v_pool = _pools(b * P + 1, ps, h, d, gen)
    table = _tables(b, P, b * P + 1, gen)
    table[-1] = 0                                 # dead slot: all scratch
    q = torch.randn(b, h, d, device=gen.device, generator=gen)
    p = torch.tensor(pos, dtype=torch.int32, device=gen.device)
    out = paged_decode_attention(q, k_pool, v_pool, table, p)
    ref = paged_decode_reference(q, k_pool, v_pool, table, p)
    err = (out - ref).abs().max().item()
    log(f"kernel K2 paged_decode{label} (b={b}, h={h}, d={d}, ps={ps}, P={P}, "
        f"{KEYS_PER_SPLIT} keys a split, pos={pos}, the last a dead slot): "
        f"max_abs_err={err:.3e}")
    if not (err <= TOL and bool(torch.isfinite(out).all())):
        raise AssertionError(f"K2: max_abs_err {err} > {TOL}")
    differ = [i for i in range(b) if not torch.equal(
        paged_decode_attention(q[i:i + 1], k_pool, v_pool, table[i:i + 1],
                               p[i:i + 1])[0], out[i])]
    log(f"kernel K2 batch invariance: each of the {b} sequences alone "
        f"equals its batch output bit for bit: {not differ}")
    if differ:
        raise AssertionError(f"K2: sequences {differ} differ alone from "
                             "their batch output")
    return err


def fp64_ratio(kern, plain, exact) -> float:
    """The kernel's max error against the fp64 evaluation over the fp32
    plain version's own."""
    e_kernel = (kern.double() - exact).abs().max().item()
    e_plain = (plain.double() - exact).abs().max().item()
    return e_kernel / e_plain


def signed_error(x, exact) -> float:
    """The mean error against the fp64 evaluation in the direction of the
    exact value, over its mean magnitude: below 0, a result shrunk toward
    zero (a bias rounding to nearest does not have)."""
    return ((x.double() - exact) * exact.sign()).mean().item() \
        / exact.abs().mean().item()


def measure_ragged(gen, n_heads, num_blocks, P, kind="fp32",
                   spans=SPANS_CHUNK, n_kv=None):
    """K1 / K1-q at an engine shape, 7B heads (MHA, or ``n_kv`` kv heads):
    by default the second 256-token chunk of a longer prompt (keys 0..511
    visible), or the decode step of the engine's sequences (T = 1). Held
    against the plain version in fp32 (1e-4) and in fp64 (within twice the
    fp32 plain version's error), then timed."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        dequantize_pages, ragged_form, ragged_paged_attention,
        ragged_reference,
    )
    d, ps = 128, 16
    n_kv = n_kv or n_heads
    start, qlen, T = spans
    B = len(start)
    k_pool, v_pool = _pools(num_blocks, ps, n_kv, d, gen)
    k, v, ks, vs = _as_kind(k_pool, v_pool, kind, gen)
    del k_pool, v_pool
    pages = [-(-(s + T) // ps) for s in start]   # pages each walk reads
    table = _tables(B, P, num_blocks, gen, used=pages)
    q = torch.randn(B, T, n_heads, d, device="cuda", generator=gen)
    st = torch.tensor(start, dtype=torch.int32, device="cuda")
    ql = torch.tensor(qlen, dtype=torch.int32, device="cuda")
    args = (q, k, v, table, st, ql)
    kw = dict(k_scale=ks, v_scale=vs)
    form = ragged_form(n_heads // n_kv, T)
    name = f"{K1_VARIANTS[kind][1]} {form} form"
    out = ragged_paged_attention(*args, **kw)
    ref = ragged_reference(*args, **kw)
    err = (out - ref).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"{name} engine shape: max_abs_err {err} > "
                             f"{TOL}")
    pools64 = (k.double(), v.double()) if kind == "fp32" else (k, v)
    exact = ragged_reference(q.double(), *pools64, table, st, ql, **kw)
    ratio = fp64_ratio(out, ref, exact)
    bias = (signed_error(out, exact), signed_error(ref, exact))
    del exact
    log(f"{name} vs fp64 at q[{B},{T},{n_heads},{d}], {n_kv} kv heads: "
        f"kernel error {ratio:.2f}x the fp32 plain version's; mean signed "
        f"error kernel {bias[0]:+.2e}, plain {bias[1]:+.2e}")
    if not ratio <= 2.0:
        raise AssertionError(f"{name}: error against fp64 {ratio:.2f}x the "
                             "fp32 plain version's, above 2x")
    ms = median_ms(lambda: ragged_paged_attention(*args, **kw))
    plain = median_ms(lambda: ragged_reference(*args, **kw), iters=5)
    # library yardstick: SDPA over the visible keys, gathered (and
    # dequantized) beforehand, kv heads repeated for GQA
    L = max(s + T for s in start)
    idx = table[:, :-(-L // ps)].long()
    kg, vg = ((dequantize_pages(pool, idx, sc).flatten(1, 2)[:, :L]
               .repeat_interleave(n_heads // n_kv, dim=2)
               .transpose(1, 2).contiguous())
              for pool, sc in ((k, ks), (v, vs)))
    qT = q.transpose(1, 2).contiguous()
    mask = (torch.arange(L, device="cuda")[None, None, :]
            <= (st.long()[:, None, None]
                + torch.arange(T, device="cuda")[None, :, None]))[:, None]
    lib = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qT, kg, vg, attn_mask=mask))
    # the least work: each visible K/V row read once (1 byte per element
    # on int8 / fp8 pools, plus one fp32 scale per page and kv head for
    # K and V on int8), the table entries walked, q read and out written;
    # 4*d FLOPs per visible (row, key, query head)
    keys = sum(s + T for s in start)
    elem = 4 if kind == "fp32" else 1
    nbytes = (4 * 2 * q.numel() + elem * 2 * keys * n_kv * d
              + 4 * (sum(pages) + 2 * B))
    if kind == "int8":
        nbytes += 4 * 2 * sum(pages) * n_kv
    flops = 4 * d * n_heads * sum(s + t + 1 for s in start for t in range(T))
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_ACCURATE_FLOP_PER_S
    return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib, fp64_ratio=ratio,
                shape=f"q[{B},{T},{n_heads},{d}] start_pos={start} "
                      f"{kind} pool[{num_blocks},{ps},{n_kv},{d}] "
                      f"table[{B},{P}] ({form} form)")


def measure_paged(gen, n_heads, num_blocks, P, positions):
    """K2 at the engine's decode shape: 8 sequences at ``positions``. Held
    against the plain version in fp32 (1e-4) and in fp64 (within twice the
    fp32 plain version's error), then timed."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_reference,
    )
    b, d, ps = len(positions), 128, 16
    k_pool, v_pool = _pools(num_blocks, ps, n_heads, d, gen)
    table = _tables(b, P, num_blocks, gen,
                    used=[p // ps + 1 for p in positions])
    q = torch.randn(b, n_heads, d, device="cuda", generator=gen)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    out = paged_decode_attention(q, k_pool, v_pool, table, pos)
    ref = paged_decode_reference(q, k_pool, v_pool, table, pos)
    err = (out - ref).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"K2 engine shape: max_abs_err {err} > {TOL}")
    exact = paged_decode_reference(q.double(), k_pool.double(),
                                   v_pool.double(), table, pos)
    ratio = fp64_ratio(out, ref, exact)
    bias = (signed_error(out, exact), signed_error(ref, exact))
    del exact
    log(f"K2 vs fp64 at q[{b},{n_heads},{d}]: kernel error {ratio:.2f}x the "
        f"fp32 plain version's; mean signed error kernel {bias[0]:+.2e}, "
        f"plain {bias[1]:+.2e}")
    if not ratio <= 2.0:
        raise AssertionError(f"K2: error against fp64 {ratio:.2f}x the fp32 "
                             "plain version's, above 2x")
    ms = median_ms(lambda: paged_decode_attention(q, k_pool, v_pool, table,
                                                  pos))
    plain = median_ms(lambda: paged_decode_reference(q, k_pool, v_pool,
                                                     table, pos), iters=5)
    L = max(positions) + 1
    npages = -(-L // ps)
    idx = table[:, :npages].long()
    kg = k_pool[idx].reshape(b, npages * ps, n_heads, d)[:, :L]
    vg = v_pool[idx].reshape(b, npages * ps, n_heads, d)[:, :L]
    kg, vg = (t.transpose(1, 2).contiguous() for t in (kg, vg))
    qT = q[:, :, None, :]
    mask = (torch.arange(L, device="cuda")[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    lib = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qT, kg, vg, attn_mask=mask))
    keys = sum(p + 1 for p in positions)
    nbytes = 4 * (2 * q.numel() + 2 * keys * n_heads * d) + 4 * b * (P + 1)
    flops = 4 * d * n_heads * keys
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_ACCURATE_FLOP_PER_S
    return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib, fp64_ratio=ratio,
                shape=f"q[{b},{n_heads},{d}] pos={positions} "
                      f"pool[{num_blocks},{ps},{n_heads},{d}] table[{b},{P}]")


# ------------------------------------------------------------- engine

def check_against_naive(runner, prompt, out_tokens, sp, max_model_len):
    """The engine's tokens must equal naive_generate's, token for token."""
    from paddle_tpu_torch.serving import naive_generate
    ref = naive_generate(runner, prompt, sp, max_model_len=max_model_len)
    if ref != out_tokens:
        first = next((i for i, (a, b) in enumerate(zip(ref, out_tokens))
                      if a != b), min(len(ref), len(out_tokens)))
        raise AssertionError(
            f"engine tokens differ from naive_generate first at step {first}:"
            f" engine {out_tokens[first:first + 4]}, naive "
            f"{ref[first:first + 4]}")
    return "token-exact"


def _all_counts():
    """(name, LaunchCounts) of every serving kernel wrapper."""
    import paddle_tpu_torch.ops.paged_attention as k2
    import paddle_tpu_torch.ops.ragged_paged_attention as k1
    return (("ragged_paged_attention", k1.COUNTS),
            ("ragged_paged_attention_int8", k1.COUNTS_I8),
            ("ragged_paged_attention_fp8", k1.COUNTS_F8),
            ("paged_decode_attention", k2.COUNTS))


def engine_phase(model, cfg, kv_dtype="fp32", seed=0, n_requests=8,
                 max_tokens=32, ref_tokens=None, max_model_len=4096):
    """Serve the seeded requests from a ``kv_dtype`` pool through
    create_serving_engine and gate the run (phases 4, 6 and 25). Returns
    the engine, the launches of each kernel of the path, the decode
    positions for phase 8 and every request's tokens."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.serving import SamplingParams

    t0 = time.perf_counter()
    eng = create_serving_engine(
        model, device="cuda", block_size=16, num_blocks=1024,
        max_batch_size=8, max_model_len=max_model_len,
        max_prefill_tokens_per_step=256, kv_dtype=kv_dtype, audit=True)
    m = eng.metrics
    n_kv = getattr(cfg, "num_kv_heads", cfg.num_heads)
    log(f"engine setup ({kv_dtype} KV): {type(model).__name__}, "
        f"{cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, heads {cfg.num_heads}/{n_kv}, fp32 "
        f"weights {sum(p.numel() for p in model.parameters()) * 4 / 2**30:.2f}"
        f" GiB, pool {eng.pool.memory_bytes() / 2**30:.3f} GiB "
        f"(kv_bytes_reduction_x {m.kv_bytes_reduction_x.value:.4f}), "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    lens = rng.integers(100, 601, n_requests)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    sp = SamplingParams(max_tokens=max_tokens)

    counts = _all_counts()
    for _, c in counts:
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    ids = [eng.add_request(p, sp) for p in prompts]
    decode_ms = []
    t_run = time.perf_counter()
    while eng.has_work():
        chunks = m.prefill_chunks.value
        t = time.perf_counter()
        eng.step()      # ends in a blocking drain of the step's tokens
        if m.prefill_chunks.value == chunks:
            decode_ms.append(1e3 * (time.perf_counter() - t))
    wall = time.perf_counter() - t_run
    kernel = {name: c.kernel_launches for name, c in counts}
    forms = {name: dict(c.form_launches) for name, c in counts
             if c.form_launches}
    plain = sum(c.plain_launches for _, c in counts)
    outs = eng.outputs()
    log(f"engine run ({kv_dtype} KV): {len(outs)}/{n_requests} finished, "
        f"prompt lens {lens.tolist()}, {int(m.tokens_generated.value)} tokens"
        f" in {wall:.3f} s = {m.tokens_generated.value / wall:.1f} tokens/s, "
        f"TTFT mean {1e3 * m.ttft_s.mean:.1f} ms p50 "
        f"{1e3 * m.ttft_s.percentile(50):.1f} ms, {len(decode_ms)} "
        f"decode-only steps mean {statistics.mean(decode_ms):.2f} ms, "
        f"{int(m.prefill_chunks.value)} prefill chunks, "
        f"{m.batch_occupancy.count} decode calls, "
        f"{int(m.preemptions.value)} preemptions, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"engine launches ({kv_dtype} KV): {kernel}, by form {forms}, "
        f"plain launches {plain}")
    if len(outs) != n_requests or any(
            o.finish_reason != "length" or len(o.output_tokens) != max_tokens
            for o in outs.values()):
        raise AssertionError("not every request finished with max_tokens")
    if kv_dtype == "fp32":
        path = ("ragged_paged_attention", "paged_decode_attention")
        if min(kernel[n] for n in path) == 0:
            raise AssertionError(f"main path missed a kernel: {kernel}")
        # MHA decode: K2 once a layer on every decode call
        calls = m.batch_occupancy.count
        if kernel[path[1]] != cfg.num_layers * calls:
            raise AssertionError(
                f"{path[1]} launched {kernel[path[1]]} times, not "
                f"{cfg.num_layers} layers x {calls} decode calls")
    else:
        # K1-q on every prefill chunk and every decode call, once a layer
        path = (f"ragged_paged_attention_{kv_dtype}",)
        calls = int(m.prefill_chunks.value) + m.batch_occupancy.count
        if kernel[path[0]] != cfg.num_layers * calls:
            raise AssertionError(
                f"{path[0]} launched {kernel[path[0]]} times, not "
                f"{cfg.num_layers} layers x {calls} calls")
        # chunks take the span form, decode steps (G = 1) the decode form
        if set(forms.get(path[0], {})) != {"span", "decode"}:
            raise AssertionError(f"{path[0]} did not launch both forms: "
                                 f"{forms}")
    if plain != 0 or any(n not in path and k for n, k in kernel.items()):
        raise AssertionError(f"the {kv_dtype} path launched another kernel "
                             f"or a plain version: {kernel}, plain {plain}")
    if not eng.pool.allocator.check_no_leaks():
        raise AssertionError("engine leaked KV pages")
    tokens = [outs[i].output_tokens for i in ids]
    # the longest prompt (prefilled in three chunks) and the shortest
    checked = (int(np.argmax(lens)), int(np.argmin(lens)))
    if kv_dtype == "fp32":
        for i in checked:
            verdict = check_against_naive(eng.runner, prompts[i], tokens[i],
                                          sp, max_model_len)
            log(f"naive_generate check ({kv_dtype} KV), request {i} (prompt "
                f"{lens[i]}): {verdict}")
    else:
        # reported, not gated: cuBLAS rounds a row of x @ w differently
        # for another row count (gemm_row_invariance), the batch-8 engine
        # and naive_generate run other row counts, and 1-byte K/V turn
        # those 1-ulp differences into whole quantization steps
        from paddle_tpu_torch.serving import naive_generate
        refs = [naive_generate(eng.runner, prompts[i], sp,
                               max_model_len=max_model_len)
                for i in checked]
        _agreement(f"{kv_dtype} engine vs its naive_generate on requests "
                   f"{list(checked)}", [tokens[i] for i in checked], refs)
        _agreement(f"{kv_dtype} engine vs fp32 engine", tokens, ref_tokens)
    positions = [int(n) + max_tokens // 2 for n in lens]
    return (eng, {n: kernel[n] for n in path}, positions, tokens, prompts,
            {n: forms.get(n, {}) for n in path})


def _agreement(label, tokens, refs):
    same = sum(int(a == b) for t, r in zip(tokens, refs) for a, b in zip(t, r))
    total = sum(map(len, refs))
    first = [next((j for j, (a, b) in enumerate(zip(t, r)) if a != b), None)
             for t, r in zip(tokens, refs)]
    log(f"{label} (reported, not gated): greedy agreement {same}/{total} "
        f"tokens = {same / total:.4f}; first divergence per request {first}")


def gemm_row_invariance(gen, ms=(1, 8, 16, 256, 1024)):
    """Whether cuBLAS's fp32 x @ w gives row 0 the same bits at every row
    count M, for the runner's four weight shapes at 7B width."""
    same = {}
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)):
        w = torch.randn(k, n, device="cuda", generator=gen) * 0.02
        x = torch.randn(max(ms), k, device="cuda", generator=gen)
        row = {m: (x[:m] @ w)[0] for m in ms}
        same[f"{k}x{n}"] = [m for m in ms if torch.equal(row[m], row[1])]
    log(f"gemm row invariance: row counts M whose row 0 of x[:M] @ w equals "
        f"M=1's bit for bit, per weight shape: {json.dumps(same)}")


def single_slot_check(model, cfg, kv_dtype, prompts, max_tokens=32):
    """An engine with one slot serves each prompt in one prefill chunk and
    then batch-1 decode steps: the row counts of naive_generate, so its
    tokens must equal naive_generate's exactly (int8 scales too: both
    write the same chunks), through K1-q alone."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.serving import SamplingParams

    eng = create_serving_engine(
        model, device="cuda", block_size=16, num_blocks=128,
        max_batch_size=1, max_model_len=1024,
        max_prefill_tokens_per_step=256, kv_dtype=kv_dtype, audit=True)
    sp = SamplingParams(max_tokens=max_tokens)
    counts = _all_counts()
    for _, c in counts:
        c.reset()
    ids = [eng.add_request(p, sp) for p in prompts]
    outs = eng.run()
    kernel = {name: c.kernel_launches for name, c in counts}
    name = f"ragged_paged_attention_{kv_dtype}"
    calls = int(eng.metrics.prefill_chunks.value) + \
        eng.metrics.batch_occupancy.count
    if (kernel[name] != cfg.num_layers * calls or sum(kernel.values())
            != kernel[name] or any(c.plain_launches for _, c in counts)):
        raise AssertionError(f"single-slot {kv_dtype} engine: {kernel}")
    if not eng.pool.allocator.check_no_leaks():
        raise AssertionError("single-slot engine leaked KV pages")
    for rid, p in zip(ids, prompts):
        verdict = check_against_naive(eng.runner, p, outs[rid].output_tokens,
                                      sp, 1024)
        log(f"naive_generate check ({kv_dtype} KV, one slot), prompt "
            f"{len(p)}: {verdict}")


def quant_paths(model, runner_cls, kind, seed=2, chunks=(256, 256),
                steps=8, rows=(2,)):
    """``model`` (full width) served by ``runner_cls`` from a ``kind``
    pool: prefill chunks of ``chunks`` tokens (a chunk of at most 8 takes
    K1's decode form) and ``steps`` decode steps whose batch holds the
    sequence in row 0 beside dead slots (``rows[i % len(rows)]`` rows at
    step i); through the kernels, then the same calls on the plain gather
    path from fresh pools. Every count is set to 0 before the kernel run,
    and the reference run must add none. Returns each run's logits of
    every call (row 0), the kernel run's launches {name: (kernel, plain,
    forms)} and each run's pools."""
    from paddle_tpu_torch.serving import KVCachePool

    cfg = model.cfg
    ps, P = 16, 64
    n = sum(chunks)
    prompt = np.random.default_rng(seed).integers(
        1, cfg.vocab_size, n).tolist()

    def run(attn_impl, feed):
        runner = runner_cls(model, block_size=ps, max_model_len=ps * P,
                            attn_impl=attn_impl, kv_dtype=kind)
        pool = KVCachePool(cfg.num_layers, 1 + P, ps, runner.n_kv_heads,
                           runner.head_dim, device="cuda", kv_dtype=kind)
        table = pool.pad_table(pool.allocator.alloc(P), P)
        pools, logits, start = pool.pools, [], 0
        for c in chunks:
            lg, pools = runner.prefill_chunk(prompt[start:start + c], start,
                                             table, pools)
            logits.append(lg)
            start += c
        for i in range(steps):
            if len(feed) <= i:
                feed.append(int(torch.argmax(logits[-1])))
            dead = rows[i % len(rows)] - 1             # rows 1.. are dead
            lg, pools = runner.decode(
                np.asarray([feed[i]] + [0] * dead, np.int32),
                np.asarray([table] + [[0] * P] * dead, np.int32),
                np.asarray([n + i] + [0] * dead, np.int32), pools)
            logits.append(lg[0])
        return logits, pools

    counts = _all_counts()
    for _, c in counts:
        c.reset()
    feed = []
    out_k, pools_k = run("auto", feed)

    def now():
        return {name: (c.kernel_launches, c.plain_launches,
                       dict(c.form_launches)) for name, c in counts}

    launched = now()
    out_r, pools_r = run("reference", feed)
    if now() != launched:
        raise AssertionError(f"{runner_cls.__name__} {kind}: the reference "
                             f"run launched a kernel: {now()}")
    return out_k, out_r, launched, pools_k, pools_r


def quant_model_check(model, runner_cls, kind, want, gate=True, **kw):
    """Phases 7 and 25: quant_paths' two runs. The kernel run must launch
    exactly ``want`` ({name: (kernel launches, {form: launches})}) and no
    plain version; every call's logits within TOL of its max|logit|
    (reported only, with ``gate`` False). Over int8 / fp8 pools the share
    of K codes that differ between the two runs' pools is reported by
    layer: each run quantizes the K/V its own attention led to, so a
    last-bit difference upstream can move a code by one step, and that
    step is then read by every later layer and call."""
    out_k, out_r, launched, pools_k, pools_r = quant_paths(
        model, runner_cls, kind, **kw)
    got = {name: (k, forms) for name, (k, _, forms) in launched.items()
           if k}
    if got != want or any(p for _, p, _ in launched.values()):
        raise AssertionError(f"{runner_cls.__name__} {kind}: the kernel run "
                             f"launched {launched}, not {want}")
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(out_k, out_r))
    cfg = model.cfg
    codes = ""
    if kind != "fp32":
        share = [(a[0] != b[0]).float().mean().item()
                 for a, b in zip(pools_k, pools_r)]
        codes = (f"; K codes that differ between the runs' pools, by layer:"
                 f" {' '.join(f'{x:.2e}' for x in share)}")
    log(f"{runner_cls.__name__} {kind} pools, kernels {json.dumps(got)} vs "
        f"the gather path ({cfg.num_layers} layers, full width, chunks "
        f"{list(kw.get('chunks', (256, 256)))} + {kw.get('steps', 8)} "
        f"decode steps of {list(kw.get('rows', (2,)))} rows, all but one "
        f"dead): worst max|logit diff| / max|logit| {worst:.3e}"
        f"{'' if gate else ' (reported, not gated)'}{codes}")
    if gate and not worst <= TOL:
        raise AssertionError(f"{runner_cls.__name__} {kind}: logits differ "
                             f"from the gather path by {worst:.3e} > {TOL} "
                             "of their max")


# ---------------------------------------- sampling, graphs, horizons

SAMPLE_TEMPS = (0.3, 0.7, 1.0, 1.5)
SAMPLE_CONFIGS = ((None, None), (1, None), (50, None), (None, 0.9), (8, 0.9))


def sampler_phase(rows=64, vocab=32000):
    """The seeded sampler (`_sampled_rows`, every sampled token's path) on
    the card against the same function on the CPU: 64 rows of vocabulary
    32000, seeds 0-7 x steps 0-31 x the temperatures, for every (top_k,
    top_p); every token equal. A token that parts prints its perturbed
    top-2 margin (masked logits + Gumbel noise, on the CPU) and fails the
    run."""
    from paddle_tpu_torch.core import random as prandom
    from paddle_tpu_torch.models.generation import _masked_logits
    from paddle_tpu_torch.serving.model_runner import PagedModelRunner

    rng = np.random.default_rng(0)
    logits = torch.from_numpy(
        (rng.standard_normal((rows, vocab)) * 3).astype(np.float32))
    on_card = logits.cuda()
    grid = [(seed, step, t) for t in SAMPLE_TEMPS for step in range(32)
            for seed in range(8)]
    parted, total, card_ms = [], 0, []
    for top_k, top_p in SAMPLE_CONFIGS:
        for i in range(0, len(grid), rows):
            seeds, steps, temps = (torch.tensor(c) for c in
                                   zip(*grid[i:i + rows]))
            temps = temps.float()
            cpu = PagedModelRunner._sampled_rows(logits, seeds, steps, temps,
                                                 top_k, top_p)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            card = PagedModelRunner._sampled_rows(
                on_card, seeds.cuda(), steps.cuda(), temps.cuda(), top_k,
                top_p)
            end.record()
            card = card.cpu()
            card_ms.append(start.elapsed_time(end))
            total += len(seeds)
            for b in torch.nonzero(card != cpu).flatten().tolist():
                key = prandom.fold_in(prandom.key(seeds[b:b + 1]),
                                      steps[b:b + 1])
                noisy = (_masked_logits(logits[b:b + 1],
                                        temps[b:b + 1, None], top_k, top_p)
                         + prandom.gumbel(key, (vocab,)))[0]
                top2 = torch.topk(noisy, 2).values
                parted.append((int(seeds[b]), int(steps[b]),
                               float(temps[b]), top_k, top_p, int(card[b]),
                               int(cpu[b]), float(top2[0] - top2[1])))
    log(f"sampler: {total} draws ({rows} rows of vocab {vocab}, seeds 0-7 x "
        f"steps 0-31 x temperatures {list(SAMPLE_TEMPS)} x (top_k, top_p) "
        f"{list(SAMPLE_CONFIGS)}): card equals CPU on "
        f"{total - len(parted)}; card ms per {rows}-row call median "
        f"{statistics.median(card_ms):.3f} (first call included in max "
        f"{max(card_ms):.3f})")
    for seed, step, t, k, p, a, b, margin in parted:
        log(f"  parted: seed {seed} step {step} temperature {t} top_k {k} "
            f"top_p {p}: card {a} cpu {b}, perturbed top-2 margin "
            f"{margin:.3e}")
    if parted:
        raise AssertionError(f"{len(parted)} sampled tokens differ between "
                             "the card and the CPU")


def _count_inner_steps(runner):
    """Wrap a runner's decode calls to count the decode steps they run (a
    horizon of s counts s)."""
    seen = {"steps": 0}
    decode, multi = runner.decode, runner.decode_multi

    def counted_decode(*a, **kw):
        out = decode(*a, **kw)
        seen["steps"] += 1
        return out

    def counted_multi(tokens, tables, pos, pools, num_steps, **kw):
        out = multi(tokens, tables, pos, pools, num_steps, **kw)
        seen["steps"] += num_steps
        return out

    runner.decode, runner.decode_multi = counted_decode, counted_multi
    return seen


def graphs_phase(model, cfg, kv_dtype, B=8, seed=3):
    """A captured decode step, greedy horizon of 8 and seeded early-stop
    horizon of 8, each replayed from its graph and run eagerly on the same
    inputs over two copies of the same pools: outputs and pools equal bit
    for bit, the launches one replay credits equal to the eager call's.
    The first graphed call of a kind runs for real and captures; the
    second replays."""
    from paddle_tpu_torch.serving import KVCachePool, LlamaRunner

    runner = LlamaRunner(model, block_size=16, max_model_len=512,
                         kv_dtype=kv_dtype)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(100, 400, B)]
    P = 32
    pools, tables = [], None
    for _ in range(2):
        pool = KVCachePool(cfg.num_layers, B * P + 1, 16, runner.n_kv_heads,
                           runner.head_dim, device="cuda", kv_dtype=kv_dtype)
        rows = [pool.pad_table(pool.allocator.alloc(P), P) for _ in prompts]
        firsts = [int(torch.argmax(runner.prefill(p, r, pool.pools)[0]))
                  for p, r in zip(prompts, rows)]
        pools.append(pool.pools)
        tables = np.asarray(rows, np.int32)
    pos = np.asarray([len(p) for p in prompts], np.int32)
    fed = np.asarray(firsts, np.int32)
    ext = dict(seeds=np.arange(B), base_steps=np.ones(B, np.int32),
               temps=np.asarray([0.7] * (B // 2) + [0.0] * (B - B // 2),
                                np.float32), top_k=50, top_p=0.9,
               stop_ids=np.full((B, 1), -1, np.int32),
               remaining=np.full(B, 8, np.int32), early_stop=True)
    calls = [("decode", (), {}, 0), ("decode", (), {}, 1),
             ("decode_multi", (8,), {}, 2), ("decode_multi", (8,), {}, 10),
             ("decode_multi", (8,), ext, 18), ("decode_multi", (8,), ext, 26)]
    every = _all_counts()
    for i, (kind, n, kw, off) in enumerate(calls):
        args = (fed, tables, pos + off)
        c0 = [c.kernel_launches for _, c in every]
        runner.graphs = False
        eager, _ = getattr(runner, kind)(*args, pools[0], *n, **kw)
        eager = eager.clone()
        c1 = [c.kernel_launches for _, c in every]
        runner.graphs = True
        graphed, _ = getattr(runner, kind)(*args, pools[1], *n, **kw)
        torch.cuda.synchronize()
        c2 = [c.kernel_launches for _, c in every]
        launches_e = {nm: b - a for (nm, _), a, b in zip(every, c0, c1)
                      if b - a}
        launches_g = {nm: b - a for (nm, _), a, b in zip(every, c1, c2)
                      if b - a}
        diff = (graphed.double() - eager.double()).abs().max().item()
        label = kind + ("_x" if kw else "")
        how = "replay" if i % 2 else "first call (real run + capture)"
        log(f"graphs ({kv_dtype} KV) {label} {how}: bitwise equal to eager "
            f"{torch.equal(graphed, eager)}, max|diff| {diff:.3e}; launches "
            f"eager {launches_e}, graphed {launches_g}")
        if not torch.equal(graphed, eager) or launches_e != launches_g:
            raise AssertionError(f"graphs ({kv_dtype}): {label} {how} differs"
                                 " from the eager call")
        last = (torch.argmax(eager, dim=-1) if kind == "decode"
                else eager[0, :, -1])
        fed = last.to(torch.int32).cpu().numpy()
    plain = sum(c.plain_launches for _, c in every)
    same_pools = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                     for la, lb in zip(*pools) for a, b in zip(la, lb))
    for cap in runner.captures:
        log(f"graphs ({kv_dtype} KV) capture {cap['kind']} key {cap['key']}:"
            f" {cap['seconds']:.3f} s, graph pool "
            f"{cap['pool_bytes'] / 2**20:.1f} MiB")
    log(f"graphs ({kv_dtype} KV): pools bitwise equal after both runs "
        f"{same_pools}, plain launches {plain}")
    if not same_pools or plain:
        raise AssertionError(f"graphs ({kv_dtype}): pools differ or a plain "
                             "version ran")


def horizon_requests(cfg, seed=0, n=8, max_tokens=64, greedy_stops=None):
    """Phase 4's prompts with max_tokens 64: requests 0-3 greedy, 4-7 at
    temperature 0.7, top_k 50, top_p 0.9 and seeds 0-3; one stop token
    each (a greedy request's is its fp32 stream's 21st token)."""
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(seed)
    lens = rng.integers(100, 601, n)
    prompts = [rng.integers(1, cfg.vocab_size, int(k)).tolist()
               for k in lens]
    stops = np.random.default_rng(seed + 1).integers(1, cfg.vocab_size, n)
    sps = []
    for i in range(n):
        if i < n // 2:
            stop = greedy_stops[i] if greedy_stops else int(stops[i])
            sps.append(SamplingParams(max_tokens=max_tokens,
                                      stop_token_ids=(int(stop),)))
        else:
            sps.append(SamplingParams(
                max_tokens=max_tokens, temperature=0.7, top_k=50,
                top_p=0.9, seed=i - n // 2, stop_token_ids=(int(stops[i]),)))
    return prompts, sps


HORIZON_KNOBS = dict(decode_horizon=8, pipelined=True, horizon_sampling=True,
                     horizon_early_stop=True)


def horizon_phase(model, cfg, kv_dtype, greedy_stops):
    """The 8 requests served by the per-step engine, run eagerly, and by
    the engine with HORIZON_KNOBS, its decode kinds as CUDA graphs, each
    twice (the first round captures the graphs it needs, the second
    replays them): the streams equal token for token, every request
    finished, no page leaked; the attention kernel of the decode path (K2
    over fp32 pools, K1-q's decode form over int8 / fp8) launched once a
    layer on every inner decode step, the prefill kernel once a layer on
    every chunk, nothing else and no plain version. Returns the horizon
    engine's decode-kernel launches of its first round."""
    from paddle_tpu_torch.inference import create_serving_engine

    prompts, sps = horizon_requests(cfg, greedy_stops=greedy_stops)
    streams, launches = [], []
    for label, knobs in (("per-step, eager", {}),
                         ("horizon 8, pipelined, graphs", HORIZON_KNOBS)):
        eng = create_serving_engine(
            model, device="cuda", block_size=16, num_blocks=1024,
            max_batch_size=8, max_model_len=4096,
            max_prefill_tokens_per_step=256, kv_dtype=kv_dtype, audit=True,
            **knobs)
        eng.runner.graphs = bool(knobs)
        inner = _count_inner_steps(eng.runner)
        for rnd in (1, 2):
            tokens, kernel = _horizon_round(eng, cfg, f"{label}, round {rnd}",
                                            inner, prompts, sps)
            streams.append(tokens)
            launches.append(kernel)
        if knobs:
            horizon_profile(eng, cfg)
        del eng
        _free_the_card()
    for n, other in enumerate(streams[1:], 1):
        if other != streams[0]:
            for i, (a, b) in enumerate(zip(streams[0], other)):
                j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                if a != b:
                    log(f"  request {i}: first divergence at token {j}: "
                        f"per-step {a[j:j + 4]}, run {n} {b[j:j + 4]}")
            raise AssertionError(f"horizon ({kv_dtype}): run {n}'s streams "
                                 "differ from the per-step engine's")
    log(f"horizon ({kv_dtype} KV): the per-step and horizon engines' "
        f"streams are equal token for token in both rounds "
        f"({sum(map(len, streams[0]))} tokens a round)")
    return launches[2]


def _horizon_round(eng, cfg, label, inner, prompts, sps):
    """Serve the requests once on ``eng`` and gate the run (horizon_phase);
    returns the streams and the decode kernel's launches."""
    kv_dtype = eng.kv_dtype
    decode_kernel = ("paged_decode_attention" if kv_dtype == "fp32"
                     else f"ragged_paged_attention_{kv_dtype}")
    counts = _all_counts()
    for _, c in counts:
        c.reset()
    m = eng.metrics
    base = m.snapshot()
    inner0 = inner["steps"]
    ttft0 = m.ttft_s.count
    ids = [eng.add_request(p, sp) for p, sp in zip(prompts, sps)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    # decode-only steps: wall, tokens committed, inner steps launched
    dec = [0.0, 0, 0]
    while eng.has_work():
        chunks, toks0, i0 = (m.prefill_chunks.value,
                             m.tokens_generated.value, inner["steps"])
        t1 = time.perf_counter()
        eng.step()          # a drain ends every step (pipelined: mid-step)
        if m.prefill_chunks.value == chunks:
            dec[0] += time.perf_counter() - t1
            dec[1] += int(m.tokens_generated.value - toks0)
            dec[2] += inner["steps"] - i0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    outs = eng.outputs()
    kernel = {nm: c.kernel_launches for nm, c in counts}
    forms = {nm: dict(c.form_launches) for nm, c in counts
             if c.form_launches}
    plain = sum(c.plain_launches for _, c in counts)
    snap = m.snapshot()
    toks = snap["tokens_generated"] - base["tokens_generated"]
    syncs = snap["host_syncs"] - base["host_syncs"]
    steps = inner["steps"] - inner0
    ttft = m.ttft_s._samples[ttft0:]
    caps = [(c["kind"], c["key"][2] if len(c["key"]) > 2 else 1,
             round(c["seconds"], 3)) for c in eng.runner.captures]
    grew = {k: int(snap[k] - base[k]) for k in (
        "decode_horizon_steps", "horizon_overshoot_tokens")}
    log(f"horizon ({kv_dtype} KV) {label}: {int(toks)} tokens in "
        f"{wall:.3f} s = {toks / wall:.1f} tokens/s, TTFT mean "
        f"{1e3 * statistics.mean(ttft):.1f} ms, {steps} inner decode steps; "
        f"decode-only steps {1e3 * dec[0]:.1f} ms for {dec[1]} tokens = "
        f"{1e3 * dec[0] / max(dec[1], 1):.3f} ms per decode token, "
        f"{1e3 * dec[0] / max(dec[2], 1):.3f} ms per inner step; "
        f"host_syncs_per_token {syncs / toks:.4f}, {grew}, finish reasons "
        f"{sorted(outs[i].finish_reason for i in ids)}; captures so far "
        f"(kind, steps, s) {caps}")
    log(f"horizon ({kv_dtype} KV) {label} launches: {kernel}, by form "
        f"{forms}, plain {plain}")
    if any(outs.get(i) is None or outs[i].finish_reason not in
           ("stop", "length") for i in ids):
        raise AssertionError(f"horizon ({kv_dtype}) {label}: not every "
                             "request finished")
    if not eng.pool.allocator.check_no_leaks():
        raise AssertionError(f"horizon ({kv_dtype}) {label}: leaked pages")
    # K2 (fp32) or K1-q (int8 / fp8) once a layer on every inner decode
    # step, K1 / K1-q once a layer on every prefill chunk; a chunk of
    # G <= 8 rows takes K1-q's decode form too
    L = cfg.num_layers
    chunks = int(snap["prefill_chunks"] - base["prefill_chunks"])
    if kv_dtype == "fp32":
        want = {decode_kernel: L * steps, "ragged_paged_attention": L * chunks}
        decode_form = kernel[decode_kernel]
    else:
        want = {decode_kernel: L * (steps + chunks)}
        decode_form = forms.get(decode_kernel, {}).get("decode", 0)
    got = {nm: k for nm, k in kernel.items() if k}
    if got != want or plain or decode_form < L * steps:
        raise AssertionError(
            f"horizon ({kv_dtype}) {label}: launches {got}, want {want} for "
            f"{steps} inner decode steps and {chunks} prefill chunks of {L} "
            f"layers; decode form {decode_form}; plain {plain}")
    return [outs[i].output_tokens for i in ids], kernel[decode_kernel]


def horizon_profile(eng, cfg, steps=3, prompt_len=300):
    """Where a horizon's time goes: 8 greedy requests in decode on the
    horizon engine, `steps` steps (one horizon of 8 each, pipelined)
    timed, then as many under torch.profiler; device busy against the
    host wall, idle share."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(5)
    for _ in range(8):
        eng.add_request(rng.integers(1, cfg.vocab_size, prompt_len).tolist(),
                        SamplingParams(max_tokens=8 * (2 * steps + 3)))
    while eng.scheduler.waiting or any(
            r.phase == "prefill" for r in eng.scheduler.running) \
            or eng._inflight is None or eng._inflight.s != 8:
        eng.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    groups, top = _device_ms(prof)
    busy = sum(groups.values()) / steps
    per = {g: round(ms / steps, 4) for g, ms in
           sorted(groups.items(), key=lambda kv: -kv[1])}
    log(f"profile ({eng.kv_dtype} KV) horizon of 8 decode steps (8 "
        f"sequences, graph replay): host wall {wall:.3f} ms/horizon "
        f"({wall / 8:.3f} ms/step), device busy {busy:.3f} ms/horizon, idle "
        f"share {1 - busy / wall:.3f}; device ms/horizon by group "
        f"{json.dumps(per)}")
    for name, ms in top:
        log(f"  {ms / steps:.4f} ms/horizon  {name[:110]}")
    if busy == 0.0:
        log("  torch.profiler recorded no device time here: the device "
            "split of this window is not measured")
    eng.run()


# ------------------------------------------------------------ profile

FLASH_GROUPS = {"flash_fwd_bf16_wgmma_kernel": "K3a-bf16 flash_forward_bf16",
                "flash_bwd_dq_bf16_wgmma_kernel":
                    "K3b-dq-bf16 flash_backward_dq_bf16",
                "flash_bwd_dkv_bf16_wgmma_kernel":
                    "K3b-dkv-bf16 flash_backward_dkv_bf16",
                "flash_fwd_bf16_kernel": "K3a-bf16 flash_forward_bf16",
                "flash_bwd_dq_bf16_kernel":
                    "K3b-dq-bf16 flash_backward_dq_bf16",
                "flash_bwd_dkv_bf16_kernel":
                    "K3b-dkv-bf16 flash_backward_dkv_bf16",
                "flash_fwd_kernel": "K3a flash_forward",
                "flash_bwd_dq_kernel": "K3b-dq flash_backward_dq",
                "flash_bwd_dkv_kernel": "K3b-dkv flash_backward_dkv"}


def _kernel_group(name: str) -> str:
    low = name.lower()
    for kernel, group in FLASH_GROUPS.items():
        if kernel in name:
            return group
    if "paged_decode_kernel" in name:
        return "K2 paged_decode_attention"
    if "ragged_span_kernel" in name or "ragged_decode_kernel" in name:
        return "K1 ragged_paged_attention"
    if ("gemm" in low or "gemv" in low or "cutlass" in low or "xmma" in low
            or "nvjet" in low):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, norms, gathers)"


def _device_ms(prof):
    """{group: ms} and the top kernels of the device time the profiler
    recorded."""
    from torch.autograd import DeviceType
    groups, kernels = {}, {}
    for evt in prof.key_averages():
        # record_function ranges also show on the device's timeline; their
        # spans are not kernels and would count the time twice
        if evt.device_type != DeviceType.CUDA or \
                getattr(evt, "is_user_annotation", False):
            continue
        ms = 1e-3 * getattr(evt, "self_device_time_total",
                            getattr(evt, "self_cuda_time_total", 0.0))
        g = _kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + ms
        kernels[evt.key] = kernels.get(evt.key, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
    return groups, top


def profile_phase(eng, cfg, seed=1, n_requests=8, prompt_len=300,
                  steps=4):
    """Where a step's time goes (phases 5 and 6, K1 counting K1-q's
    launches on an int8 / fp8 pool): torch.profiler over (a) steps that each
    compute one fresh 256-token prefill chunk and nothing else, and (b)
    decode-only steps of 8 sequences. Device time is summed by kernel
    group; the idle share is 1 - device busy / host wall, the wall taken
    from as many unprofiled steps of the same work just before (the
    profiler's own host cost would inflate it)."""
    import paddle_tpu_torch.ops.paged_attention as k2
    import paddle_tpu_torch.ops.ragged_paged_attention as k1
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import SamplingParams

    rng = np.random.default_rng(seed)
    c1 = getattr(k1, K1_VARIANTS[eng.kv_dtype][0])   # K1 or K1-q

    def add(n, length, max_tokens):
        for _ in range(n):
            eng.add_request(rng.integers(1, cfg.vocab_size, length).tolist(),
                            SamplingParams(max_tokens=max_tokens))

    def timed_ms():
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            eng.step()      # ends in a blocking drain of the step's tokens
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / steps

    def window(label, wall):
        launches = (c1.kernel_launches, k2.COUNTS.kernel_launches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
        groups, top = _device_ms(prof)
        busy = sum(groups.values()) / steps
        n1 = c1.kernel_launches - launches[0]
        n2 = k2.COUNTS.kernel_launches - launches[1]
        per = {g: round(ms / steps, 4) for g, ms in
               sorted(groups.items(), key=lambda kv: -kv[1])}
        per_launch = {name: round(groups.get(g, 0.0) / n, 4)
                      for name, g, n in (
                          ("K1", "K1 ragged_paged_attention", n1),
                          ("K2", "K2 paged_decode_attention", n2)) if n}
        log(f"profile ({eng.kv_dtype} KV) {label}: host wall {wall:.3f} "
            f"ms/step, device busy {busy:.3f} ms/step, idle share {1 - busy / wall:.3f}; K1/K2 "
            f"launches per step {n1 / steps:.0f}/{n2 / steps:.0f}, device "
            f"ms per launch {json.dumps(per_launch)}; device ms/step by "
            f"group {json.dumps(per)}")
        for name, ms in top:
            log(f"  {ms / steps:.4f} ms/step  {name[:110]}")
        if busy == 0.0:
            log("  torch.profiler recorded no device time here: the device "
                "split of this window is not measured")

    # (a) prompts of exactly one budget and one token each: every step
    # prefills one of them in one chunk and finishes it, with no decode
    budget = eng.max_prefill_tokens_per_step
    add(2 * steps, budget, 1)
    window(f"prefill step (one {budget}-token chunk)", timed_ms())
    # (b) a full batch in decode
    add(n_requests, prompt_len, 32)
    while eng.scheduler.waiting or any(
            r.phase == "prefill" for r in eng.scheduler.running):
        eng.step()
    batch = len(eng.scheduler.decode_ready())
    window(f"decode step ({batch} sequences)", timed_ms())
    eng.run()
    if not eng.pool.allocator.check_no_leaks():
        raise AssertionError("engine leaked KV pages in the profile phase")


# ------------------------------------------------------------- flash

# (COUNTS key, replaced TPU kernel) of K3a, K3b-dq and K3b-dkv
FLASH_KERNELS = (
    ("flash_forward", "paddle_tpu/ops/pallas/flash_attention.py:251"),
    ("flash_backward_dq", "paddle_tpu/ops/pallas/flash_attention.py:312"),
    ("flash_backward_dkv", "paddle_tpu/ops/pallas/flash_attention.py:351"),
)
# the kernel function of each bf16 wrapper: (mma.sync, wgmma)
BF16_KERNEL_NAMES = {
    "flash_forward": ("flash_fwd_bf16_kernel", "flash_fwd_bf16_wgmma_kernel"),
    "flash_backward_dq": ("flash_bwd_dq_bf16_kernel",
                          "flash_bwd_dq_bf16_wgmma_kernel"),
    "flash_backward_dkv": ("flash_bwd_dkv_bf16_kernel",
                           "flash_bwd_dkv_bf16_wgmma_kernel"),
}


def check_flash(gen, b, sq, sk, h, d, causal):
    """K3a/K3b through the autograd.Function and torch.autograd.grad
    against the plain versions; returns each kernel's max abs error."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen,
                    requires_grad=True)
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen,
                        requires_grad=True) for _ in range(2))
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen)
    o = fa.flash_attention(q, k, v, causal=causal)
    grads = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        _, lse = fa.flash_forward(q, k, v, causal)
        ro, rlse = fa.flash_forward_reference(q, k, v, causal)
        refs = fa.flash_backward_reference(q, k, v, ro, do, rlse, causal)
    torch.cuda.synchronize()
    err = {"o": (o - ro).abs().max().item(),
           "lse": (lse - rlse).abs().max().item()}
    label = (f"b={b} sq={sq} sk={sk} h={h} d={d} "
             f"{'causal' if causal else 'full'}")
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"flash {label}: {name} is not finite")
        err[name] = (g - r).abs().max().item()
        # one key: the softmax is constant, the exact dq and dk are 0 and
        # both sides are rounding noise, held to dv's scale
        scale = r.abs().max().item()
        if sk == 1:
            scale = max(scale, refs[2].abs().max().item())
        if not err[name] <= TOL * scale:
            raise AssertionError(f"flash {label}: {name} max_abs_err "
                                 f"{err[name]:.3e} > {TOL} * {scale:.3e}")
    if not (err["o"] <= TOL and err["lse"] <= TOL):
        raise AssertionError(f"flash {label}: o/lse max_abs_err "
                             f"{err['o']:.3e}/{err['lse']:.3e} > {TOL}")
    return err


def flash_checks(gen):
    """Phase 9: the trainer's shape, then the sweep; returns the largest
    abs error of each kernel over all cases."""
    cases = [(1, 4096, 4096, 32, 128, True)]
    cases += [(1, s, s, 4, d, c) for d in (64, 128, 256)
              for c in (True, False) for s in (1, 100, 257, 1000)]
    cases += [(1, 128, 384, 4, d, True) for d in (64, 128, 256)]
    cases += [(1, 384, 128, 4, 128, True)]
    worst = {"flash_forward": 0.0, "flash_backward_dq": 0.0,
             "flash_backward_dkv": 0.0}
    for case in cases:
        err = check_flash(gen, *case)
        worst["flash_forward"] = max(worst["flash_forward"], err["o"],
                                     err["lse"])
        worst["flash_backward_dq"] = max(worst["flash_backward_dq"],
                                         err["dq"])
        worst["flash_backward_dkv"] = max(worst["flash_backward_dkv"],
                                          err["dk"], err["dv"])
        if case[1] == 4096:
            log(f"flash check b=1 s=4096 h=32 d=128 causal: max_abs_err "
                + ", ".join(f"{n} {e:.3e}" for n, e in err.items()))
    log(f"flash checks: {len(cases)} cases (the trainer's shape; d in "
        f"64/128/256 x causal/full x s in 1/100/257/1000; sq 128 < sk 384; "
        f"sq 384 > sk 128) within tolerance; worst abs errors "
        + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    return worst


def _flash_counts(masked=False, bf16=False):
    """{kernel: (kernel launches, plain launches)} of one form: dense or
    masked, fp32 or bf16."""
    from paddle_tpu_torch.ops import flash_attention as fa
    dtype = torch.bfloat16 if bf16 else torch.float32
    return {name: (c.kernel_launches, c.plain_launches)
            for name, c in fa.counts_for(masked, dtype).items()}


def _variant_launches(label, masked, bf16, d, total):
    """{kernel: {variant: launches}} of one form, checked: each kernel
    launched `total` times, all through the variant the entry points take
    for its dtype and head dim d (`kernel_variant`: the bf16 forward and
    dk/dv on wgmma at d <= 128)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    dtype = torch.bfloat16 if bf16 else torch.float32
    got = {name: dict(c.form_launches)
           for name, c in fa.counts_for(masked, dtype).items()}
    want = {name: {fa.kernel_variant(name, dtype, d): total} for name in got}
    if got != want:
        raise AssertionError(f"{label}: flash launches by variant {got}, "
                             f"not {want}")
    return got


def _other_flash_launches(masked, bf16) -> int:
    """Every flash launch, kernel or plain, of the three forms that are not
    (masked, bf16), plus that form's plain launches."""
    from paddle_tpu_torch.ops import flash_attention as fa
    ran = fa.counts_for(masked, torch.bfloat16 if bf16 else torch.float32)
    return sum(c.plain_launches + (0 if group is ran else c.kernel_launches)
               for group in fa.COUNTS.values() for c in group.values())


# ------------------------------------------------------ masked flash (K3-m)

@contextlib.contextmanager
def _plain_on_card():
    """The flash wrappers' plain branch on CUDA tensors: the plain versions
    run on the card, on the same operands (the checks' reference only)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    on_card = fa.on_card
    fa.on_card = lambda t: False
    try:
        yield
    finally:
        fa.on_card = on_card


def _padded(gen, b, s, lo=0.85):
    """[b, s] int64 attention mask, 1 on each row's first lengths drawn
    from [lo * s, s] (child_ernie's 85-100 % fill)."""
    lens = torch.randint(int(lo * s), s + 1, (b, 1), device="cuda",
                         generator=gen)
    return (torch.arange(s, device="cuda")[None, :] < lens).long()


def check_masked(gen, label, fn, b, sq, sk, h, d, masks=None,
                 dead_rows=None):
    """One masked form: o = fn(q, k, v) and its three gradients through the
    kernels, then through the plain versions on the same operands. o (and,
    with the canonical `masks`, lse) within TOL, each gradient within TOL *
    max|plain gradient|; the rows `dead_rows` (that see no key) exactly 0
    with zero dq. Returns each kernel's max abs error."""
    from paddle_tpu_torch.ops import flash_attention as fa
    q = torch.randn(b, sq, h, d, device="cuda", generator=gen)
    k, v = (torch.randn(b, sk, h, d, device="cuda", generator=gen)
            for _ in range(2))
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen)

    def run():
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = fn(qq, kk, vv)
        grads = torch.autograd.grad(o, (qq, kk, vv), do)
        lse = None
        if masks is not None:
            with torch.no_grad():
                lse = fa.flash_forward(q, k, v, masks[0],
                                       **masks[1]._asdict())[1]
        return o.detach(), lse, grads

    before = _flash_counts(masked=True)
    o, lse, grads = run()
    launched = {n: kl - before[n][0]
                for n, (kl, _) in _flash_counts(masked=True).items()}
    with _plain_on_card():
        ro, rlse, refs = run()
    torch.cuda.synchronize()
    if min(launched.values()) == 0:
        raise AssertionError(f"masked flash {label}: a masked kernel did not "
                             f"launch: {launched}")
    err = {"o": (o - ro).abs().max().item(),
           "lse": 0.0 if lse is None else (lse - rlse).abs().max().item()}
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"masked flash {label}: {name} not finite")
        err[name] = (g - r).abs().max().item()
        if not err[name] <= TOL * r.abs().max().item():
            raise AssertionError(
                f"masked flash {label}: {name} max_abs_err {err[name]:.3e} "
                f"> {TOL} * {r.abs().max().item():.3e}")
    if not (err["o"] <= TOL and err["lse"] <= TOL):
        raise AssertionError(f"masked flash {label}: o/lse max_abs_err "
                             f"{err['o']:.3e}/{err['lse']:.3e} > {TOL}")
    if dead_rows is not None and not (bool((o[:, dead_rows] == 0).all())
                                      and bool((grads[0][:, dead_rows] == 0)
                                               .all())):
        raise AssertionError(f"masked flash {label}: rows that see no key "
                             "are not exactly 0 with zero dq")
    log(f"masked flash {label} (b={b} sq={sq} sk={sk} h={h} d={d}): "
        + ", ".join(f"{n} {e:.3e}" for n, e in err.items())
        + ("; dead rows exactly 0, dq 0" if dead_rows is not None else ""))
    return {"flash_forward": max(err["o"], err["lse"]),
            "flash_backward_dq": err["dq"],
            "flash_backward_dkv": max(err["dk"], err["dv"])}


def _csr(b, h, M, gen):
    """sparse_attention's CSR pattern: each row sees a local window of 16
    keys in its own 128-block and two keys drawn from the blocks up to
    its own, so blocks above the diagonal stay dead."""
    rows = []
    for _ in range(b * h):
        for r in range(M):
            blk = r // 128 * 128
            cols = {blk + (r - blk) // 16 * 16 + j for j in range(16)}
            cols |= set(torch.randint(0, blk + 1, (2,), generator=gen,
                                      device=gen.device).tolist())
            rows.append(sorted(cols))
    lens = torch.tensor([len(c) for c in rows]).reshape(b * h, M)
    offset = torch.zeros(b * h, M + 1, dtype=torch.int64)
    offset[:, 1:] = lens.cumsum(1)
    nnz = int(offset[:, -1].max())
    columns = torch.zeros(b * h, nnz, dtype=torch.int64)
    for i in range(b * h):
        flat = [c for cols in rows[i * M:(i + 1) * M] for c in cols]
        columns[i, :len(flat)] = torch.tensor(flat)
    return (offset.reshape(b, h, M + 1).cuda(),
            columns.reshape(b, h, nnz).cuda())


def masked_checks(gen):
    """Phase 10: every masked form through the kernels against the plain
    versions (d 64 and 128, lengths on and off multiples of 64, sq != sk),
    then the entry points over them; returns each kernel's worst error."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import impl
    worst = dict.fromkeys(("flash_forward", "flash_backward_dq",
                           "flash_backward_dkv"), 0.0)

    def form(label, b, sq, sk, h, d, causal, dead_rows=None, **kw):
        def fn(q, k, v):
            return fa.flash_attention(q, k, v, causal=causal, **kw)
        qs = torch.empty(b, sq, h, d, device="cuda")
        ks = torch.empty(b, sk, h, d, device="cuda")
        masks = (causal, fa.canonical_masks(qs, ks, ks, causal, **kw))
        err = check_masked(gen, label, fn, b, sq, sk, h, d, masks, dead_rows)
        for n, e in err.items():
            worst[n] = max(worst[n], e)

    def entry(label, fn, b, sq, h, d):
        err = check_masked(gen, label, fn, b, sq, sq, h, d)
        for n, e in err.items():
            worst[n] = max(worst[n], e)

    att = _padded(gen, 2, 512)
    form("kbias, ERNIE's -1e4 key padding", 2, 512, 512, 12, 64, False,
         mask=(1.0 - att[:, None, None, :].float()) * -1e4)
    form("kbias, bool key padding, causal", 2, 200, 333, 4, 128, True,
         mask=_padded(gen, 2, 333, 0.5)[:, None, None, :].bool())
    m = torch.randn(2, 1, 300, 300, device="cuda", generator=gen) * 2
    m.masked_fill_(torch.rand(m.shape, device="cuda", generator=gen) < 0.3,
                   fa.NEG_INF)
    form("additive mask, mh = 1", 2, 300, 300, 4, 64, False, mask=m)
    m = torch.randn(1, 4, 256, 256, device="cuda", generator=gen)
    m.masked_fill_(torch.rand(m.shape, device="cuda", generator=gen) < 0.3,
                   fa.NEG_INF)
    form("additive mask, mh = h, causal", 1, 256, 256, 4, 128, True, mask=m)
    keep = torch.rand(2, 1, 100, 160, device="cuda", generator=gen) < 0.7
    keep[:, :, 50:] = False
    form("bool mask, rows 50.. see no key", 2, 100, 160, 4, 64, False,
         dead_rows=slice(50, None), mask=keep)
    cuts = torch.randint(1, 384, (2, 3), device="cuda", generator=gen)
    seg = (torch.arange(384, device="cuda")[None, :, None]
           >= cuts.sort(1).values[:, None, :]).sum(-1)
    form("segment ids, causal", 2, 384, 384, 4, 128, True, segment_ids=seg)
    # a dense mask that hides the off-diagonal 128-blocks, and the block
    # mask it implies: skipping those tiles must change nothing
    m = torch.randn(1, 1, 512, 512, device="cuda", generator=gen)
    blocks = torch.eye(4, dtype=torch.int32, device="cuda")
    blocks[3, 0] = 1
    live = fa._block_live(blocks, 512, 512)
    m.masked_fill_(~live, fa.NEG_INF)
    form("block mask implied by a dense mask", 1, 512, 512, 4, 64, False,
         mask=m, block_mask=blocks)

    lens = [100, 257, 64]
    cu = torch.tensor([0, 100, 357, 421], dtype=torch.int32, device="cuda")
    entry(f"flash_attn_unpadded causal, lengths {lens}",
          lambda q, k, v: impl.flash_attn_unpadded(
              q[0], k[0], v[0], cu, cu, causal=True)[None],
          1, sum(lens), 4, 64)
    lo = torch.randint(0, 321, (1, 1, 320, 1), device="cuda", generator=gen)
    hi = torch.maximum(lo, torch.randint(0, 321, lo.shape, device="cuda",
                                         generator=gen))
    entry("flashmask_attention causal (LTS, LTE)",
          lambda q, k, v: impl.flashmask_attention(
              q, k, v, torch.cat([lo, hi], -1).int(), causal=True),
          1, 320, 4, 128)
    entry("flashmask_attention full window (32, 64)",
          lambda q, k, v: impl.flashmask_attention(
              q, k, v, window_size=(32, 64)), 2, 256, 4, 64)
    offset, columns = _csr(1, 4, 256, gen)
    kpm = _padded(gen, 1, 256, 0.7)
    entry("sparse_attention with key_padding_mask",
          lambda q, k, v: impl.sparse_attention(
              q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
              offset, columns, key_padding_mask=kpm).transpose(1, 2),
          1, 256, 4, 64)
    log("masked flash checks: 11 forms within tolerance; worst abs errors "
        + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    return worst


def trainer_phase(cfg, seed=0, warmup=2, steps=6, seq=4096, amp_level=None):
    """Phases 11 and 22, the training path: TrainStep + AdamW over seeded
    random weights and one seeded batch, fp32 or (amp_level "O1") bf16 AMP
    through the bf16 kernels. Returns the trainer, its batch, the flash
    launches of the run and their split by kernel variant."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import Llama, llama_loss_fn
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Llama(cfg, device="cuda", seed=seed)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    trainer = TrainStep(model, llama_loss_fn, opt, amp_level=amp_level)
    bf16 = amp_level is not None
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1), device="cuda",
                         generator=gen)
    ids, labels = toks[:, :-1], toks[:, 1:]
    n_params = sum(p.numel() for p in model.parameters())
    per_layer = sum(p.numel() for p in model.layers[0].parameters())
    n_full = n_params + (32 - cfg.num_layers) * per_layer
    log(f"trainer setup ({amp_level or 'fp32'}): {cfg.num_layers} of 32 "
        f"layers at LLaMA-2-7B "
        f"widths (hidden {cfg.hidden_size}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, ffn {cfg.ffn_hidden}, vocab "
        f"{cfg.vocab_size}), {n_params / 1e9:.3f} B fp32 params "
        f"({per_layer / 1e6:.1f} M per layer; parameters, gradients and "
        f"two AdamW moments {16 * n_params / 1e9:.1f} GB, at 32 layers "
        f"{n_full / 1e9:.2f} B params and {16 * n_full / 1e9:.1f} GB), "
        f"batch [1, {seq}], {time.perf_counter() - t0:.1f} s")

    fa.reset_counts()
    losses = []

    def one_step():
        before = _flash_counts(bf16=bf16)
        losses.append(trainer(ids, labels))
        after = _flash_counts(bf16=bf16)
        for name in after:
            if after[name][0] - before[name][0] != cfg.num_layers:
                raise AssertionError(
                    f"{name} launched {after[name][0] - before[name][0]} "
                    f"times in a step, not {cfg.num_layers}")

    with _no_dense_attention():
        for _ in range(warmup):
            one_step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t) / steps
    counts = _flash_counts(bf16=bf16)
    launches = {name: kl for name, (kl, _) in counts.items()}
    plain = _other_flash_launches(False, bf16)
    values = [x.float().item() for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"trainer losses ({amp_level or 'fp32'}, {losses[0].dtype}): "
        f"{[round(x, 5) for x in values]}")
    log(f"trainer run ({amp_level or 'fp32'}): {warmup} warm-up + {steps} "
        f"timed steps, mean step {step_ms:.1f} ms = "
        f"{seq / step_ms * 1e3:.1f} tokens/s, peak memory {peak:.2f} GiB, "
        f"{'bf16 ' if bf16 else ''}flash launches {launches} "
        f"({cfg.num_layers} each per step), plain versions and other flash "
        f"forms {plain}, dense attention calls 0")
    if not all(np.isfinite(values)) or not values[-1] < values[0]:
        raise AssertionError(f"trainer losses not finite and falling: "
                             f"{values}")
    if plain != 0 or any(n != cfg.num_layers * (warmup + steps)
                         for n in launches.values()):
        raise AssertionError(f"main path missed a flash kernel: "
                             f"{launches}, plain launches {plain}")
    variants = _variant_launches(
        f"trainer ({amp_level or 'fp32'})", False, bf16,
        cfg.hidden_size // cfg.num_heads, cfg.num_layers * (warmup + steps))
    log(f"trainer flash launches by variant: {json.dumps(variants)}")
    return trainer, (ids, labels), launches, variants


def _optimizer_ms(trainer, batch, steps):
    """(device ms, span ms) of `optimizer.step()` (the clip and AdamW),
    medians over steps run by hand: the forward and backward as TrainStep
    runs them, then, on an idle card, the update alone, once between CUDA
    events (its span on the device's clock, launch gaps included) and once
    under torch.profiler (its kernels' device time)."""
    from torch.profiler import ProfilerActivity, profile
    device, span = [], []
    n = trainer.n_inputs

    def update(profiled):
        loss = trainer.loss_fn(trainer.model(*batch[:n]), *batch[n:])
        loss.backward()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                     ) if profiled else contextlib.nullcontext() as prof:
            start.record()
            trainer.optimizer.step()
            end.record()
            end.synchronize()
        trainer.optimizer.zero_grad(set_to_none=True)
        if profiled:
            device.append(sum(_device_ms(prof)[0].values()))
        else:
            span.append(start.elapsed_time(end))

    for _ in range(steps):
        update(False)
        update(True)
    return statistics.median(device), statistics.median(span)


# the flash groups under their masked names, for a path that runs only the
# masked forms (the CUDA kernels are the same instantiations)
MASKED_GROUPS = {"K3a flash_forward": "K3a-m flash_forward_masked",
                 "K3b-dq flash_backward_dq":
                     "K3b-dq-m flash_backward_dq_masked",
                 "K3b-dkv flash_backward_dkv":
                     "K3b-dkv-m flash_backward_dkv_masked",
                 "K3a-bf16 flash_forward_bf16":
                     "K3a-m-bf16 flash_forward_masked_bf16",
                 "K3b-dq-bf16 flash_backward_dq_bf16":
                     "K3b-dq-m-bf16 flash_backward_dq_masked_bf16",
                 "K3b-dkv-bf16 flash_backward_dkv_bf16":
                     "K3b-dkv-m-bf16 flash_backward_dkv_masked_bf16"}


def train_profile_phase(trainer, batch, layers, matmul_weights, label,
                        masked=False, steps=2, bf16=False):
    """Phases 12, 16, 21 and 22: torch.profiler over `steps` training
    steps, device time by kernel group; the optimizer's kernels are
    profiled apart (`_optimizer_ms`) and their time taken out of the
    elementwise group, where they fall by name. The idle share is 1 -
    device busy / host wall of as many unprofiled steps just before.
    `matmul_weights` counts the elements of every weight used as a matmul
    operand (6 FLOPs per element and token)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        trainer(*batch)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer(*batch)
        torch.cuda.synchronize()
    groups, top = _device_ms(prof)
    if masked:
        groups = {MASKED_GROUPS.get(g, g): ms for g, ms in groups.items()}
    opt_device, opt_span = _optimizer_ms(trainer, batch, steps)
    other = "other (elementwise, norms, gathers)"
    groups["optimizer (clip + AdamW)"] = steps * opt_device
    groups[other] = groups.get(other, 0.0) - steps * opt_device
    busy = sum(groups.values()) / steps
    per = {g: round(ms / steps, 3) for g, ms in
           sorted(groups.items(), key=lambda kv: -kv[1])}
    flash = list(dict.fromkeys(
        MASKED_GROUPS[g] if masked else g
        for k, g in FLASH_GROUPS.items() if ("_bf16_" in k) == bf16))
    per_launch = {g: round(groups.get(g, 0.0) / (steps * layers), 4)
                  for g in flash}
    tokens = batch[0].numel()
    mm_flops = 6 * tokens * matmul_weights
    mm_ms = groups.get("matmul (cuBLAS)", 0.0) / steps
    log(f"profile {label} step: host wall {wall:.1f} ms/step, device "
        f"busy {busy:.1f} ms/step, idle share {1 - busy / wall:.3f}; "
        f"flash device ms per launch {json.dumps(per_launch)}; device "
        f"ms/step by group {json.dumps(per)}")
    log(f"  optimizer.step() alone: device {opt_device:.3f} ms, span on the "
        f"device's clock {opt_span:.3f} ms (busy {opt_device / opt_span:.3f}"
        f" of it)")
    if mm_ms > 0:
        log(f"  matmuls: {mm_flops / 1e12:.2f} TFLOP per step at "
            f"{mm_flops / mm_ms / 1e9:.1f} TFLOP/s")
    if groups[other] < 0:
        log("  the optimizer's profiled kernels exceed the elementwise group "
            "they were taken from: the split of those two is not measured")
    for name, ms in top:
        log(f"  {ms / steps:.3f} ms/step  {name[:110]}")


def dense_check_phase(cfg, seed=1, seq=1024, gpt=False):
    """Phases 13 and 27 (b): one step's loss and gradients through the
    flash kernels against the dense path, same weights and batch, for a
    Llama or (``gpt``) a GPT."""
    from paddle_tpu_torch.models import GPT, Llama, gpt_loss_fn, llama_loss_fn
    from paddle_tpu_torch.utils.flags import flag, set_flags

    model = (GPT if gpt else Llama)(cfg, device="cuda", seed=seed)
    loss_fn = gpt_loss_fn if gpt else llama_loss_fn
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1), device="cuda",
                         generator=gen)

    def run(use_flash):
        old = flag("FLAGS_use_flash_attention")
        set_flags({"FLAGS_use_flash_attention": use_flash})
        try:
            loss = loss_fn(model(toks[:, :-1]), toks[:, 1:])
            loss.backward()
        finally:
            set_flags({"FLAGS_use_flash_attention": old})
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    before = _flash_counts()
    loss_k, grads_k = run(True)
    mid = _flash_counts()
    loss_d, grads_d = run(False)
    if _flash_counts() != mid or any(
            mid[n][0] - before[n][0] != cfg.num_layers for n in mid):
        raise AssertionError("the kernel run missed a flash kernel or the "
                             "dense run launched one")
    rel = abs(loss_k - loss_d) / abs(loss_d)
    worst = max(((g - grads_d[n]).abs().max()
                 / grads_d[n].abs().max()).item()
                for n, g in grads_k.items())
    log(f"kernels vs dense ({type(model).__name__}, {cfg.num_layers} "
        f"layers, full width, seq {seq}):"
        f" loss {loss_k:.6f} vs {loss_d:.6f} (rel {rel:.2e}), worst grad "
        f"max|diff| / max|grad| {worst:.2e} over {len(grads_k)} params")
    if not (rel <= 1e-5 and worst <= 1e-3):
        raise AssertionError("the kernels' step differs from the dense "
                             "path's beyond 1e-5 (loss) / 1e-3 (grads)")


def visible_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs of one head that attention computes: all of them,
    or under the bottom-right-aligned causal mask the keys j <= i + sk - sq
    of each row i (rows before sq - sk see none)."""
    if not causal:
        return sq * sk
    lo = max(0, sq - sk)                 # the first row that sees a key
    # row i sees i + sk - sq + 1 keys, from lo up to the last row's sk
    return (sq - lo) * (lo + sk - sq + 1 + sk) // 2


def flash_work(b, sq, sk, h, d, causal, kbias=False, elem=4):
    """{kernel: (bytes, FLOPs)}: the least work of K3a, K3b-dq and K3b-dkv
    on q [b, sq, h, d] and k, v [b, sk, h, d]. Each input is read once
    and each output written once (q, k, v, o, do, dq, dk, dv of `elem`
    bytes: 4 fp32, 2 bf16; lse and delta [b, h, sq] and the per-key bias
    [b, sk] where given fp32); FLOPs per visible (query, key) pair of every
    head: 4 d (q.k and p.v), 6 d (q.k, do.v, ds.k), 8 d (q.k, do.v, p^T.do,
    ds^T.q)."""
    pairs = b * h * visible_pairs(sq, sk, causal)
    qrow, krow = elem * b * sq * h * d, elem * b * sk * h * d
    rowv = 4 * b * h * sq
    kb = 4 * b * sk if kbias else 0
    return {"flash_forward": (2 * qrow + 2 * krow + rowv + kb, 4 * d * pairs),
            "flash_backward_dq": (3 * qrow + 2 * krow + 2 * rowv + kb,
                                  6 * d * pairs),
            "flash_backward_dkv": (2 * qrow + 4 * krow + 2 * rowv + kb,
                                   8 * d * pairs)}


def measure_flash(gen, b=1, s=4096, h=32, d=128, causal=True, att=None,
                  dtype=torch.float32):
    """Phases 14, 18 and 20 (b): each flash kernel against its plain
    version, its bound and SDPA. The dense forms at the trainer's shape,
    causal; with ``att`` ([b, s] 0/1), the masked forms at that batch, its
    -1e4 key padding as kbias [b, s] (SDPA: the broadcast float mask, in
    the operands' dtype), non-causal. ``dtype`` bf16 times the bf16
    instantiations on bf16 operands (the plain versions and SDPA on the
    same operands), their bound at 2-byte operands and the dense bf16
    rate.
    The backward pair is held like for like against SDPA's backward alone
    (torch.autograd.grad of a retained graph): the whole flash_backward
    (backward_delta and both kernels) and the two kernels alone. Returns
    {kernel: row} with the pair's times under "pair"."""
    from paddle_tpu_torch.ops import flash_attention as fa
    import torch.nn.functional as F

    if att is not None:
        b, s = att.shape
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(dtype) for _ in range(4))
    kbias = None if att is None else ((1.0 - att.float()) * -1e4).contiguous()
    m = fa.Masks(kbias=kbias)
    o, lse = fa.flash_forward(q, k, v, causal, kbias=kbias)
    delta = fa.backward_delta(o, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    scale = 1.0 / d ** 0.5

    def dq_kernel():
        fa.launch_backward_dq(q, k, v, do, lse, delta, dq, causal, scale, m)

    def dkv_kernel():
        fa.launch_backward_dkv(q, k, v, do, lse, delta, dk, dv, causal,
                               scale, m)

    ms = {"flash_forward": median_ms(lambda: fa.launch_forward(
              q, k, v, o, lse, causal, scale, m)),
          "flash_backward_dq": median_ms(dq_kernel),
          "flash_backward_dkv": median_ms(dkv_kernel)}
    pair_kernels = median_ms(lambda: (dq_kernel(), dkv_kernel()))
    pair_whole = median_ms(lambda: fa.flash_backward(
        q, k, v, o, do, lse, causal, kbias=kbias))
    plain = {
        "flash_forward": median_ms(lambda: fa.flash_forward_reference(
            q, k, v, causal, kbias=kbias), iters=5),
        "flash_backward_dq": median_ms(lambda: fa.flash_backward_dq_reference(
            q, k, v, do, lse, delta, causal, kbias=kbias), iters=5),
        "flash_backward_dkv": median_ms(
            lambda: fa.flash_backward_dkv_reference(
                q, k, v, do, lse, delta, causal, kbias=kbias), iters=5)}
    qT, kT, vT, doT = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    kw = (dict(is_causal=True) if causal
          else dict(attn_mask=None if kbias is None
                    else kbias[:, None, None, :].to(dtype)))
    lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(
        qT, kT, vT, **kw))
    qg, kg, vg = (t.clone().requires_grad_() for t in (qT, kT, vT))
    out = F.scaled_dot_product_attention(qg, kg, vg, **kw)
    lib_bwd = median_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), doT, retain_graph=True))
    del out
    library = {"flash_forward": lib_fwd, "flash_backward_dq": lib_bwd,
               "flash_backward_dkv": lib_bwd}
    bf16 = dtype == torch.bfloat16
    work = flash_work(b, s, s, h, d, causal, kbias is not None,
                      elem=2 if bf16 else 4)
    peak = PEAK_BF16_FLOP_PER_S if bf16 else PEAK_FP32_ACCURATE_FLOP_PER_S
    form = "causal" if causal else f"kbias [{b},{s}] full"
    label = ("" if kbias is None else "_masked") + ("_bf16" if bf16 else "")
    log(f"flash work at q/k/v [{b},{s},{h},{d}] {form}: " + ", ".join(
        f"{name} {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP"
        for name, (nbytes, flops) in work.items()))
    rows = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = flops / peak
        rows[name] = dict(ms=ms[name], plain_ms=plain[name],
                          bound_ms=1e3 * max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops
                          else "operations",
                          library_ms=library[name])
        log(f"timing {name}{label} at q/k/v [{b},{s},{h},{d}] {form}: "
            f"kernel {ms[name]:.4f} ms, plain {plain[name]:.4f} ms, bound "
            f"{rows[name]['bound_ms']:.4f} ms ({rows[name]['bound_by']}, "
            f"{100 * rows[name]['bound_ms'] / ms[name]:.1f} % of it), "
            f"library {library[name]:.4f} ms")
    rows["pair"] = dict(kernels_ms=pair_kernels, flash_backward_ms=pair_whole,
                        library_ms=lib_bwd)
    log(f"backward pair{label} at q/k/v [{b},{s},{h},{d}] {form}, like for "
        f"like: flash_backward (delta + K3b-dq + K3b-dkv) {pair_whole:.4f} "
        f"ms, the two kernels alone {pair_kernels:.4f} ms; SDPA backward "
        f"alone (autograd.grad of a retained graph) {lib_bwd:.4f} ms; "
        f"factor {pair_whole / lib_bwd:.3f} (kernels alone "
        f"{pair_kernels / lib_bwd:.3f}); SDPA forward {lib_fwd:.4f} ms")
    return rows


def check_vs_fp64(gen, b=1, s=4096, h=32, d=128, causal=True, att=None):
    """Phases 14 and 18, first: the kernels at the trainer's (or with
    ``att``, the ERNIE batch's kbias) shape against their plain versions on
    the same operands (o, lse within 1e-4; each gradient within 1e-4 *
    max|plain gradient|), then o, lse, dq, dk and dv against the plain
    versions evaluated once in fp64: the kernels' max error must stay within
    twice the fp32 plain versions' own, the mark of fp32-class products
    (TF32 products would be ~1000 times off). Returns each kernel's max abs
    error against the fp32 plain version, and the forward's larger fp64
    ratio under "fwd_fp64_ratio"."""
    from paddle_tpu_torch.ops import flash_attention as fa

    if att is not None:
        b, s = att.shape
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   for _ in range(4))
    kbias = None if att is None else ((1.0 - att.float()) * -1e4).contiguous()
    o, lse = fa.flash_forward(q, k, v, causal, kbias=kbias)
    kern = fa.flash_backward(q, k, v, o, do, lse, causal, kbias=kbias)
    ro, rlse = fa.flash_forward_reference(q, k, v, causal, kbias=kbias)
    err = {"flash_forward": max((o - ro).abs().max().item(),
                                (lse - rlse).abs().max().item())}
    del ro, rlse
    plain = fa.flash_backward_reference(q, k, v, o, do, lse, causal,
                                        kbias=kbias)
    form = (f"q/k/v [{b},{s},{h},{d}] "
            + ("causal" if causal else f"kbias [{b},{s}] full"))
    grad_err = {}
    for name, g, r in zip(("dq", "dk", "dv"), kern, plain):
        grad_err[name] = (g - r).abs().max().item()
        if not (torch.isfinite(g).all()
                and grad_err[name] <= TOL * r.abs().max().item()):
            raise AssertionError(f"K3b {name} at {form}: max_abs_err "
                                 f"{grad_err[name]:.3e} > {TOL} * max|plain|")
    if not err["flash_forward"] <= TOL:
        raise AssertionError(f"K3a at {form}: o/lse max_abs_err "
                             f"{err['flash_forward']:.3e} > {TOL}")
    err["flash_backward_dq"] = grad_err["dq"]
    err["flash_backward_dkv"] = max(grad_err["dk"], grad_err["dv"])
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = fa.flash_forward_reference(q64, k64, v64, causal,
                                            kbias=kbias)
    exact = fa.flash_backward_reference(q64, k64, v64, o64, do64, lse64,
                                        causal, kbias=kbias)
    ro, rlse = fa.flash_forward_reference(q, k, v, causal, kbias=kbias)
    fwd = {"o": fp64_ratio(o, ro, o64), "lse": fp64_ratio(lse, rlse, lse64)}
    bias = (signed_error(o, o64), signed_error(ro, o64))
    del o64, lse64, ro, rlse
    log(f"flash forward vs fp64 at {form}: o {fwd['o']:.2f}x, lse "
        f"{fwd['lse']:.2f}x the fp32 plain version's error; o's mean signed "
        f"error kernel {bias[0]:+.2e}, plain {bias[1]:+.2e}")
    for name, ratio in fwd.items():
        if not ratio <= 2.0:
            raise AssertionError(f"K3a {name} at {form}: error against fp64 "
                                 f"{ratio:.2f}x the fp32 plain version's, "
                                 "above 2x")
    err["fwd_fp64_ratio"] = max(fwd.values())
    parts = []
    for name, g, p, r in zip(("dq", "dk", "dv"), kern, plain, exact):
        e_kernel = (g.double() - r).abs().max().item()
        e_plain = (p.double() - r).abs().max().item()
        parts.append(f"{name} kernel {e_kernel:.3e} plain {e_plain:.3e} "
                     f"({e_kernel / e_plain:.2f}x)")
        if not e_kernel <= 2 * e_plain:
            raise AssertionError(f"K3b {name} at {form}: error against fp64 "
                                 f"{e_kernel:.3e} > 2 x the fp32 plain "
                                 f"version's {e_plain:.3e}")
    log(f"flash kernels vs plain at {form}: max_abs_err " + ", ".join(
        f"{n} {e:.3e}" for n, e in {**err, **grad_err}.items()
        if n != "fwd_fp64_ratio"))
    log(f"flash backward vs fp64 at {form} (max abs error): "
        + "; ".join(parts) + "; each within 2x the fp32 plain version's")
    return err


# ------------------------------------------------- bf16 AMP (K3 at bf16)

# an error against fp64 below this share of max|exact| counts as exact (a
# few fp32 ulp: the fp32 plain version can be exact where the kernel's
# two-term products still round)
FP64_FLOOR = 2.0 ** -21


def _vs_fp64(x, plain, exact):
    """(the kernel's max error against the fp64 evaluation, the plain
    version's, and their ratio with the FP64_FLOOR floor). The floor is
    relative to max|exact| and at least to 1, the operands' scale: where
    every output is a sum that cancels to 0 (dq and dk with one key, dS =
    dP - delta) each fp32 evaluation leaves the noise of its unit-scale
    terms, and the plain version's may be 0 by chance."""
    e_kernel = (x.double() - exact).abs().max().item()
    e_plain = (plain.double() - exact).abs().max().item()
    den = max(e_plain, FP64_FLOOR * max(exact.abs().max().item(), 1.0))
    return e_kernel, e_plain, (e_kernel / den if den > 0 else
                               0.0 if e_kernel == 0 else float("inf"))


# The max error of a bf16 output is its one bf16 rounding, for the kernel
# and the plain version alike, so it cannot see an inner error up to half a
# bf16 ulp. The misround share can: of the outputs the bf16 plain version
# (fp32 throughout) rounds to bf16(exact), the share the kernel rounds to
# another value. The hi + lo products keep P and dS to ~2^-17, which moves
# only outputs that close to a rounding boundary (a few %); one bf16 term
# of P or dS (2^-9) would move about a third. The gate sits between.
MISROUND_GATE = 1 / 16
# An output whose exact value is below this (the operands are unit
# normals) is a sum that cancels exactly, as dq of a row that sees one key
# (dS = dP - delta = 0): any fp32 evaluation leaves its own noise there,
# so the share leaves it out.
EXACT_ZERO = 2.0 ** -24


def misround_share(x, plain, exact) -> float:
    """Of the bf16 outputs where ``plain`` equals bf16(exact) (torch's
    cast) and |exact| > EXACT_ZERO, the share where ``x`` does not (0
    where there are none)."""
    want = exact.to(torch.bfloat16)
    right = (plain == want) & (exact.abs() > EXACT_ZERO)
    n = int(right.sum())
    return int((right & (x != want)).sum()) / n if n else 0.0


def check_bf16(gen, label, b, sq, sk, h, d, causal, dead_rows=None, **kw):
    """Phase 20 (a), one case: the bf16 kernels (K3a, K3b-dq, K3b-dkv) on
    bf16 operands with the JAX function's masking arguments ``kw``, and
    the plain versions on the same operands (fp32 compute, bf16 outputs),
    both against the plain versions evaluated in fp64: o, lse (rows that
    see a key), dq, dk and dv within twice the bf16 plain version's own
    error, and o, dq, dk and dv misrounded (`misround_share`) at most
    MISROUND_GATE of the time. Each kernel must launch once, as its bf16
    instantiation, through the variant `kernel_variant` names for d (wgmma
    at d <= 128, mma.sync above). Returns ({kernel: fp64 ratio},
    {kernel: max abs error vs plain}, {kernel: misround share})."""
    from paddle_tpu_torch.ops import flash_attention as fa
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                   .to(bf) for s in (sq, sk, sk, sq))
    m = fa.canonical_masks(q, k, v, causal, **kw)
    ops = m._asdict()
    counts = fa.counts_for(m.given(), bf)
    before = {n: (c.kernel_launches, dict(c.form_launches))
              for n, c in counts.items()}
    o, lse = fa.flash_forward(q, k, v, causal, **ops)
    kern = fa.flash_backward(q, k, v, o, do, lse, causal, **ops)
    for n, c in counts.items():
        variant = fa.kernel_variant(n, bf, d)
        if (c.kernel_launches - before[n][0] != 1
                or c.form_launches.get(variant, 0)
                - before[n][1].get(variant, 0) != 1):
            raise AssertionError(
                f"bf16 flash {label}: {n} did not launch once through its "
                f"{variant} kernel: {before[n]} -> {c.kernel_launches}, "
                f"{c.form_launches}")
    ro, rlse = fa.flash_forward_reference(q, k, v, causal, **ops)
    plain = fa.flash_backward_reference(q, k, v, o, do, lse, causal, **ops)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, lse64 = fa.flash_forward_reference(q64, k64, v64, causal, **ops)
    exact = fa.flash_backward_reference(q64, k64, v64, o64, do64, lse64,
                                        causal, **ops)
    seen = lse64 > fa.MASKED_BELOW
    outs = {"o": (o, ro, o64), "dq": (kern[0], plain[0], exact[0]),
            "dk": (kern[1], plain[1], exact[1]),
            "dv": (kern[2], plain[2], exact[2])}
    if bool(seen.any()):
        outs["lse"] = (lse[seen], rlse[seen], lse64[seen])
    ratio, err, share, parts, failed = {}, {}, {}, [], []
    for name, (x, p, e) in outs.items():
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"bf16 flash {label}: {name} not finite")
        e_kernel, e_plain, ratio[name] = _vs_fp64(x, p, e)
        err[name] = (x.float() - p.float()).abs().max().item()
        parts.append(f"{name} {e_kernel:.2e}/{e_plain:.2e} "
                     f"({ratio[name]:.2f}x)")
        if not ratio[name] <= 2.0:
            failed.append(f"{name} error against fp64 {e_kernel:.3e} > 2 x "
                          f"the bf16 plain version's {e_plain:.3e}")
        if name != "lse":
            share[name] = misround_share(x, p, e)
            parts[-1] += f" misround {share[name]:.4f}"
            if not share[name] <= MISROUND_GATE:
                failed.append(f"{name} misrounded {share[name]:.4f} > "
                              f"{MISROUND_GATE}")
    line = (f"bf16 flash {label} (b={b} sq={sq} sk={sk} h={h} d={d} "
            f"{'causal' if causal else 'full'}) vs fp64, kernel/plain max "
            "error: " + ", ".join(parts))
    if failed:
        raise AssertionError(f"{line}; failed: " + "; ".join(failed))
    if dead_rows is not None and not (bool((o[:, dead_rows] == 0).all())
                                      and bool((kern[0][:, dead_rows] == 0)
                                               .all())):
        raise AssertionError(f"bf16 flash {label}: rows that see no key are "
                             "not exactly 0 with zero dq")
    log(line)
    return tuple({"flash_forward": max(x.get("o", 0.0), x.get("lse", 0.0)),
                  "flash_backward_dq": x["dq"],
                  "flash_backward_dkv": max(x["dk"], x["dv"])}
                 for x in (ratio, err, share))


def bf16_flash_checks(gen, att):
    """Phase 20 (a): the bf16 kernels against fp64 at the Llama trainer's
    shape (causal), at the ERNIE batch's shape with its -1e4 key padding
    (``att``), over d in {64, 128} x causal / full x lengths 1, 100, 257,
    1000 and 128 / 384 crossed, in every masked form of phase 10 and at
    d = 256.
    Returns the worst fp64 ratio, abs error vs plain and misround share of
    each kernel, dense and masked."""
    from paddle_tpu_torch.ops import flash_attention as fa
    names = ("flash_forward", "flash_backward_dq", "flash_backward_dkv")
    worst = {kind: {key: dict.fromkeys(names, 0.0)
                    for key in ("ratio", "err", "misround")}
             for kind in ("dense", "masked")}
    n = 0

    def case(label, *args, **kw):
        nonlocal n
        got = dict(zip(("ratio", "err", "misround"),
                       check_bf16(gen, label, *args, **kw)))
        kind = "masked" if any(kw.get(key) is not None for key in
                               ("mask", "segment_ids", "block_mask")) \
            else "dense"
        for key, vals in got.items():
            for name in names:
                worst[kind][key][name] = max(worst[kind][key][name],
                                             vals[name])
        n += 1
        _free_the_card()

    case("Llama trainer shape", 1, 4096, 4096, 32, 128, True)
    b, s = att.shape
    case("ERNIE batch, -1e4 key padding", b, s, s, 12, 64, False,
         mask=(1.0 - att[:, None, None, :].float()) * -1e4)
    for d in (64, 128):
        for causal in (True, False):
            for sq, sk in ((1, 1), (100, 100), (257, 257), (1000, 1000),
                           (128, 384), (384, 128)):
                case("sweep", 1, sq, sk, 4, d, causal)
    case("bool key padding", 2, 200, 333, 4, 128, True,
         mask=_padded(gen, 2, 333, 0.5)[:, None, None, :].bool())
    m = torch.randn(2, 1, 300, 300, device="cuda", generator=gen) * 2
    m.masked_fill_(torch.rand(m.shape, device="cuda", generator=gen) < 0.3,
                   fa.NEG_INF)
    case("additive mask, mh = 1", 2, 300, 300, 4, 64, False, mask=m)
    m = torch.randn(1, 4, 256, 256, device="cuda", generator=gen)
    m.masked_fill_(torch.rand(m.shape, device="cuda", generator=gen) < 0.3,
                   fa.NEG_INF)
    case("additive mask, mh = h", 1, 256, 256, 4, 128, True, mask=m)
    keep = torch.rand(2, 1, 100, 160, device="cuda", generator=gen) < 0.7
    keep[:, :, 50:] = False
    case("bool mask, rows 50.. see no key", 2, 100, 160, 4, 64, False,
         dead_rows=slice(50, None), mask=keep)
    cuts = torch.randint(1, 384, (2, 3), device="cuda", generator=gen)
    seg = (torch.arange(384, device="cuda")[None, :, None]
           >= cuts.sort(1).values[:, None, :]).sum(-1)
    case("segment ids", 2, 384, 384, 4, 128, True, segment_ids=seg)
    m = torch.randn(1, 1, 512, 512, device="cuda", generator=gen)
    blocks = torch.eye(4, dtype=torch.int32, device="cuda")
    blocks[3, 0] = 1
    m.masked_fill_(~fa._block_live(blocks, 512, 512), fa.NEG_INF)
    case("block mask", 1, 512, 512, 4, 64, False, mask=m,
         block_mask=blocks)
    case("d > 128: the mma.sync kernels", 1, 257, 257, 4, 256, True)
    log(f"bf16 flash checks: {n} cases within 2x the bf16 plain versions' "
        f"error against fp64, misrounded at most {MISROUND_GATE}; worst "
        "ratios, abs errors vs plain and misround shares "
        + json.dumps({kind: {key: {nm: float(f"{x:.3e}") for nm, x in
                                   vals.items()} for key, vals in w.items()}
                      for kind, w in worst.items()}))
    return worst


def o2_phase(cfg, seed=2, seq=1024, steps=4):
    """Phase 23: O2. A Llama at full width after amp.decorate(level="O2"):
    every parameter bf16, AdamW keeping an fp32 master copy of each, and
    after every step each parameter equal bit for bit to its master copy
    cast to bf16; the losses fall; the bf16 kernels launch once per layer
    and step, nothing else."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import Llama, llama_loss_fn
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm

    model = Llama(cfg, device="cuda", seed=seed)
    amp.decorate(model, level="O2")
    params = dict(model.named_parameters())
    if any(p.dtype != torch.bfloat16 for p in params.values()):
        raise AssertionError("O2: a decorated parameter is not bf16")
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    trainer = TrainStep(model, llama_loss_fn, opt, amp_level="O2")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1), device="cuda",
                         generator=gen)
    before = _flash_counts(bf16=True)
    others = _other_flash_launches(False, True)
    losses = []
    for _ in range(steps):
        losses.append(trainer(toks[:, :-1], toks[:, 1:]).float().item())
        for name, p in params.items():
            master = opt.state[p]["master"]
            if master.dtype != torch.float32 or not torch.equal(
                    p, master.to(torch.bfloat16)):
                raise AssertionError(f"O2: {name} is not its fp32 master "
                                     "copy cast to bf16")
    after = _flash_counts(bf16=True)
    launched = {n: after[n][0] - before[n][0] for n in after}
    log(f"O2 ({cfg.num_layers} layers, full width, seq {seq}): "
        f"{len(params)} parameters bf16 with fp32 master copies, each equal "
        f"to its master cast to bf16 after every step; losses "
        f"{[round(x, 5) for x in losses]}; bf16 flash launches {launched}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"O2 losses not finite and falling: {losses}")
    if any(n != steps * cfg.num_layers for n in launched.values()) or \
            _other_flash_launches(False, True) != others:
        raise AssertionError(f"O2 missed a bf16 kernel or ran another: "
                             f"{launched}")


def amp_twins_phase(cfg, seed=1, seq=1024):
    """Phase 24: one O1 step of a Llama at full width through the bf16
    kernels against the same step on the dense path (FLAGS_use_flash_
    attention off: bf16 probabilities, where the kernels keep P in fp32)
    and against the fp32 step through the fp32 kernels, same weights and
    batch. Tolerances (bf16 operands round at 2^-9): the loss within 1e-2
    relative of both twins, every gradient within 5e-2 * max|grad| of the
    dense twin's and 1e-1 * max|grad| of the fp32 twin's."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.models import Llama, llama_loss_fn
    from paddle_tpu_torch.utils.flags import flag, set_flags

    model = Llama(cfg, device="cuda", seed=seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, seq + 1), device="cuda",
                         generator=gen)

    def run(level, use_flash):
        old = flag("FLAGS_use_flash_attention")
        set_flags({"FLAGS_use_flash_attention": use_flash})
        try:
            with (amp.auto_cast(level=level) if level
                  else contextlib.nullcontext()):
                logits = model(toks[:, :-1])
            loss = llama_loss_fn(logits, toks[:, 1:])
            loss.backward()
        finally:
            set_flags({"FLAGS_use_flash_attention": old})
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.float().item(), grads

    before = (_flash_counts(bf16=True), _flash_counts())
    loss_k, grads_k = run("O1", True)
    mid = (_flash_counts(bf16=True), _flash_counts())
    loss_d, grads_d = run("O1", False)
    mid2 = (_flash_counts(bf16=True), _flash_counts())
    loss_f, grads_f = run(None, True)
    after = (_flash_counts(bf16=True), _flash_counts())
    if any(mid[0][n][0] - before[0][n][0] != cfg.num_layers for n in mid[0]) \
            or mid[1] != before[1] or mid2 != mid or after[0] != mid2[0] \
            or any(after[1][n][0] - mid2[1][n][0] != cfg.num_layers
                   for n in after[1]):
        raise AssertionError("O1 twins: the O1 step missed a bf16 kernel, "
                             "the dense step launched one, or the fp32 step "
                             "ran other than the fp32 kernels")

    def worst(grads):
        return max(((g.float() - grads[n].float()).abs().max()
                    / grads[n].float().abs().max()).item()
                   for n, g in grads_k.items())

    rel_d, rel_f = (abs(loss_k - x) / abs(x) for x in (loss_d, loss_f))
    w_d, w_f = worst(grads_d), worst(grads_f)
    log(f"O1 twins ({cfg.num_layers} layers, full width, seq {seq}): loss "
        f"kernels {loss_k:.6f}, dense bf16 {loss_d:.6f} (rel {rel_d:.2e}), "
        f"fp32 {loss_f:.6f} (rel {rel_f:.2e}); worst grad max|diff| / "
        f"max|grad| vs dense {w_d:.2e}, vs fp32 {w_f:.2e}")
    if not (rel_d <= 1e-2 and rel_f <= 1e-2 and w_d <= 5e-2
            and w_f <= 1e-1):
        raise AssertionError("the O1 step differs from its twins beyond "
                             "1e-2 (loss), 5e-2 (grads vs dense) or 1e-1 "
                             "(grads vs fp32)")


# -------------------------------------------------------------- ERNIE

def ernie_batch(vocab, batch, seq, seed):
    """bench.py::child_ernie's batch on the card: mask_tokens at 15 % of
    seeded ids, lengths drawn from 85-100 % of seq, labels -100 on pads,
    token types 0, random sentence-order labels."""
    from paddle_tpu_torch.models import mask_tokens
    rng = np.random.default_rng(seed)
    base = rng.integers(5, vocab, (batch, seq))
    ids, labels = mask_tokens(base, vocab, rng)
    lens = rng.integers(int(seq * 0.85), seq + 1, (batch,))
    att = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int64)
    labels = np.where(att > 0, labels, -100)
    types = np.zeros((batch, seq), np.int64)
    sop = rng.integers(0, 2, (batch,))
    return tuple(torch.from_numpy(a).cuda() for a in
                 (ids, types, att, labels, sop))


@contextlib.contextmanager
def _no_dense_attention():
    """Fail on any call of the dense O(s^2) attention path."""
    from paddle_tpu_torch.ops import impl
    dense = impl._dense_attention

    def refuse(*args, **kwargs):
        raise AssertionError("the ERNIE trainer reached the dense attention "
                             "path")
    impl._dense_attention = refuse
    try:
        yield
    finally:
        impl._dense_attention = dense


def ernie_matmul_weights(model) -> int:
    """Elements of every weight used as a matmul operand on all tokens:
    the encoder's linears, the MLM transform and the tied decoder (the
    word embedding); not the position and token-type tables (gathers) or
    the pooler and SOP head (one token per row)."""
    return sum(p.numel() for n, p in model.named_parameters()
               if p.dim() == 2 and "position" not in n and "token_type"
               not in n and "pooler" not in n and "seq_relationship" not in n)


def ernie_trainer_phase(cfg, seed=0, batch=16, seq=512, warmup=2, steps=6,
                        amp_level=None):
    """Phases 15 and 21: ERNIE-3.0-base pretraining at full width and depth
    through jit.TrainStep and AdamW (child_ernie's recipe), fp32 or
    (amp_level "O1", as child_ernie trains) bf16 AMP through the masked
    bf16 kernels. Returns the trainer, its batch, the masked flash
    launches of the run and their split by kernel variant."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import ErnieForPretraining, \
        ernie_pretrain_loss_fn
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ErnieForPretraining(cfg, device="cuda", seed=seed)
    opt = AdamW(learning_rate=1e-4, weight_decay=0.01,
                parameters=model.named_parameters())
    trainer = TrainStep(model, ernie_pretrain_loss_fn, opt, n_inputs=3,
                        amp_level=amp_level)
    bf16 = amp_level is not None
    data = ernie_batch(cfg.vocab_size, batch, seq, seed)
    n_params = sum(p.numel() for p in model.parameters())
    fill = data[2].float().mean().item()
    log(f"ERNIE setup ({amp_level or 'fp32'}): {cfg.num_layers} layers, "
        f"hidden {cfg.hidden_size}, "
        f"heads {cfg.num_heads}, ffn {cfg.ffn_hidden}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e6:.2f} M fp32 params (decoder tied "
        f"to the word embedding; with gradients and two AdamW moments "
        f"{16 * n_params / 1e9:.2f} GB), batch [{batch}, {seq}] at "
        f"{100 * fill:.1f} % fill, {time.perf_counter() - t0:.1f} s")

    fa.reset_counts()
    losses = []

    def one_step():
        before = _flash_counts(masked=True, bf16=bf16)
        losses.append(trainer(*data))
        after = _flash_counts(masked=True, bf16=bf16)
        for name in after:
            if after[name][0] - before[name][0] != cfg.num_layers:
                raise AssertionError(
                    f"masked {name} launched "
                    f"{after[name][0] - before[name][0]} times in a step, "
                    f"not {cfg.num_layers}")

    with _no_dense_attention():
        for _ in range(warmup):
            one_step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t) / steps
    masked = _flash_counts(masked=True, bf16=bf16)
    launches = {name: kl for name, (kl, _) in masked.items()}
    others = _other_flash_launches(True, bf16)
    values = [x.float().item() for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"ERNIE losses ({amp_level or 'fp32'}, {losses[0].dtype}): "
        f"{[round(x, 5) for x in values]}")
    log(f"ERNIE run ({amp_level or 'fp32'}): {warmup} warm-up + {steps} "
        f"timed steps, mean step "
        f"{step_ms:.1f} ms = {batch * seq / step_ms * 1e3:.1f} tokens/s "
        f"({batch * seq} tokens a step, pads included), peak memory "
        f"{peak:.2f} GiB, masked flash launches {launches} "
        f"({cfg.num_layers} each per step), dense flash and plain launches "
        f"{others}, dense attention calls 0")
    if not all(np.isfinite(values)) or not values[-1] < values[0]:
        raise AssertionError(f"ERNIE losses not finite and falling: "
                             f"{values}")
    if others != 0 or any(n != cfg.num_layers * (warmup + steps)
                          for n in launches.values()):
        raise AssertionError(f"the ERNIE path missed a masked kernel or ran "
                             f"another: {launches}, others {others}")
    variants = _variant_launches(
        f"ERNIE ({amp_level or 'fp32'})", True, bf16,
        cfg.hidden_size // cfg.num_heads, cfg.num_layers * (warmup + steps))
    log(f"ERNIE flash launches by variant: {json.dumps(variants)}")
    return trainer, data, launches, variants


def ernie_check_phase(cfg, seed=1, batch=4, seq=512):
    """Phase 17: a 2-layer ERNIE at full width, one step's loss and
    gradients through the masked kernels against the dense path
    (FLAGS_use_flash_attention off), same weights and padded batch; then
    the JAX package's padding invariance through the kernels: outputs at
    real positions do not depend on the pad tokens' ids."""
    from paddle_tpu_torch.models import ErnieForPretraining, \
        ernie_pretrain_loss_fn
    from paddle_tpu_torch.utils.flags import flag, set_flags

    model = ErnieForPretraining(cfg, device="cuda", seed=seed)
    ids, types, att, labels, sop = ernie_batch(cfg.vocab_size, batch, seq,
                                               seed)

    def run(use_flash):
        old = flag("FLAGS_use_flash_attention")
        set_flags({"FLAGS_use_flash_attention": use_flash})
        try:
            loss = ernie_pretrain_loss_fn(model(ids, types, att), labels, sop)
            loss.backward()
        finally:
            set_flags({"FLAGS_use_flash_attention": old})
        grads = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), grads

    before = _flash_counts(masked=True)
    loss_k, grads_k = run(True)
    mid = _flash_counts(masked=True)
    loss_d, grads_d = run(False)
    if _flash_counts(masked=True) != mid or any(
            mid[n][0] - before[n][0] != cfg.num_layers for n in mid):
        raise AssertionError("the ERNIE kernel run missed a masked kernel or "
                             "the dense run launched one")
    rel = abs(loss_k - loss_d) / abs(loss_d)
    worst = max(((g - grads_d[n]).abs().max()
                 / grads_d[n].abs().max()).item()
                for n, g in grads_k.items())
    log(f"ERNIE kernels vs dense ({cfg.num_layers} layers, full width, batch "
        f"[{batch}, {seq}] padded): loss {loss_k:.6f} vs {loss_d:.6f} (rel "
        f"{rel:.2e}), worst grad max|diff| / max|grad| {worst:.2e} over "
        f"{len(grads_k)} params")
    if not (rel <= 1e-5 and worst <= 1e-3):
        raise AssertionError("the ERNIE kernels' step differs from the dense "
                             "path's beyond 1e-5 (loss) / 1e-3 (grads)")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    other = torch.where(att > 0, ids, torch.randint(
        5, cfg.vocab_size, ids.shape, device="cuda", generator=gen))
    model.eval()
    with torch.no_grad():
        outs = [model.ernie(x, token_type_ids=types, attention_mask=att)
                for x in (ids, other)]
    real = att > 0
    diff = max((outs[0][0] - outs[1][0])[real].abs().max().item(),
               (outs[0][1] - outs[1][1]).abs().max().item())
    log(f"ERNIE padding invariance ({int((~real).sum())} pad ids redrawn): "
        f"max|diff| at real positions and pooled {diff:.3e}")
    if not diff <= 2e-5:
        raise AssertionError(f"ERNIE outputs at real positions depend on "
                             f"the pad ids: {diff:.3e} > 2e-5")


# ---------------------------------------------------------------- GPT

def gpt_generator_phase(model, cfg, batch=8, prompt=256, new=32, seed=4,
                        max_len=512):
    """Phase 26: the generators at GPT-3 1.3B. PagedGPTGenerator greedy
    must launch K2 once a layer on every decode step and nothing else; the
    dense GPTGenerator's tokens must equal its tokens, and both stepped on
    the paged run's tokens give logits within TOL * max|logit| of each
    other at every step (the last step's reported; where a token parts,
    the top-2 margin at that step is printed and the run fails). A sampled
    run (seed 7, temperature 0.8, top-k 50, top-p 0.9) must equal, token
    for token, the CPU sampler over the card's logits and keys; a beam run
    (num_beams=4) must launch K2 once a layer a step. The steps run
    eagerly; each generator first generates 2 tokens untimed (the first
    calls' set-up). Returns the K2 launches of the greedy run."""
    import paddle_tpu_torch.models.generation as generation
    from paddle_tpu_torch.models.generation import (
        GPTGenerator, PagedGPTGenerator,
    )

    rng = np.random.default_rng(seed)
    ids = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                        (batch, prompt))).to("cuda")
    paged = PagedGPTGenerator(model, max_len=max_len)
    dense = GPTGenerator(model, max_len=max_len)
    counts = _all_counts()

    def run(g, **kw):
        for _, c in counts:
            c.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = g.generate(ids, max_new_tokens=new, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return out, wall, {n: (c.kernel_launches, c.plain_launches)
                           for n, c in counts}

    def prefill_ms(g):
        torch.cuda.synchronize()
        t = time.perf_counter()
        g._prefill_call(ids, g._make_state(batch))
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t)

    def gate_k2(label, launched, rows):
        want = {n: (0, 0) for n, _ in counts}
        want["paged_decode_attention"] = (cfg.num_layers * (new - 1), 0)
        if launched != want:
            raise AssertionError(f"{label}: launches {launched}, not K2 once "
                                 f"a layer on each of {new - 1} decode steps"
                                 f" of {rows} rows and nothing else")

    for g in (paged, dense):        # warm-up: the first calls' set-up
        g.generate(ids, max_new_tokens=2, temperature=0.0)
    torch.cuda.reset_peak_memory_stats()
    out_p, wall_p, launched = run(paged, temperature=0.0)
    gate_k2("PagedGPTGenerator greedy", launched, batch)
    k2_launches = launched["paged_decode_attention"][0]
    pre_p = prefill_ms(paged)
    out_d, wall_d, dense_launched = run(dense, temperature=0.0)
    if any(k or pl for k, pl in dense_launched.values()):
        raise AssertionError(f"GPTGenerator launched a serving kernel: "
                             f"{dense_launched}")
    pre_d = prefill_ms(dense)
    for label, wall, pre in (("PagedGPTGenerator (K2)", wall_p, pre_p),
                             ("GPTGenerator (dense cache)", wall_d, pre_d)):
        log(f"generator {label}: batch {batch}, prompt {prompt}, {new} "
            f"greedy tokens in {wall:.3f} s = {1e3 * wall / new:.2f} ms per "
            f"token step ({batch * new / wall:.1f} tokens/s); prefill alone "
            f"{pre:.1f} ms, decode {1e3 * (wall - pre / 1e3) / (new - 1):.2f}"
            f" ms per step")
    for label, g in (("paged (K2)", paged), ("dense cache", dense)):
        generator_step_trace(g, label, ids, out_p[:, prompt:])

    # both generators stepped on the paged run's tokens
    def stepwise(g):
        state = g._make_state(batch)
        logits, state = g._prefill_call(ids, state)
        out = [logits]
        for i in range(new - 1):
            logits, state = g._decode_logits_call(out_p[:, prompt + i],
                                                  state, prompt + i)
            out.append(logits)
        return out

    lp, ld = stepwise(paged), stepwise(dense)
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in zip(lp, ld)]
    log(f"generators, paged (K2) vs dense cache on the same tokens: "
        f"max|logit diff| / max|logit| at the last step {rel[-1]:.3e}, "
        f"worst over the {new} steps {max(rel):.3e}")
    parted = (out_p != out_d).nonzero()
    if len(parted):
        row, col = (int(x) for x in parted[0])
        step = col - prompt
        margins = []
        for name, lg in (("paged", lp), ("dense", ld)):
            top = torch.topk(lg[step][row].float(), 2).values
            margins.append(f"{name} {(top[0] - top[1]).item():.3e}")
        raise AssertionError(f"generators: tokens part at row {row}, step "
                             f"{step}; top-2 margins there " +
                             ", ".join(margins))
    if not max(rel) <= TOL:
        raise AssertionError(f"generators: paged logits differ from the "
                             f"dense cache's by {max(rel):.3e} > {TOL}")
    log(f"generators: greedy tokens of the paged and dense generators equal "
        f"({batch} x {new})")

    # a seeded sampled run against the CPU sampler on the card's logits
    orig = generation._sample_shared_key
    draws = []

    def spy(logits, key, temperature, top_k, top_p):
        tok = orig(logits, key, temperature, top_k, top_p)
        draws.append((logits.cpu(), key.cpu(), tok.cpu()))
        return tok

    kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=7)
    generation._sample_shared_key = spy
    try:
        out_s, wall_s, launched = run(paged, **kw)
    finally:
        generation._sample_shared_key = orig
    gate_k2("PagedGPTGenerator sampled", launched, batch)
    parts = [i for i, (lg, key, tok) in enumerate(draws)
             if not torch.equal(orig(lg, key, 0.8, 50, 0.9), tok)]
    log(f"generator sampled (seed 7, T 0.8, top-k 50, top-p 0.9): {len(draws)}"
        f" draws of [{batch}, {cfg.vocab_size}], {len(parts)} differ from the"
        f" CPU sampler on the card's logits; {1e3 * wall_s / new:.2f} ms per "
        f"token step")
    if parts or len(draws) != new:
        raise AssertionError(f"sampled generator: draws {parts} differ from "
                             "the CPU sampler")
    out_b, wall_b, launched = run(paged, num_beams=4)
    gate_k2("PagedGPTGenerator beams", launched, 4 * batch)
    if tuple(out_b.shape) != (batch, prompt + new) or not torch.equal(
            out_b[:, :prompt], ids):
        raise AssertionError(f"beam run: output {tuple(out_b.shape)}")
    log(f"generator beams (num_beams 4, {4 * batch} rows): {new} tokens in "
        f"{wall_b:.3f} s = {1e3 * wall_b / new:.2f} ms per token step; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return k2_launches


def generator_step_trace(g, label, ids, tokens, steps=4):
    """Where a generator's greedy token step goes: `generate`'s loop body
    (the key's fold_in, then `_decode_call`) for ``steps`` steps after a
    prefill of ``ids``, fed ``tokens`` [b, steps + 1]; timed, then under
    the profiler. Reports host wall and device busy ms a step, the idle
    share, the host-to-device copies and cudaStreamSynchronize calls a
    step (each blocking copy of a host number makes the host wait for the
    stream), the host's op count and self CPU ms a step and its costliest
    ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.core import random as prandom

    prompt = ids.shape[1]

    def body():
        state = g._make_state(ids.shape[0])
        _, state = g._prefill_call(ids, state)
        key = prandom.key(0).to("cuda")
        torch.cuda.synchronize()
        return state, key

    def loop(state, key):
        for i in range(steps):
            key = prandom.fold_in(key, i)
            g._decode_call(tokens[:, i], state, prompt + i, key, 0.0, None,
                           None)
        torch.cuda.synchronize()

    state, key = body()
    t = time.perf_counter()
    loop(state, key)
    wall = 1e3 * (time.perf_counter() - t) / steps
    state, key = body()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop(state, key)
    groups, top = _device_ms(prof)
    busy = sum(groups.values()) / steps
    h2d = waits = ops = 0
    cpu = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            h2d += evt.count if "HtoD" in evt.key else 0
            continue
        waits += evt.count if evt.key == "cudaStreamSynchronize" else 0
        if evt.key.startswith("aten::"):
            ops += evt.count
        if evt.key != "cudaDeviceSynchronize":   # the loop's own wait
            cpu[evt.key] = 1e-3 * evt.self_cpu_time_total
    per = {k: round(ms / steps, 4) for k, ms in
           sorted(groups.items(), key=lambda kv: -kv[1])}
    log(f"generator step trace, {label}: host wall {wall:.3f} ms a token "
        f"step, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / wall:.3f}; host-to-device copies {h2d / steps:.2f}, "
        f"cudaStreamSynchronize calls {waits / steps:.2f}, aten ops "
        f"{ops / steps:.0f} and self CPU {sum(cpu.values()) / steps:.3f} ms "
        f"(under the profiler) a step; device ms a step by group "
        f"{json.dumps(per)}")
    for name, ms in top:
        log(f"  {ms / steps:.4f} ms/step  {name[:110]}")
    for name, ms in sorted(cpu.items(), key=lambda kv: -kv[1])[:6]:
        log(f"  host {ms / steps:.4f} ms/step  {name[:100]}")
    if busy == 0.0:
        log("  torch.profiler recorded no device time here: the device "
            "split of this window is not measured")


def gpt_trainer_phase(cfg, seed=0, batch=8, seq=1024, warmup=2, steps=4):
    """Phase 27 (a): GPT-3 1.3B at bf16 O1 through TrainStep and AdamW
    under LinearWarmup(CosineAnnealingDecay(2e-4, T_max, eta_min=2e-5),
    2 warm-up steps from 0 to 2e-4), weight decay 0.01, global-norm clip
    1.0, the scheduler stepped after each step. Losses finite and falling;
    the rate each step reads equals the scheduler's; each bf16 flash kernel
    once a layer a step, all through the wgmma kernels (d = 128), nothing
    else. Returns the trainer, its batch and the bf16 flash launches."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import GPT, gpt_loss_fn
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = GPT(cfg, device="cuda", seed=seed)
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(
        2e-4, T_max=warmup + steps, eta_min=2e-5), 2, 0.0, 2e-4)
    opt = AdamW(learning_rate=sched, weight_decay=0.01,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    trainer = TrainStep(model, gpt_loss_fn, opt, amp_level="O1")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1), device="cuda",
                         generator=gen)
    ids, labels = toks[:, :-1], toks[:, 1:]
    n_params = sum(p.numel() for p in model.parameters())
    log(f"GPT trainer setup (O1): GPT-3 1.3B widths at full depth "
        f"({cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_heads} heads of "
        f"{cfg.hidden_size // cfg.num_heads}, ffn {cfg.ffn_hidden}, vocab "
        f"{cfg.vocab_size}, tied head), {n_params / 1e9:.3f} B fp32 params, "
        f"batch [{batch}, {seq}], {time.perf_counter() - t0:.1f} s")
    fa.reset_counts()
    losses, rates = [], []

    def one_step():
        before = _flash_counts(bf16=True)
        want = sched.get_lr()
        losses.append(trainer(ids, labels))
        rates.append((opt.param_groups[0]["lr"], want))
        sched.step()
        after = _flash_counts(bf16=True)
        for name in after:
            if after[name][0] - before[name][0] != cfg.num_layers:
                raise AssertionError(
                    f"{name} launched {after[name][0] - before[name][0]} "
                    f"times in a step, not {cfg.num_layers}")

    with _no_dense_attention():
        for _ in range(warmup):
            one_step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t) / steps
    launches = {name: kl for name, (kl, _) in
                _flash_counts(bf16=True).items()}
    plain = _other_flash_launches(False, True)
    values = [x.float().item() for x in losses]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"GPT trainer losses (O1, {losses[0].dtype}): "
        f"{[round(x, 5) for x in values]}; rates read / scheduled "
        f"{[(float(f'{a:.4e}'), float(f'{b:.4e}')) for a, b in rates]}")
    log(f"GPT trainer run (O1): {warmup} warm-up + {steps} timed steps, mean "
        f"step {step_ms:.1f} ms = {batch * seq / step_ms * 1e3:.1f} "
        f"tokens/s, peak memory {peak:.2f} GiB, bf16 flash launches "
        f"{launches} ({cfg.num_layers} each per step), plain versions and "
        f"other flash forms {plain}, dense attention calls 0")
    if not all(np.isfinite(values)) or not values[-1] < values[0]:
        raise AssertionError(f"GPT losses not finite and falling: {values}")
    if any(a != b for a, b in rates) or len({b for _, b in rates}) < 3:
        raise AssertionError(f"GPT trainer: rates read {rates}")
    if plain != 0 or any(n != cfg.num_layers * (warmup + steps)
                         for n in launches.values()):
        raise AssertionError(f"GPT trainer missed a flash kernel: "
                             f"{launches}, plain launches {plain}")
    variants = _variant_launches("GPT trainer (O1)", False, True,
                                 cfg.hidden_size // cfg.num_heads,
                                 cfg.num_layers * (warmup + steps))
    if set(v for d in variants.values() for v in d) != {"wgmma"}:
        raise AssertionError(f"GPT trainer: not all wgmma: {variants}")
    log(f"GPT trainer flash launches by variant: {json.dumps(variants)}")
    return trainer, (ids, labels), launches


def gpt_phases(gen):
    """Phases 25-27 at GPT-3 1.3B: serving, the generators, O1 training,
    an fp32 2-layer step against the dense path and the bf16 K3 kernels
    at the GPT trainer's shape. Returns {kernel: launches on the GPT
    paths}, the bf16 K3 rows at that shape and {serving kernel: max abs
    error against its plain version at the GPT shapes}."""
    from paddle_tpu_torch.models import GPT, GPT3_1_3B
    from paddle_tpu_torch.serving import GPTRunner

    cfg = GPT3_1_3B
    model = GPT(cfg, device="cuda", seed=0)
    eng, launches, _, _, prompts, forms = engine_phase(
        model, cfg, max_model_len=cfg.max_seq_len)
    log(f"GPT engine launches by form: {json.dumps(forms)}")
    profile_phase(eng, cfg)
    del eng
    _free_the_card()
    gpt = {"engine": launches}
    for kind in ("int8", "fp8"):
        counts = dict(_all_counts())
        name = f"ragged_paged_attention_{kind}"
        counts[name].reset()
        single_slot_check(model, cfg, kind, sorted(prompts, key=len)[:2])
        gpt[f"single_slot_{kind}"] = {name: counts[name].kernel_launches}
        _free_the_card()
    # K1, K1-q and K2 at the GPT path's shapes (16 heads of 128, n_rep 1)
    # against their plain versions on the same pools: 256-token chunks
    # (K1's span form), chunks of 1-8 rows in the 8-row bucket (its
    # decode form), decode rows (K1-q; K2 over fp32 pools)
    h = cfg.num_heads
    errs = {"paged_decode_attention": check_paged(gen, h, " GPT")}
    for kind in ("fp32", "int8", "fp8"):
        name = "ragged_paged_attention" + ("" if kind == "fp32"
                                           else f"_{kind}")
        errs[name] = max(check_ragged(h, h, gen, f"GPT {label}", kind, spans)
                         for label, spans in (("chunk", SPANS_CHUNK),
                                              ("short chunks", SPANS_SHORT),
                                              ("decode", SPANS_DECODE)))
    # then the same through GPTRunner against its gather path: chunks of
    # 256, 256, 8, 3, 1, decode steps of 1-8 rows; at full depth over
    # fp32 pools; over int8 / fp8 at 2 layers as phase 7 (each run
    # quantizes its own K/V, so at full depth the two runs' codes part;
    # that reading is reported beside them, not gated)
    small = GPT(replace(cfg, num_layers=2), device="cuda", seed=2)
    for kind, m, gate in (("fp32", model, True), ("int8", small, True),
                          ("fp8", small, True), ("int8", model, False),
                          ("fp8", model, False)):
        n = m.cfg.num_layers
        if kind == "fp32":
            want = {"ragged_paged_attention": (5 * n, {"span": 2 * n,
                                                       "decode": 3 * n}),
                    "paged_decode_attention": (8 * n, {})}
        else:
            want = {f"ragged_paged_attention_{kind}": (
                13 * n, {"span": 2 * n, "decode": 11 * n})}
        quant_model_check(m, GPTRunner, kind, want, gate,
                          chunks=(256, 256, 8, 3, 1), steps=8,
                          rows=tuple(range(1, 9)))
        _free_the_card()
    del small
    gpt["paged_generator"] = {
        "paged_decode_attention": gpt_generator_phase(model, cfg)}
    del model
    _free_the_card()
    trainer, batch, flash = gpt_trainer_phase(cfg)
    gpt["trainer_o1"] = flash
    train_profile_phase(
        trainer, batch, cfg.num_layers,
        sum(p.numel() for n, p in trainer.model.named_parameters()
            if p.dim() == 2 and n != "wpe.weight"), "GPT O1", bf16=True)
    del trainer, batch
    _free_the_card()
    dense_check_phase(replace(cfg, num_layers=2), gpt=True)
    _free_the_card()
    b, s, h, d = 8, cfg.max_seq_len, cfg.num_heads, \
        cfg.hidden_size // cfg.num_heads
    ratio, err, share = check_bf16(gen, "GPT trainer shape", b, s, s, h, d,
                                   True)
    _free_the_card()
    times = measure_flash(gen, b=b, s=s, h=h, d=d, dtype=torch.bfloat16)
    _free_the_card()
    rows = {name: {"shape": f"[{b},{s},{h},{d}] causal", **times[name],
                   "fp64_ratio": ratio[name], "max_abs_err": err[name],
                   "misround": share[name]}
            for name, _ in FLASH_KERNELS}
    log(f"GPT paths' launches: {json.dumps(gpt)}")
    return gpt, rows, errs


def _free_the_card() -> float:
    """Collect what the freed phases left; returns GiB still allocated."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


# (BM, BN) of the backward kernels' instantiations (Bwd<MAXD> in
# csrc/flash_attention.cu), for their dynamic shared memory at d = MAXD
BWD_TILES = {64: (128, 32), 128: (128, 32), 256: (64, 16)}


def _kernel_label(mangled: str) -> str:
    """'flash_bwd_dq_kernel<128>' or 'ragged_span_kernel<128,1>' from a
    mangled entry name: its length-prefixed name that ends in _kernel,
    with the integer template arguments after it. Every position of a
    digit run is tried, since a length may follow the digits of an
    anonymous namespace's hash ('...a219flash_bwd_dq_kernelILi128E...'),
    and the last name found wins: the kernel's is the innermost part of
    the nested name, while a hash that ends in digits can read as the
    length of a longer span that also ends in _kernel."""
    found = None
    for m in re.finditer(r"(?=(\d+))", mangled):
        at = m.start() + len(m.group(1))
        name = mangled[at:at + int(m.group(1))]
        if name.endswith("_kernel") and name.isidentifier():
            found = at, name
    if found is None:
        return mangled
    at, name = found
    args = re.match(r"I((?:Li\d+E)+)E", mangled[at + len(name):])
    if not args:
        return name
    return name + "<" + ",".join(
        re.findall(r"Li(\d+)E", args.group(1))) + ">"


# the kernels that multiply on the tensor cores, and every instantiation
# of them the build must hold (the ragged span form's second argument is
# the pool type: 0 fp32, 1 int8, 2 fp8): the three bf16 kernels run on
# wgmma at d <= 128 (flash_attention_wgmma.cu) and keep their mma.sync
# kernels for d <= 256 only
WGMMA_KERNELS = ("flash_fwd_bf16_wgmma_kernel",
                 "flash_bwd_dq_bf16_wgmma_kernel",
                 "flash_bwd_dkv_bf16_wgmma_kernel")
TENSOR_CORE_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                       "flash_bwd_dkv_kernel", "flash_fwd_bf16_kernel",
                       "flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel",
                       *WGMMA_KERNELS, "ragged_span_kernel")
TENSOR_CORE_INSTANTIATIONS = (
    *(f"{k}<{d}>" for k in TENSOR_CORE_KERNELS[:3] for d in (64, 128, 256)),
    *(f"{k}<256>" for k in TENSOR_CORE_KERNELS[3:6]),
    *(f"{k}<{d}>" for k in WGMMA_KERNELS for d in (64, 128)),
    *(f"ragged_span_kernel<{d},{kv}>" for d in (128, 256) for kv in range(3)))


def build_report(build) -> None:
    """Phase 2's report: each kernel entry's registers and spills (ptxas;
    a wgmma kernel that spills fails the run: its accumulators would go
    through local memory), the backward kernels' shared memory per
    instantiation, and whether the SASS of every tensor-core kernel (the
    three flash kernels, the bf16 wgmma kernels, the ragged span form)
    holds tensor-core instructions in every instantiation (HMMA:
    mma.sync, HGMMA: wgmma; the wgmma kernels HGMMA), from cuobjdump -sass
    of the built library; one without them, or missing, fails the run."""
    if not build.log:
        log("  ptxas: the library was built by an earlier process (its "
            "register report is in that build's log)")
    name, spilled = None, {}
    for ln in build.log.splitlines():
        if "Compiling entry function" in ln:
            name = _kernel_label(ln.split("'")[1])
        elif name and ("registers" in ln or "spill" in ln):
            log(f"  ptxas {name}: {ln.split(':', 1)[-1].strip()}")
            if "spill" in ln and name.startswith(WGMMA_KERNELS):
                spilled[name] = re.findall(r"(\d+) bytes spill", ln) \
                    != ["0", "0"]
        if "C7512" in ln:   # ptxas serialized a kernel's wgmma
            log(f"  ptxas: {ln.strip()}")
    if any(spilled.values()):
        raise AssertionError(f"a wgmma kernel spills registers: {spilled}")
    for maxd, (bm, bn) in BWD_TILES.items():
        ld = (maxd + 31) // 32 * 32
        base = (2 * bm + 4 * bn) * ld + 8 * 16 * 32
        log(f"  shared memory at d = {maxd}: flash_bwd_dq_kernel<{maxd}> "
            f"{4 * base} B, flash_bwd_dkv_kernel<{maxd}> "
            f"{4 * (base + 4 * bn)} B (BM {bm}, BN {bn})")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(build.path)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        log(f"  SASS: cuobjdump not usable ({e}); tensor-core use unchecked")
        return
    found = {}
    for section in sass.split("Function : ")[1:]:
        label = _kernel_label(section.split("\n", 1)[0].strip())
        if label.startswith(TENSOR_CORE_KERNELS):
            found[label] = (section.count("HMMA"), section.count("HGMMA"))
            log(f"  SASS {label}: {found[label][0]} HMMA, "
                f"{found[label][1]} HGMMA instructions")
    if set(found) != set(TENSOR_CORE_INSTANTIATIONS) or not all(
            (n[1] if label.startswith(WGMMA_KERNELS) else sum(n)) > 0
            for label, n in found.items()):
        raise AssertionError(f"a tensor-core kernel's SASS holds no "
                             f"tensor-core products (a wgmma kernel no "
                             f"HGMMA), or an instantiation is missing: "
                             f"{found}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.models import ERNIE3_BASE, LLAMA2_7B, Llama
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.serving import LlamaRunner
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "root of a checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 matmuls (AMP) sum in fp32 throughout, as XLA's do: no bf16
    # rounding of cuBLAS's split-K partial sums
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    t_start = time.perf_counter()
    card = gpu_line()
    log(f"device: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    _build.library()
    log(f"build: {_build.BUILD.seconds:.1f} s -> {_build.BUILD.path.name}")
    build_report(_build.BUILD)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs = {"ragged_paged_attention": max(check_ragged(32, 32, gen, "MHA"),
                                          check_ragged(32, 8, gen, "GQA"))}
    for kind in ("int8", "fp8"):
        errs[f"ragged_paged_attention_{kind}"] = max(
            check_ragged(32, 32, gen, "MHA decode", kind, SPANS_DECODE),
            check_ragged(32, 32, gen, "MHA chunk", kind, SPANS_CHUNK),
            check_ragged(32, 8, gen, "GQA", kind))
    errs["paged_decode_attention"] = check_paged(gen)
    sampler_phase()

    cfg = LLAMA2_7B
    model = Llama(cfg, device="cuda", seed=0)
    eng, launches, positions, fp32_tokens, _, forms = engine_phase(model,
                                                                   cfg)
    profile_phase(eng, cfg)
    del eng
    _free_the_card()
    greedy_stops = [t[20] for t in fp32_tokens[:4]]
    graphs_phase(model, cfg, "fp32")
    _free_the_card()
    horizon_launches = {
        "paged_decode_attention": horizon_phase(model, cfg, "fp32",
                                                greedy_stops)}
    gemm_row_invariance(gen)
    for kind in ("int8", "fp8"):
        eng, more, _, _, prompts, more_forms = engine_phase(
            model, cfg, kind, ref_tokens=fp32_tokens)
        launches.update(more)
        forms.update(more_forms)
        profile_phase(eng, cfg)
        del eng
        _free_the_card()
        graphs_phase(model, cfg, kind)
        _free_the_card()
        horizon_launches[f"ragged_paged_attention_{kind}"] = horizon_phase(
            model, cfg, kind, greedy_stops)
        # the two shortest prompts fit one 256-token chunk
        single_slot_check(model, cfg, kind, sorted(prompts, key=len)[:2])
        _free_the_card()
    del model
    _free_the_card()
    small = Llama(replace(cfg, num_layers=2), device="cuda", seed=2)
    for kind in ("int8", "fp8"):
        quant_model_check(small, LlamaRunner, kind, {
            f"ragged_paged_attention_{kind}": (20, {"span": 4,
                                                    "decode": 16})})
    del small
    _free_the_card()

    P = 4096 // 16
    decode = (positions, [1] * len(positions), 1)
    meas = {}
    for kind in ("fp32", "int8", "fp8"):
        name = ("ragged_paged_attention" if kind == "fp32"
                else f"ragged_paged_attention_{kind}")
        meas[name] = measure_ragged(gen, cfg.num_heads, 1024, P, kind)
        # the decode form at the engine's decode positions, MHA; over fp32
        # pools also at GQA n_rep 4 (8 kv heads), the decode form's other
        # caller (the fp32 MHA engine decodes through K2)
        dec = measure_ragged(gen, cfg.num_heads, 1024, P, kind, decode)
        if kind == "fp32":
            gqa = measure_ragged(gen, cfg.num_heads, 1024, P, kind, decode,
                                 n_kv=cfg.num_heads // 4)
            meas[name]["decode_mha_fp64_ratio"] = dec["fp64_ratio"]
            dec = gqa
        meas[name]["decode"] = dec
        meas[name]["max_abs_err"] = max(meas[name]["max_abs_err"],
                                        dec["max_abs_err"])
    meas["paged_decode_attention"] = measure_paged(gen, cfg.num_heads, 1024,
                                                   P, positions)
    rows = []
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "fp64_ratio")
    k1_src = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
    k1_tpu = "paddle_tpu/ops/pallas/ragged_paged_attention.py:142"
    for name, src, replaces in (
            ("ragged_paged_attention", k1_src, k1_tpu),
            ("ragged_paged_attention_int8", k1_src, k1_tpu),
            ("ragged_paged_attention_fp8", k1_src, k1_tpu),
            ("paged_decode_attention",
             "paddle_tpu_torch/csrc/paged_decode_attention.cu",
             "paddle_tpu/ops/pallas/paged_attention.py:92")):
        m = meas[name]
        shapes = [(m["shape"], m)]
        if "decode" in m:
            shapes.append((m["decode"]["shape"], m["decode"]))
        for shape, t in shapes:
            log(f"timing {name} at {shape}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"({t['bound_by']}), library (SDPA on pre-gathered K/V) "
                f"{t['library_ms']:.4f} ms, max_abs_err "
                f"{t['max_abs_err']:.3e}")
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": max(errs[name], m["max_abs_err"]),
               **{k: m[k] for k in keys if k in m}}
        if name in forms:
            row["launches_by_form"] = forms[name]
        if name in horizon_launches:
            row["horizon_launches"] = horizon_launches[name]
        if "decode" in m:
            row.update({f"decode_{k}": m["decode"][k] for k in keys})
        if "decode_mha_fp64_ratio" in m:
            row["decode_mha_fp64_ratio"] = m["decode_mha_fp64_ratio"]
        rows.append(row)

    # the training path: the engines, the model and the runners are gone
    _free_the_card()
    flash_err = flash_checks(gen)
    masked_err = masked_checks(gen)
    left = _free_the_card()
    log(f"before the trainer: {left:.3f} GiB allocated")
    if left >= 1.0:
        raise AssertionError(f"{left:.2f} GiB still allocated after the "
                             "serving phases; the trainer needs the card")
    train_cfg = replace(cfg, num_layers=8)
    trainer, batch, flash_launches, _ = trainer_phase(train_cfg)
    train_profile_phase(
        trainer, batch, train_cfg.num_layers,
        sum(p.numel() for n, p in trainer.model.named_parameters()
            if p.dim() == 2 and n != "embed_tokens.weight"), "training")
    del trainer, batch
    _free_the_card()
    dense_check_phase(replace(cfg, num_layers=2))
    _free_the_card()
    acc = check_vs_fp64(gen)
    _free_the_card()
    flash = measure_flash(gen)
    _free_the_card()

    # the ERNIE pretraining path: the masked kernels (K3-m)
    ernie, data, masked_launches, _ = ernie_trainer_phase(ERNIE3_BASE)
    train_profile_phase(ernie, data, ERNIE3_BASE.num_layers,
                        ernie_matmul_weights(ernie.model), "ERNIE",
                        masked=True)
    del ernie
    _free_the_card()
    ernie_check_phase(replace(ERNIE3_BASE, num_layers=2))
    _free_the_card()
    acc_masked = check_vs_fp64(gen, h=12, d=64, causal=False, att=data[2])
    _free_the_card()
    masked = measure_flash(gen, h=12, d=64, causal=False, att=data[2])
    _free_the_card()

    # the bf16 AMP paths: the bf16 kernels, ERNIE and Llama at O1, O2
    bf16_checks = bf16_flash_checks(gen, data[2])
    flash_bf16 = measure_flash(gen, dtype=torch.bfloat16)
    _free_the_card()
    masked_bf16 = measure_flash(gen, h=12, d=64, causal=False, att=data[2],
                                dtype=torch.bfloat16)
    _free_the_card()
    for shape, times in (("q/k/v [1,4096,32,128] causal", flash_bf16),
                         ("q/k/v [16,512,12,64] + kbias", masked_bf16)):
        dq, pair = times["flash_backward_dq"], times["pair"]
        log(f"K3b-dq-bf16 at {shape}: {dq['ms']:.4f} ms, "
            f"{100 * dq['bound_ms'] / dq['ms']:.1f} % of its bound "
            f"{dq['bound_ms']:.4f} ms; with dk/dv {pair['kernels_ms']:.4f} "
            f"ms, {pair['kernels_ms'] / pair['library_ms']:.3f}x SDPA's bf16 "
            f"backward {pair['library_ms']:.4f} ms")
    ernie, data_o1, masked_bf16_launches, masked_bf16_variants = \
        ernie_trainer_phase(ERNIE3_BASE, amp_level="O1")
    train_profile_phase(ernie, data_o1, ERNIE3_BASE.num_layers,
                        ernie_matmul_weights(ernie.model), "ERNIE O1",
                        masked=True, bf16=True)
    del ernie, data_o1
    _free_the_card()
    trainer, batch, bf16_launches, bf16_variants = trainer_phase(
        train_cfg, amp_level="O1")
    train_profile_phase(
        trainer, batch, train_cfg.num_layers,
        sum(p.numel() for n, p in trainer.model.named_parameters()
            if p.dim() == 2 and n != "embed_tokens.weight"), "training O1",
        bf16=True)
    del trainer, batch
    _free_the_card()
    o2_phase(replace(cfg, num_layers=2))
    _free_the_card()
    amp_twins_phase(replace(cfg, num_layers=2))
    _free_the_card()
    log(f"before the GPT phases: {time.perf_counter() - t_start:.1f} s")

    # the GPT family at GPT-3 1.3B widths: serving, generators, O1 training
    gpt_launches, gpt_bf16, gpt_errs = gpt_phases(gen)
    log(f"after the GPT phases: {time.perf_counter() - t_start:.1f} s")
    for row in rows:       # the serving kernels on the GPT paths
        row["gpt_max_abs_err"] = gpt_errs[row["name"]]
        row["gpt_launches"] = {path: n[row["name"]] for path, n in
                               gpt_launches.items() if row["name"] in n}

    for label, times, launches, errs in (
            ("", flash, flash_launches, (flash_err, acc)),
            ("_masked", masked, masked_launches, (masked_err, acc_masked))):
        for name, replaces in FLASH_KERNELS:
            row = {"name": name + label, "route": "cuda",
                   "source": "paddle_tpu_torch/csrc/flash_attention.cu",
                   "replaces": replaces, "launches": launches[name],
                   "max_abs_err": max(e[name] for e in errs),
                   **times[name]}
            if name == "flash_forward":
                row["fp64_ratio"] = errs[1]["fwd_fp64_ratio"]
            rows.append(row)
    for label, times, launches, variants, kind in (
            ("_bf16", flash_bf16, bf16_launches, bf16_variants, "dense"),
            ("_masked_bf16", masked_bf16, masked_bf16_launches,
             masked_bf16_variants, "masked")):
        for name, replaces in FLASH_KERNELS:
            wgmma = "wgmma" in variants[name]
            rows.append({"name": name + label, "route": "cuda",
                         "source": "paddle_tpu_torch/csrc/" + (
                             "flash_attention_wgmma.cu" if wgmma
                             else "flash_attention.cu"),
                         "kernel": BF16_KERNEL_NAMES[name][wgmma],
                         "replaces": replaces, "launches": launches[name],
                         "launches_by_variant": variants[name],
                         "max_abs_err": bf16_checks[kind]["err"][name],
                         **times[name],
                         "fp64_ratio": bf16_checks[kind]["ratio"][name],
                         "misround": bf16_checks[kind]["misround"][name]})
            if kind == "dense":
                rows[-1]["gpt_launches"] = {
                    "trainer_o1": gpt_launches["trainer_o1"][name]}
                rows[-1]["gpt_shape"] = gpt_bf16[name]
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
