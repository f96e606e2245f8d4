#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. device   the card's name and power limit (nvidia-smi) and
              torch.cuda.get_device_name(0); no usable card raises.
  2. build    nvcc builds the kernels from paddle_tpu_torch/csrc (one
              process per source, started together) and the seconds it
              took are printed with ptxas's register report.
  3. kernels  each kernel's wrapper against its plain PyTorch version on
              the card: the ragged kernel (K1) at LLaMA-2-7B heads and at a
              GQA layout over mixed spans (decode, chunks at start_pos > 0
              crossing page boundaries, a dead slot, padded bucket rows),
              the paged-decode kernel (K2) at b=8, h=32, d=128 with pos on
              and off page boundaries, then both at the shapes the engine
              gives them (phase 6). Tolerance: max |kernel - plain| <= 1e-4
              in fp32 (the two sum in different orders); padded and dead
              rows must be exactly 0. Times are medians of CUDA-event
              timings. The sweep over every head dim the gates admit, GQA
              group and page size is tests/test_torch_cuda.py.
  4. engine   LLaMA-2-7B at full width and depth, fp32, seeded random
              weights built on the card, served through
              inference.create_serving_engine: 8 requests with seeded
              prompt lengths 100-600 and max_tokens=32 under a 256-token
              prefill budget. Both kernels must have launched on this run
              and neither plain version; two requests must match
              naive_generate token for token (the first divergence, if
              any, is printed and fails the run).
  5. profile  where a step's time goes: torch.profiler over steps of one
              256-token prefill chunk each and over decode-only steps of 8
              sequences, device time by kernel group, each kernel's device
              time per launch, and the idle share against the wall of as
              many unprofiled steps.
  6. timing   each kernel at the engine's shapes against its plain
              version, its bound and the library yardstick, with L2
              flushed before every timed call.
  7. summary  one JSON line of every kernel's launches, error and times,
              the nvidia-smi line, then the result line.

fp32 products stay fp32: TF32 is switched off for matmuls and cuDNN.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_FLOP_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
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


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` with a cold L2 before each call
    (the flush runs outside the timed interval)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        _flush_l2()
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


def check_ragged(n_q, n_kv, gen, label):
    """K1 against ragged_reference over mixed spans; returns max error."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_reference,
    )
    d, ps, T, P = 128, 16, 64, 16
    # decode, chunk crossing pages at an offset, dead slot, full chunk,
    # short chunk with padded bucket rows
    start = [37, 40, 0, 0, 100]
    qlen = [1, 50, 0, 64, 20]
    B = len(start)
    k_pool, v_pool = _pools(B * P + 1, ps, n_kv, d, gen)
    table = _tables(B, P, B * P + 1, gen)
    table[2] = 0                                  # dead slot: all scratch
    q = torch.randn(B, T, n_q, d, device=gen.device, generator=gen)
    st = torch.tensor(start, dtype=torch.int32, device=gen.device)
    ql = torch.tensor(qlen, dtype=torch.int32, device=gen.device)
    out = ragged_paged_attention(q, k_pool, v_pool, table, st, ql)
    ref = ragged_reference(q, k_pool, v_pool, table, st, ql)
    err = (out - ref).abs().max().item()
    for b in range(B):
        if not bool((out[b, qlen[b]:] == 0).all()):
            raise AssertionError(f"K1 {label}: rows past q_len of sequence "
                                 f"{b} are not exactly 0")
    log(f"kernel K1 ragged {label} (n_q={n_q}, n_kv={n_kv}, d={d}, ps={ps}, "
        f"spans start={start} q_len={qlen}): max_abs_err={err:.3e}, padded "
        "and dead rows exactly 0")
    if not err <= TOL:
        raise AssertionError(f"K1 {label}: max_abs_err {err} > {TOL}")
    return err


def check_paged(gen):
    """K2 against paged_decode_reference, pos on and off page boundaries."""
    from paddle_tpu_torch.ops.paged_attention import (
        paged_decode_attention, paged_decode_reference,
    )
    b, h, d, ps, P = 8, 32, 128, 16, 40
    pos = [0, 15, 16, 17, 31, 100, 255, 600]
    k_pool, v_pool = _pools(b * P + 1, ps, h, d, gen)
    table = _tables(b, P, b * P + 1, gen)
    q = torch.randn(b, h, d, device=gen.device, generator=gen)
    p = torch.tensor(pos, dtype=torch.int32, device=gen.device)
    out = paged_decode_attention(q, k_pool, v_pool, table, p)
    ref = paged_decode_reference(q, k_pool, v_pool, table, p)
    err = (out - ref).abs().max().item()
    log(f"kernel K2 paged_decode (b={b}, h={h}, d={d}, ps={ps}, pos={pos}): "
        f"max_abs_err={err:.3e}")
    if not err <= TOL:
        raise AssertionError(f"K2: max_abs_err {err} > {TOL}")
    return err


def measure_ragged(gen, n_heads, num_blocks, P):
    """K1 at the engine's prefill-chunk shape: the second 256-token chunk
    of a longer prompt (keys 0..511 visible), MHA at 7B heads."""
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        ragged_paged_attention, ragged_reference,
    )
    d, ps, T, start = 128, 16, 256, 256
    k_pool, v_pool = _pools(num_blocks, ps, n_heads, d, gen)
    table = _tables(1, P, num_blocks, gen, used=[(start + T) // ps])
    q = torch.randn(1, T, n_heads, d, device="cuda", generator=gen)
    st = torch.tensor([start], dtype=torch.int32, device="cuda")
    ql = torch.tensor([T], dtype=torch.int32, device="cuda")
    out = ragged_paged_attention(q, k_pool, v_pool, table, st, ql)
    ref = ragged_reference(q, k_pool, v_pool, table, st, ql)
    err = (out - ref).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"K1 engine shape: max_abs_err {err} > {TOL}")
    ms = median_ms(lambda: ragged_paged_attention(q, k_pool, v_pool, table,
                                                  st, ql))
    plain = median_ms(lambda: ragged_reference(q, k_pool, v_pool, table,
                                               st, ql), iters=5)
    # library yardstick: SDPA over the pre-gathered visible keys
    L = start + T
    idx = table[0, :L // ps].long()
    kg = k_pool[idx].reshape(1, L, n_heads, d).transpose(1, 2).contiguous()
    vg = v_pool[idx].reshape(1, L, n_heads, d).transpose(1, 2).contiguous()
    qT = q.transpose(1, 2).contiguous()
    mask = (torch.arange(L, device="cuda")[None, :]
            <= start + torch.arange(T, device="cuda")[:, None])
    lib = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qT, kg, vg, attn_mask=mask))
    # the least work: each visible K/V row read once, q read, out written;
    # 4*d FLOPs per visible (row, key, head)
    nbytes = 4 * (2 * q.numel() + 2 * L * n_heads * d) + 4 * (P + 2)
    flops = 4 * d * n_heads * sum(start + t + 1 for t in range(T))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S
    return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib,
                shape=f"q[1,{T},{n_heads},{d}] start_pos={start} "
                      f"pool[{num_blocks},{ps},{n_heads},{d}] table[1,{P}]")


def measure_paged(gen, n_heads, num_blocks, P, positions):
    """K2 at the engine's decode shape: 8 sequences at ``positions``."""
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
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOP_PER_S
    return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=lib,
                shape=f"q[{b},{n_heads},{d}] pos={positions} "
                      f"pool[{num_blocks},{ps},{n_heads},{d}] table[{b},{P}]")


# ------------------------------------------------------------- engine

def _peak_gib(device) -> float:
    if device.type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated() / 2**30


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


def engine_phase(cfg, seed=0, n_requests=8, max_tokens=32, device="cuda"):
    import paddle_tpu_torch.ops.paged_attention as k2
    import paddle_tpu_torch.ops.ragged_paged_attention as k1
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import Llama
    from paddle_tpu_torch.serving import SamplingParams

    t0 = time.perf_counter()
    model = Llama(cfg, device=device, seed=seed)
    eng = create_serving_engine(
        model, device=device, block_size=16, num_blocks=1024,
        max_batch_size=8, max_model_len=4096,
        max_prefill_tokens_per_step=256, audit=True)
    log(f"engine setup: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"heads {cfg.num_heads}/{cfg.num_kv_heads}, fp32 weights "
        f"{sum(p.numel() for p in model.parameters()) * 4 / 2**30:.2f} GiB, "
        f"pool {eng.pool.memory_bytes() / 2**30:.2f} GiB, "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    lens = rng.integers(100, 601, n_requests)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in lens]
    sp = SamplingParams(max_tokens=max_tokens)

    for counts in (k1.COUNTS, k2.COUNTS):
        counts.reset()
    if eng.runner.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ids = [eng.add_request(p, sp) for p in prompts]
    decode_ms = []
    t_run = time.perf_counter()
    while eng.has_work():
        chunks = eng.metrics.prefill_chunks.value
        t = time.perf_counter()
        eng.step()      # ends in a blocking drain of the step's tokens
        if eng.metrics.prefill_chunks.value == chunks:
            decode_ms.append(1e3 * (time.perf_counter() - t))
    wall = time.perf_counter() - t_run
    launches = {"ragged_paged_attention": k1.COUNTS.kernel_launches,
                "paged_decode_attention": k2.COUNTS.kernel_launches}
    plain = k1.COUNTS.plain_launches + k2.COUNTS.plain_launches
    outs = eng.outputs()
    m = eng.metrics
    log(f"engine run: {len(outs)}/{n_requests} finished, prompt lens "
        f"{lens.tolist()}, {int(m.tokens_generated.value)} tokens in "
        f"{wall:.3f} s = {m.tokens_generated.value / wall:.1f} tokens/s, "
        f"TTFT mean {1e3 * m.ttft_s.mean:.1f} ms p50 "
        f"{1e3 * m.ttft_s.percentile(50):.1f} ms, {len(decode_ms)} "
        f"decode-only steps mean {statistics.mean(decode_ms):.2f} ms, "
        f"{int(m.prefill_chunks.value)} prefill chunks, "
        f"{int(m.preemptions.value)} preemptions, peak memory "
        f"{_peak_gib(eng.runner.device):.2f} GiB")
    log(f"engine launches: {launches}, plain launches {plain}")
    if len(outs) != n_requests or any(
            o.finish_reason != "length" or len(o.output_tokens) != max_tokens
            for o in outs.values()):
        raise AssertionError("not every request finished with max_tokens")
    if min(launches.values()) == 0 or plain != 0:
        raise AssertionError(f"main path missed a kernel: {launches}, "
                             f"plain launches {plain}")
    if not eng.pool.allocator.check_no_leaks():
        raise AssertionError("engine leaked KV pages")
    # the longest prompt (prefilled in three chunks) and the shortest
    for i in (int(np.argmax(lens)), int(np.argmin(lens))):
        verdict = check_against_naive(eng.runner, prompts[i],
                                      outs[ids[i]].output_tokens, sp, 4096)
        log(f"naive_generate check, request {i} (prompt {lens[i]}): "
            f"{verdict}")
    positions = [int(n) + max_tokens // 2 for n in lens]
    return eng, launches, positions


# ------------------------------------------------------------ profile

def _kernel_group(name: str) -> str:
    low = name.lower()
    if "paged_decode_kernel" in name:
        return "K2 paged_decode_attention"
    if "ragged_kernel" in name:
        return "K1 ragged_paged_attention"
    if "gemm" in low or "gemv" in low or "cutlass" in low or "xmma" in low:
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
        if evt.device_type != DeviceType.CUDA:
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
    """Where a step's time goes: torch.profiler over (a) steps that each
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
        launches = (k1.COUNTS.kernel_launches, k2.COUNTS.kernel_launches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize()
        groups, top = _device_ms(prof)
        busy = sum(groups.values()) / steps
        n1 = k1.COUNTS.kernel_launches - launches[0]
        n2 = k2.COUNTS.kernel_launches - launches[1]
        per = {g: round(ms / steps, 4) for g, ms in
               sorted(groups.items(), key=lambda kv: -kv[1])}
        per_launch = {name: round(groups.get(g, 0.0) / n, 4)
                      for name, g, n in (
                          ("K1", "K1 ragged_paged_attention", n1),
                          ("K2", "K2 paged_decode_attention", n2)) if n}
        log(f"profile {label}: host wall {wall:.3f} ms/step, device busy "
            f"{busy:.3f} ms/step, idle share {1 - busy / wall:.3f}; K1/K2 "
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    try:
        from paddle_tpu_torch.models import LLAMA2_7B
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from the "
              "root of a checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = gpu_line()
    log(f"device: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    _build.library()
    regs = [ln.strip() for ln in _build.BUILD.log.splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"build: {_build.BUILD.seconds:.1f} s -> {_build.BUILD.path.name}")
    for ln in regs:
        log(f"  ptxas {ln}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err_k1 = max(check_ragged(32, 32, gen, "MHA"),
                 check_ragged(32, 8, gen, "GQA"))
    err_k2 = check_paged(gen)

    cfg = LLAMA2_7B
    eng, launches, positions = engine_phase(cfg)
    profile_phase(eng, cfg)
    del eng

    torch.cuda.empty_cache()
    P = 4096 // 16
    k1 = measure_ragged(gen, cfg.num_heads, 1024, P)
    k2 = measure_paged(gen, cfg.num_heads, 1024, P, positions)
    rows = []
    for name, src, replaces, meas, err in (
            ("ragged_paged_attention",
             "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             "paddle_tpu/ops/pallas/ragged_paged_attention.py:142", k1,
             err_k1),
            ("paged_decode_attention",
             "paddle_tpu_torch/csrc/paged_decode_attention.cu",
             "paddle_tpu/ops/pallas/paged_attention.py:92", k2, err_k2)):
        log(f"timing {name} at {meas['shape']}: kernel {meas['ms']:.4f} ms, "
            f"plain {meas['plain_ms']:.4f} ms, bound {meas['bound_ms']:.4f} "
            f"ms ({meas['bound_by']}), library (SDPA on pre-gathered K/V) "
            f"{meas['library_ms']:.4f} ms, max_abs_err "
            f"{meas['max_abs_err']:.3e}")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": max(err, meas["max_abs_err"]),
                     "ms": meas["ms"], "plain_ms": meas["plain_ms"],
                     "bound_ms": meas["bound_ms"],
                     "bound_by": meas["bound_by"],
                     "library_ms": meas["library_ms"]})
    log(json.dumps({"kernels": rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
