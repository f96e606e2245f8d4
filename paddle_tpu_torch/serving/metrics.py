"""Serving metrics: counters, gauges, histograms for the engine.

Counterpart of paddle_tpu/serving/metrics.py, holding the instruments the
engine's default step sets, and `aggregate_snapshots`, which merges the
snapshots of a tier's replicas. Everything is plain python on the host: the
engine records around its device calls. The clock is injectable so
scheduler unit tests run on a virtual clock. Times are host-clock times;
a device number (kernel time, idle share) comes from CUDA events or a
profiler, never from here.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional


class Counter:
    """Monotonic event counter."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value; remembers its peak."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self.peak = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)
        if self.value > self.peak:
            self.peak = self.value


class Histogram:
    """Exact-sample histogram (every observation is kept, so percentile()
    is exact, not bucketed)."""

    def __init__(self, name: str):
        self.name = name
        self._samples: List[float] = []

    def observe(self, v: float) -> None:
        self._samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self._samples)

    @property
    def sum(self) -> float:
        return sum(self._samples)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self._samples else 0.0

    @property
    def max(self) -> float:
        return max(self._samples) if self._samples else 0.0

    def percentile(self, p: float) -> float:
        """Exact nearest-rank percentile, p in [0, 100]."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        if p <= 0:
            return s[0]
        if p >= 100:
            return s[-1]
        rank = max(0, min(len(s) - 1, int(round(p / 100.0 * (len(s) - 1)))))
        return s[rank]


# EngineMetrics.snapshot() keys that are cumulative event counts: the keys
# a tier of replicas can SUM (the JAX package's list, its tensor-parallel
# and page-store keys included, so an aggregate has the JAX keys). Gauges
# and peaks take the max, ratios are recomputed from the summed counters,
# and percentiles are dropped: scalar snapshots cannot be merged into a
# percentile, so tier latency lives in the router's own histograms.
SUMMABLE_KEYS = (
    "requests_added", "requests_finished", "preemptions",
    "requests_timed_out", "requests_aborted", "step_retries",
    "nan_logit_events", "shed_requests", "tokens_generated",
    "prefill_tokens", "prefill_chunks", "prefix_hit_tokens", "cow_copies",
    "prefix_cached_pages", "attn_kv_bytes_read", "attn_kv_bytes_gather",
    "tp_comm_bytes", "tp_comm_bytes_fp32",
    "tp_gather_bytes", "tp_gather_bytes_fp32",
    "spec_proposed_tokens", "spec_accepted_tokens", "spec_rollback_pages",
    "spec_fused_horizons", "spec_dead_positions",
    "host_syncs", "decode_horizon_steps", "horizon_overshoot_tokens",
    "planned_ahead_steps", "host_plan_seconds", "overlapped_plan_seconds",
    "drain_wait_seconds", "step_seconds",
    "offload_spill_pages", "pagein_pages", "pagein_hidden_pages",
    "offload_resumes", "offload_recompute_fallbacks", "host_tier_drops",
    "host_tier_bytes",
    "handoffs_out", "handoffs_in", "handoff_pages_out", "handoff_pages_in",
    "handoff_recompute_fallbacks", "handoff_bytes_out",
    "store_hit_pages", "store_dedup_pages",
    "decode_steps", "queue_depth", "running", "pool_used_pages",
)

MAX_KEYS = ("queue_depth_peak", "pool_utilization_peak", "busy_seconds")


def aggregate_snapshots(snaps) -> Dict[str, float]:
    """Merge several EngineMetrics snapshots into one tier-level view:
    counters sum, peaks take the max (replicas run concurrently, so
    busy_seconds is the max too: the tier was busy as long as its
    busiest replica), and derived ratios are recomputed from the summed
    counters. Percentile keys are absent (see SUMMABLE_KEYS)."""
    snaps = list(snaps)
    out: Dict[str, float] = {k: 0.0 for k in SUMMABLE_KEYS}
    for k in MAX_KEYS:
        out[k] = 0.0
    for s in snaps:
        for k in SUMMABLE_KEYS:
            out[k] += float(s.get(k, 0.0))
        for k in MAX_KEYS:
            out[k] = max(out[k], float(s.get(k, 0.0)))
    toks = out["tokens_generated"]
    prop = out["spec_proposed_tokens"]
    out["spec_acceptance_rate"] = (out["spec_accepted_tokens"] / prop
                                   if prop > 0 else 0.0)
    pin = out["pagein_pages"]
    out["pagein_hidden_ratio"] = (out["pagein_hidden_pages"] / pin
                                  if pin > 0 else 0.0)
    out["steps_per_token"] = out["decode_steps"] / toks if toks > 0 else 0.0
    out["host_syncs_per_token"] = out["host_syncs"] / toks if toks > 0 \
        else 0.0
    st = out["step_seconds"]
    out["device_idle_fraction"] = (
        max(0.0, 1.0 - min((out["drain_wait_seconds"]
                            + out["overlapped_plan_seconds"]) / st, 1.0))
        if st > 0 else 0.0)
    out["tokens_per_sec"] = (toks / out["busy_seconds"]
                             if out["busy_seconds"] > 0 else 0.0)
    # the tensor-parallel comm reductions, recomputed from the summed
    # byte counters
    comm = out["tp_comm_bytes"]
    out["tp_comm_bytes_reduction_x"] = (out["tp_comm_bytes_fp32"] / comm
                                        if comm > 0 else 0.0)
    gather = out["tp_gather_bytes"]
    out["tp_gather_bytes_reduction_x"] = (
        out["tp_gather_bytes_fp32"] / gather if gather > 0 else 0.0)
    out["replicas"] = float(len(snaps))
    return out


class EngineMetrics:
    """The engine's instrument panel.

    TTFT is measured from add_request() to the first sampled token of that
    request (admission wait + prefill); decode throughput is generated
    tokens / engine busy time."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock = clock or time.monotonic
        self.requests_added = Counter("requests_added")
        self.requests_finished = Counter("requests_finished")
        self.preemptions = Counter("preemptions")
        self.requests_timed_out = Counter("requests_timed_out")
        self.requests_aborted = Counter("requests_aborted")
        self.step_retries = Counter("step_retries")
        self.nan_logit_events = Counter("nan_logit_events")
        self.shed_requests = Counter("shed_requests")
        self.tokens_generated = Counter("tokens_generated")
        # tokens actually COMPUTED by prefill chunks; prefix-cache hits
        # skip the compute and land in prefix_hit_tokens instead, so
        # computed + hit = the contexts admitted
        self.prefill_tokens = Counter("prefill_tokens")
        self.prefill_chunks = Counter("prefill_chunks")
        self.prefix_hit_tokens = Counter("prefix_hit_tokens")
        self.cow_copies = Counter("cow_copies")
        # speculative decoding: draft tokens proposed into verify spans,
        # the ones the target model accepted, the pages rejected tails
        # returned, the fused speculative horizons (one drain each) and
        # the proposed-but-rejected verify positions
        self.spec_proposed_tokens = Counter("spec_proposed_tokens")
        self.spec_accepted_tokens = Counter("spec_accepted_tokens")
        self.spec_rollback_pages = Counter("spec_rollback_pages")
        self.spec_fused_horizons = Counter("spec_fused_horizons")
        self.spec_dead_positions = Counter("spec_dead_positions")
        # every blocking device->host drain the engine performs
        self.host_syncs = Counter("host_syncs")
        # decode steps run inside device-resident horizons, and the tokens
        # a horizon computed past a request's stop and discarded
        self.decode_horizon_steps = Counter("decode_horizon_steps")
        self.horizon_overshoot_tokens = Counter("horizon_overshoot_tokens")
        # pipelined loop: steps whose planning ran while a launch was in
        # flight
        self.planned_ahead_steps = Counter("planned_ahead_steps")
        # host-clock split of each step: planning (and the part of it run
        # under an in-flight launch), blocking drains, total
        self.host_plan_seconds = Counter("host_plan_seconds")
        self.overlapped_plan_seconds = Counter("overlapped_plan_seconds")
        self.drain_wait_seconds = Counter("drain_wait_seconds")
        self.step_seconds = Counter("step_seconds")
        # 1 - (drain waits + overlapped planning) / step time, set after
        # every step: the loop time in which the device plausibly waited
        self.device_idle_fraction = Gauge("device_idle_fraction")
        # the host KV tier: device pages copied to the host (preemption
        # spills and prefix demotions), pages restored to the device, and
        # of those the ones whose host-to-device copy was issued in an
        # EARLIER step than the fence that consumed it (a step of device
        # work to hide behind); resumed requests by path; spills a full
        # tier refused (those resumes recompute); the host bytes and
        # slots in use after each step
        self.offload_spill_pages = Counter("offload_spill_pages")
        self.pagein_pages = Counter("pagein_pages")
        self.pagein_hidden_pages = Counter("pagein_hidden_pages")
        self.offload_resumes = Counter("offload_resumes")
        self.offload_recompute_fallbacks = Counter(
            "offload_recompute_fallbacks")
        self.host_tier_drops = Counter("host_tier_drops")
        self.host_tier_bytes = Gauge("host_tier_bytes")
        self.host_tier_pages_used = Gauge("host_tier_pages_used")
        # the prefill / decode split: requests a prefill-role engine (or a
        # drain) staged for migration after their first sampled token and
        # the pages spilled for them; requests an engine accepted by
        # import_handoff and the pages it imported (content hashes
        # re-verified at receive); handoffs whose pages could not ride (no
        # host tier, tier full) and resume by recompute; and the payload
        # bytes a handoff exported
        self.handoffs_out = Counter("handoffs_out")
        self.handoffs_in = Counter("handoffs_in")
        self.handoff_pages_out = Counter("handoff_pages_out")
        self.handoff_pages_in = Counter("handoff_pages_in")
        self.handoff_recompute_fallbacks = Counter(
            "handoff_recompute_fallbacks")
        self.handoff_bytes_out = Counter("handoff_bytes_out")
        # the host-wide KV store: pages this engine paged in from the
        # store's content index (a sibling's demotion served it), and
        # copies skipped because the chain was already resident
        self.store_hit_pages = Counter("store_hit_pages")
        self.store_dedup_pages = Counter("store_dedup_pages")
        self.decode_steps = Counter("decode_steps")
        self.queue_depth = Gauge("queue_depth")
        self.running = Gauge("running")
        # KV-pool bytes the chosen attention path touched vs what the
        # gather reference would have read for the same calls, mirrored
        # from the runner's host-side accounting each step
        self.attn_kv_bytes_read = Gauge("attn_kv_bytes_read")
        self.attn_kv_bytes_gather = Gauge("attn_kv_bytes_gather")
        # tensor-parallel wire bytes a shard moved through the row-parallel
        # allreduces and the logits gather at the runner's comm dtype
        # (scale bytes counted) vs fp32 for the same calls, and their
        # ratios: mirrored from the runner's host-side counters each step
        self.tp_comm_bytes = Gauge("tp_comm_bytes")
        self.tp_comm_bytes_fp32 = Gauge("tp_comm_bytes_fp32")
        self.tp_comm_bytes_reduction_x = Gauge("tp_comm_bytes_reduction_x")
        self.tp_gather_bytes = Gauge("tp_gather_bytes")
        self.tp_gather_bytes_fp32 = Gauge("tp_gather_bytes_fp32")
        self.tp_gather_bytes_reduction_x = Gauge(
            "tp_gather_bytes_reduction_x")
        # per-page byte reduction of the pool against storing it at the
        # logical dtype (scale bytes counted; 1.0 on fp32 pools), and the
        # matching sessions-per-fixed-memory factor, set from the pool's
        # geometry when the engine is built
        self.kv_bytes_reduction_x = Gauge("kv_bytes_reduction_x")
        self.sessions_per_pool_x = Gauge("sessions_per_pool_x")
        # the weight ladder: the runner's logical fp32 weight bytes over
        # what its params dict stores (codes and scales counted; 1.0 on
        # an fp32 runner, 2.0 on a bf16- or fp16-cast one), set when the
        # engine is built
        self.weight_bytes_reduction_x = Gauge("weight_bytes_reduction_x")
        self.pool_used_pages = Gauge("pool_used_pages")
        # pages the prefix cache's index holds after each step
        self.prefix_cached_pages = Gauge("prefix_cached_pages")
        self.pool_utilization = Gauge("pool_utilization")
        self.batch_occupancy = Histogram("batch_occupancy")
        self.ttft_s = Histogram("ttft_s")
        self.e2e_latency_s = Histogram("e2e_latency_s")
        self._start_t: Optional[float] = None
        self._last_t: Optional[float] = None

    def mark_active(self) -> None:
        """Called once per engine step; bounds the busy window."""
        t = self.clock()
        if self._start_t is None:
            self._start_t = t
        self._last_t = t

    @property
    def busy_seconds(self) -> float:
        if self._start_t is None or self._last_t is None:
            return 0.0
        return self._last_t - self._start_t

    def tokens_per_sec(self) -> float:
        dt = self.busy_seconds
        return self.tokens_generated.value / dt if dt > 0 else 0.0

    def spec_acceptance_rate(self) -> float:
        """Accepted / proposed draft tokens (0.0 when nothing proposed)."""
        p = self.spec_proposed_tokens.value
        return self.spec_accepted_tokens.value / p if p > 0 else 0.0

    def pagein_hidden_ratio(self) -> float:
        """Share of paged-in pages whose host-to-device copy was issued at
        least one engine step before the fence that read them (0.0 when
        nothing paged in)."""
        p = self.pagein_pages.value
        return self.pagein_hidden_pages.value / p if p > 0 else 0.0

    def host_syncs_per_token(self) -> float:
        t = self.tokens_generated.value
        return self.host_syncs.value / t if t > 0 else 0.0

    def steps_per_token(self) -> float:
        """Engine steps per generated token: each accepted draft token is
        a token that paid no engine step of its own."""
        t = self.tokens_generated.value
        return self.decode_steps.value / t if t > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
        # every counter and gauge but pool_utilization, which the JAX
        # snapshot gives only as its peak
        snap = {name: inst.value for name, inst in vars(self).items()
                if isinstance(inst, (Counter, Gauge))
                and name != "pool_utilization"}
        snap.update({
            "queue_depth_peak": self.queue_depth.peak,
            "pool_utilization_peak": self.pool_utilization.peak,
            "batch_occupancy_mean": self.batch_occupancy.mean,
            "ttft_s_p50": self.ttft_s.percentile(50),
            "ttft_s_p99": self.ttft_s.percentile(99),
            "ttft_s_mean": self.ttft_s.mean,
            "e2e_latency_s_p50": self.e2e_latency_s.percentile(50),
            "e2e_latency_s_p99": self.e2e_latency_s.percentile(99),
            "spec_acceptance_rate": self.spec_acceptance_rate(),
            "pagein_hidden_ratio": self.pagein_hidden_ratio(),
            "steps_per_token": self.steps_per_token(),
            "host_syncs_per_token": self.host_syncs_per_token(),
            "tokens_per_sec": self.tokens_per_sec(),
            "busy_seconds": self.busy_seconds,
        })
        return snap
