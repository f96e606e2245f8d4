"""Serving metrics: counters, gauges, histograms for the engine.

Counterpart of paddle_tpu/serving/metrics.py, holding the instruments the
engine's default step sets. Everything is plain python on the host: the
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
        # tokens actually COMPUTED by prefill chunks
        self.prefill_tokens = Counter("prefill_tokens")
        self.prefill_chunks = Counter("prefill_chunks")
        # every blocking device->host drain the engine performs
        self.host_syncs = Counter("host_syncs")
        # host-clock split of each step: planning, blocking drains, total
        self.host_plan_seconds = Counter("host_plan_seconds")
        self.drain_wait_seconds = Counter("drain_wait_seconds")
        self.step_seconds = Counter("step_seconds")
        self.decode_steps = Counter("decode_steps")
        self.queue_depth = Gauge("queue_depth")
        self.running = Gauge("running")
        # KV-pool bytes the chosen attention path touched vs what the
        # gather reference would have read for the same calls, mirrored
        # from the runner's host-side accounting each step
        self.attn_kv_bytes_read = Gauge("attn_kv_bytes_read")
        self.attn_kv_bytes_gather = Gauge("attn_kv_bytes_gather")
        self.pool_used_pages = Gauge("pool_used_pages")
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

    def host_syncs_per_token(self) -> float:
        t = self.tokens_generated.value
        return self.host_syncs.value / t if t > 0 else 0.0

    def snapshot(self) -> Dict[str, float]:
        snap = {name: inst.value for name, inst in vars(self).items()
                if isinstance(inst, (Counter, Gauge))}
        snap.update({
            "queue_depth_peak": self.queue_depth.peak,
            "pool_utilization_peak": self.pool_utilization.peak,
            "batch_occupancy_mean": self.batch_occupancy.mean,
            "ttft_s_p50": self.ttft_s.percentile(50),
            "ttft_s_p99": self.ttft_s.percentile(99),
            "ttft_s_mean": self.ttft_s.mean,
            "e2e_latency_s_p50": self.e2e_latency_s.percentile(50),
            "e2e_latency_s_p99": self.e2e_latency_s.percentile(99),
            "host_syncs_per_token": self.host_syncs_per_token(),
            "tokens_per_sec": self.tokens_per_sec(),
            "busy_seconds": self.busy_seconds,
        })
        return snap
