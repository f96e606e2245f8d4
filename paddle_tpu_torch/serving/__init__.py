"""Continuous-batching LLM serving over a paged KV cache, in PyTorch.

Counterpart of paddle_tpu/serving for the fp32, single-device, greedy
Llama path: `ServingEngine` (FCFS admission, chunked prefill, batched
decode, youngest-first preemption with recompute-on-resume, deadlines,
retries, NaN guard, invariant auditor) over `KVCachePool` and a
`LlamaRunner` whose attention runs the port's CUDA kernels.
"""

from paddle_tpu_torch.serving.engine import (
    RequestOutput, ServingEngine, TokenEvent, create_engine, greedy_grid,
    naive_generate, sample_token,
)
from paddle_tpu_torch.serving.kv_cache import (
    SCRATCH_PAGE, BlockAllocator, KVCachePool, SequenceKV,
)
from paddle_tpu_torch.serving.metrics import (
    Counter, EngineMetrics, Gauge, Histogram,
)
from paddle_tpu_torch.serving.model_runner import (
    LlamaRunner, PagedModelRunner, bucket_len, paged_attend, runner_for,
)
from paddle_tpu_torch.serving.resilience import (
    InvariantViolation, QueueFullError, audit_engine,
)
from paddle_tpu_torch.serving.scheduler import (
    FCFSScheduler, Request, RequestState, SamplingParams,
)

__all__ = [
    "SCRATCH_PAGE", "BlockAllocator", "Counter", "EngineMetrics",
    "FCFSScheduler", "Gauge", "Histogram", "InvariantViolation",
    "KVCachePool", "LlamaRunner", "PagedModelRunner", "QueueFullError",
    "Request", "RequestOutput", "RequestState", "SamplingParams",
    "SequenceKV", "ServingEngine", "TokenEvent", "audit_engine",
    "bucket_len", "create_engine", "greedy_grid", "naive_generate",
    "paged_attend", "runner_for", "sample_token",
]
