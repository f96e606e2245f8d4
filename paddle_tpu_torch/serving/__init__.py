"""Continuous-batching LLM serving over a paged KV cache, in PyTorch.

Counterpart of paddle_tpu/serving for the single-device Llama and GPT
paths over fp32, int8 and fp8 KV pools: `ServingEngine` (FCFS admission,
chunked prefill, batched decode or device-resident decode horizons, the
pipelined loop, greedy or seeded sampling, youngest-first preemption
with recompute-on-resume, deadlines, retries, NaN guard, invariant
auditor) over `KVCachePool` and a `LlamaRunner` or `GPTRunner` whose
attention runs the port's CUDA kernels, its decode kinds as CUDA graphs
on the card.
"""

from paddle_tpu_torch.serving.engine import (
    RequestOutput, ServingEngine, TokenEvent, create_engine, greedy_grid,
    naive_generate, sample_token, seeded_sample,
)
from paddle_tpu_torch.serving.kv_cache import (
    SCRATCH_PAGE, BlockAllocator, KVCachePool, SequenceKV,
)
from paddle_tpu_torch.serving.metrics import (
    Counter, EngineMetrics, Gauge, Histogram,
)
from paddle_tpu_torch.serving.model_runner import (
    GPTRunner, LlamaRunner, PagedModelRunner, bucket_len, paged_attend,
    runner_for,
)
from paddle_tpu_torch.serving.resilience import (
    InvariantViolation, QueueFullError, audit_engine,
)
from paddle_tpu_torch.serving.scheduler import (
    FCFSScheduler, Request, RequestState, SamplingParams,
)

__all__ = [
    "SCRATCH_PAGE", "BlockAllocator", "Counter", "EngineMetrics",
    "FCFSScheduler", "GPTRunner", "Gauge", "Histogram",
    "InvariantViolation",
    "KVCachePool", "LlamaRunner", "PagedModelRunner", "QueueFullError",
    "Request", "RequestOutput", "RequestState", "SamplingParams",
    "SequenceKV", "ServingEngine", "TokenEvent", "audit_engine",
    "bucket_len", "create_engine", "greedy_grid", "naive_generate",
    "paged_attend", "runner_for", "sample_token", "seeded_sample",
]
