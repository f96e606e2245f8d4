"""Continuous-batching LLM serving over a paged KV cache, in PyTorch.

Counterpart of paddle_tpu/serving for the Llama and GPT paths, on one
device or tensor-parallel over a mesh, over fp32, int8 and fp8 KV pools:
`ServingEngine` (FCFS admission, chunked prefill, batched decode or
device-resident decode horizons, the pipelined loop, greedy or seeded
sampling, youngest-first preemption with recompute-on-resume, deadlines,
retries, NaN guard, invariant auditor, the shared-prefix page cache with
copy-on-write, fused ragged steps, speculative decoding) over
`KVCachePool` and a `LlamaRunner` or `GPTRunner` whose attention runs
the port's CUDA kernels, its decode kinds as CUDA graphs on the card.
The draft proposers (`NgramProposer`, `DraftModelProposer`, `AdaptiveK`,
`shadow_runner`) and `quantized_page_write` are exported here too, as in
the JAX package, and so are the host KV tier (`HostKVTier`,
`OffloadRecord`), the stream detokenizer (`StreamDetokenizer`,
`TokenizerAdapter`, `complete_utf8_prefix`) and the serving tier:
`ServingRouter` over thread or process replicas (`EngineReplica`,
`RouterOutput`, `RouterMetrics`), its `Supervisor`, the write-ahead
`RouterJournal`, `ReplicaCrashError`, `aggregate_snapshots` and
`audit_router`; for the process backend the `ReplicaLauncher` and its
`EngineClient` proxy, `ReplicaGoneError`, the wire's
`WireCorruptionError` / `WireTimeoutError` and the `WireFaultInjector`;
and the host-wide KV store under the tiers (`SharedKVStore`, served to
replica processes by `StoreServer` and reached through
`SharedKVStoreClient`) with its auditor `audit_store`. Tensor-parallel
serving's mesh and placements are exported as in the JAX package:
`serving_mesh`, `replica_submeshes` and `SpecLayout`
(`paddle_tpu_torch.parallel`).
"""

from paddle_tpu_torch.parallel.compat import SpecLayout
from paddle_tpu_torch.parallel.mesh import replica_submeshes, serving_mesh
from paddle_tpu_torch.serving.detokenize import (
    StreamDetokenizer, TokenizerAdapter, complete_utf8_prefix,
)
from paddle_tpu_torch.serving.engine import (
    RequestOutput, ServingEngine, TokenEvent, create_engine, greedy_grid,
    naive_generate, sample_token, seeded_sample,
)
from paddle_tpu_torch.serving.kv_cache import (
    SCRATCH_PAGE, BlockAllocator, HostKVTier, KVCachePool, OffloadRecord,
    PrefixCache, SequenceKV, SharedKVStore, page_content_hash,
    quantized_page_write,
)
from paddle_tpu_torch.serving.journal import RouterJournal
from paddle_tpu_torch.serving.launch import EngineClient, ReplicaLauncher
from paddle_tpu_torch.serving.metrics import (
    Counter, EngineMetrics, Gauge, Histogram, aggregate_snapshots,
)
from paddle_tpu_torch.serving.model_runner import (
    GPTRunner, LlamaRunner, PagedModelRunner, bucket_len, paged_attend,
    runner_for,
)
from paddle_tpu_torch.serving.resilience import (
    FaultInjector, InjectedDeviceError, InvariantViolation, QueueFullError,
    ReplicaCrashError, ReplicaGoneError, WireFaultInjector, audit_engine,
    audit_router, audit_store,
)
from paddle_tpu_torch.serving.router import (
    EngineReplica, RouterMetrics, RouterOutput, ServingRouter,
)
from paddle_tpu_torch.serving.scheduler import (
    FCFSScheduler, Request, RequestState, SamplingParams,
)
from paddle_tpu_torch.serving.speculate import (
    AdaptiveK, DraftModelProposer, NgramProposer, shadow_runner,
)
from paddle_tpu_torch.serving.store_service import (
    SharedKVStoreClient, StoreServer,
)
from paddle_tpu_torch.serving.supervisor import Supervisor
from paddle_tpu_torch.serving.wire import (
    WireCorruptionError, WireTimeoutError,
)

__all__ = [
    "SCRATCH_PAGE", "AdaptiveK", "BlockAllocator", "Counter",
    "DraftModelProposer", "EngineClient", "EngineMetrics", "EngineReplica",
    "FCFSScheduler",
    "FaultInjector", "GPTRunner", "Gauge", "Histogram", "HostKVTier",
    "InjectedDeviceError", "InvariantViolation", "KVCachePool",
    "LlamaRunner", "NgramProposer", "OffloadRecord", "PagedModelRunner",
    "PrefixCache", "QueueFullError", "ReplicaCrashError", "ReplicaGoneError",
    "ReplicaLauncher", "Request",
    "RequestOutput", "RequestState", "RouterJournal", "RouterMetrics",
    "RouterOutput", "SamplingParams", "SequenceKV", "ServingEngine",
    "ServingRouter", "SharedKVStore", "SharedKVStoreClient", "SpecLayout",
    "StoreServer", "StreamDetokenizer", "Supervisor", "TokenEvent",
    "TokenizerAdapter", "WireCorruptionError", "WireFaultInjector",
    "WireTimeoutError", "aggregate_snapshots", "audit_engine",
    "audit_router", "audit_store", "bucket_len",
    "complete_utf8_prefix", "create_engine", "greedy_grid",
    "naive_generate", "page_content_hash",
    "paged_attend", "quantized_page_write", "replica_submeshes",
    "runner_for", "sample_token", "seeded_sample", "serving_mesh",
    "shadow_runner",
]
