"""Inference bridge: models into serving engines and serving tiers.

Counterpart of paddle_tpu/inference/__init__.py::create_serving_engine,
create_serving_router and restore_serving_engine.
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Optional

import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.serving.engine import ServingEngine
from paddle_tpu_torch.serving.model_runner import runner_for

_RUNNER_KNOBS = ("block_size", "max_model_len", "attn_impl", "kv_dtype",
                 "weight_dtype", "weight_group_size")

# the serving dtypes by name
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _serving_dtype(dtype):
    """``dtype`` as a torch dtype: fp32, bf16 or fp16 (a torch dtype or its
    name)."""
    dt = _DTYPES.get(dtype, dtype)
    if dt not in _DTYPES.values():
        raise ValueError(f"dtype={dtype!r}; expected one of "
                         f"{sorted(_DTYPES)} (or the torch dtypes)")
    return dt


def create_serving_engine(model, dtype=None, device="cuda", **kw):
    """Build a continuous-batching ServingEngine for a model on ``device``
    (default "cuda", which raises where no card is usable; pass "cpu" to
    run the kernels' plain versions). The model's parameters are moved to
    ``device`` unless they already live there. Runner knobs (block_size,
    max_model_len, attn_impl, kv_dtype, weight_dtype, weight_group_size)
    go to the runner, everything else to ServingEngine (decode_horizon,
    pipelined, horizon_sampling, horizon_early_stop, enable_prefix_cache,
    ragged_batch, num_speculative_tokens and the spec_* knobs among them);
    ``num_blocks`` defaults to 128.

    ``dtype`` (torch.float32, torch.bfloat16 or torch.float16, or their
    names) casts the runner's parameters, and so its compute and its KV
    pools, as the JAX bridge does: after the runner is built, every
    floating parameter is cast, the weight ladder's own included (fp8
    weights come back in ``dtype``, int8 and int4 scales become
    ``dtype``); integer codes stay. The runner's dict is cast, never the
    model. A ``mesh`` (`parallel.mesh.serving_mesh`) serves
    tensor-parallel with the row-parallel collective at ``comm_dtype``:
    cast first, shard second, as in JAX; a ``comm_dtype`` other than
    "fp32" without a mesh is a ValueError, as in JAX."""
    mesh = kw.pop("mesh", None)
    comm_dtype = kw.pop("comm_dtype", "fp32")
    if comm_dtype != "fp32" and mesh is None:
        raise ValueError(
            f"comm_dtype={comm_dtype!r} needs a tensor-parallel mesh: the "
            "quantized collective replaces the row-parallel allreduce, "
            "which only exists at tp > 1")
    dt = _serving_dtype(dtype) if dtype is not None else None
    runner = runner_for(model, device=device,
                        **{k: kw.pop(k) for k in _RUNNER_KNOBS if k in kw})
    if dt is not None:
        runner.params = {k: (v.to(dt) if v.is_floating_point() else v)
                         for k, v in runner.params.items()}
    if mesh is not None:
        runner.shard(mesh, comm_dtype=comm_dtype)
    kw.setdefault("num_blocks", 128)
    return ServingEngine(runner, **kw)


def _fresh_runner(template):
    """A new runner sharing ``template``'s weights (its params dict copied,
    the tensors shared) and rope tables, with none of its graphs, captures
    or counters: what a replica and each of its restarts serve from."""
    runner = copy.copy(template)
    runner.params = dict(template.params)
    runner._mesh_params = [dict(sp) for sp in template._mesh_params]
    runner._graph_cache = OrderedDict()
    runner.captures = []
    runner._impl_logged = set()
    runner.reset_attn_counters()
    return runner


def create_serving_router(model, *, replicas: int = 2, dtype=None,
                          mesh=None, meshes=None, attn_impl: str = "auto",
                          block_size: int = 16,
                          max_model_len: Optional[int] = None,
                          data_axis: str = "data",
                          model_axis: str = "model",
                          kv_dtype: str = "fp32",
                          weight_dtype: str = "fp32",
                          weight_group_size: int = 128, device="cuda",
                          **kw):
    """Build a multi-engine ServingRouter for a model on ``device``
    (default "cuda"; "cpu" runs the kernels' plain versions): N serving
    engines, each a worker thread with its own paged KV pool, prefix
    cache, host tier and graphs, behind one submit / abort / drain
    surface, with prefix-affinity routing, tier admission control and a
    crash-restarting Supervisor (serving.router). Every other keyword
    goes to ServingRouter, and through it to each replica's
    ServingEngine; ``num_blocks`` defaults to 128. Replicas on sub-meshes,
    as in JAX: ``meshes`` gives replica i the mesh ``meshes[i]`` (too few
    is a ValueError); a single ``mesh`` whose ``data_axis`` degree equals
    ``replicas`` (> 1) splits into `replica_submeshes`, and any other
    ``mesh`` shards every replica alike.
    ``shared_kv_pages`` (and ``shared_kv_shm``) put every replica's host
    tier over one host-wide SharedKVStore, as on the JAX bridge; the
    store's layout is the template runner's pool geometry.

    The factory gives each replica, and each restart, a fresh runner over
    ONE set of weights: the model's tensors are moved to ``device`` (if
    they are not there) and cast to ``dtype`` once, into a template
    runner that never serves, and every replica's runner shares its
    tensors (`data_ptr` equal). With meshes the template is sharded once
    for each distinct mesh (its shards views of the same tensors), and a
    replica copies the template of its mesh. A departure by design: the
    JAX factory's ``astype`` casts per replica, which on the card would
    hold one more copy of the weights for every replica and every restart
    (27 GB for LLaMA-2-7B at fp32).

    With ``backend="process"`` the router needs a JSON spec its children
    import a factory from, not a callable over a model object: the call
    raises TypeError (the JAX bridge's type for it) before building
    anything. Build such a tier with ``ServingRouter(spec,
    backend="process", ...)``, e.g. over
    ``serving.replica.model_runner_factory``."""
    if kw.get("backend", "thread") == "process":
        raise TypeError(
            "create_serving_router(backend='process'): the process "
            "backend's runner_factory is a JSON spec {'factory': "
            "'module:callable', 'factory_kw': ...} that each replica "
            "process imports; a factory over a model object cannot cross "
            "a process boundary. Use ServingRouter(spec, "
            "backend='process') with paddle_tpu_torch.serving.replica:"
            "model_runner_factory")
    if meshes is None and mesh is not None:
        data = dict(mesh.shape).get(data_axis, 1)
        if data == replicas and replicas > 1:
            from paddle_tpu_torch.parallel.mesh import replica_submeshes
            meshes = replica_submeshes(mesh, data_axis=data_axis,
                                       model_axis=model_axis)
        else:
            meshes = [mesh] * replicas
    if meshes is not None and len(meshes) < replicas:
        raise ValueError(f"{len(meshes)} meshes for {replicas} replicas")
    from paddle_tpu_torch.serving.router import ServingRouter

    template = runner_for(model, block_size=block_size,
                          max_model_len=max_model_len, attn_impl=attn_impl,
                          kv_dtype=kv_dtype, weight_dtype=weight_dtype,
                          weight_group_size=weight_group_size,
                          device=device)
    if dtype is not None:
        dt = _serving_dtype(dtype)
        template.params = {k: (v.to(dt) if v.is_floating_point() else v)
                           for k, v in template.params.items()}

    sharded = {}        # mesh -> the template sharded over it

    def template_for(m):
        if m is None:
            return template
        if m not in sharded:
            sharded[m] = _fresh_runner(template).shard(
                m, model_axis=model_axis)
        return sharded[m]

    def factory(idx: int):
        m = meshes[idx] if meshes is not None else None
        return _fresh_runner(template_for(m))

    kw.setdefault("num_blocks", 128)
    return ServingRouter(factory, replicas=replicas, **kw)


def restore_serving_engine(model, state, attn_impl: str = "auto",
                           mesh=None, *, device="cuda", **kw):
    """Rebuild a crashed or killed serving engine from
    ``engine.snapshot()``: a fresh runner for ``model`` on ``device``
    (default "cuda"), built with the snapshot's block size, model length,
    kv_dtype, weight_dtype and weight group size (sharded over ``mesh``
    when one is given, which may differ from the snapshot's), then
    `ServingEngine.restore`, which replays every request through
    recompute-on-resume, token for token as an uninterrupted run. Other
    keywords (metrics, tokenizer, sleep_fn, audit) go to `restore`."""
    cfg = state["config"]
    runner = runner_for(model, block_size=cfg["block_size"],
                        max_model_len=cfg["max_model_len"],
                        attn_impl=attn_impl,
                        kv_dtype=cfg.get("kv_dtype", "fp32"),
                        weight_dtype=cfg.get("weight_dtype", "fp32"),
                        weight_group_size=cfg.get("weight_group_size", 128),
                        device=device)
    if mesh is not None:
        runner.shard(mesh)
    return ServingEngine.restore(runner, state, **kw)
