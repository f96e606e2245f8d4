"""AMP: auto_cast, decorate and GradScaler.

Counterpart of paddle_tpu/amp/__init__.py. `auto_cast` sets the state that
every op of `ops.impl` reads through `state.cast_inputs` (the per-op cast
of the JAX registry's dispatch); `decorate(level="O2")` casts a model's
parameters to the AMP dtype, and Adam / AdamW keep an fp32 master copy of
each (multi_precision, on by default); `GradScaler` is the JAX package's
dynamic loss scaling over a torch optimizer's ``param_groups``.

bf16 is the AMP dtype the port trains in (`jit.TrainStep(amp_level=...,
amp_dtype="bfloat16")`). auto_cast and GradScaler take fp16 too, as the
JAX ones do, but the flash kernels have no fp16 instantiation yet, so a
TrainStep at fp16 raises (ROADMAP.md item 21). `amp.debugging` hooks the
JAX registry, which the port does not have: it waits for item 12.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.amp.state import (
    BLACK_LIST, WHITE_LIST, amp_state, cast_inputs, current_cast_dtype,
)

__all__ = ["BLACK_LIST", "WHITE_LIST", "GradScaler", "amp_guard",
           "amp_state", "auto_cast", "cast_inputs", "current_cast_dtype",
           "decorate", "is_bfloat16_supported", "is_float16_supported"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def to_torch_dtype(dtype) -> torch.dtype:
    """A dtype name ("bfloat16", "float16", "float32") or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"AMP dtype {dtype!r} is not one of "
                         f"{sorted(_DTYPES)}") from None


class auto_cast:
    """Context manager enabling the per-op cast (O1: the white list in the
    AMP dtype, the black list in fp32) or the full cast (O2: everything but
    the black list in the AMP dtype)."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        self.enable = enable
        self.level = level
        self.dtype = to_torch_dtype(dtype)
        self.white = frozenset(custom_white_list or ())
        self.black = frozenset(custom_black_list or ())

    def __enter__(self):
        st = amp_state()
        self._saved = (st.enabled, st.dtype, st.level, st.custom_white,
                       st.custom_black)
        st.enabled = self.enable
        st.dtype = self.dtype
        st.level = self.level
        st.custom_white = self.white
        st.custom_black = self.black
        return self

    def __exit__(self, *exc):
        st = amp_state()
        (st.enabled, st.dtype, st.level, st.custom_white,
         st.custom_black) = self._saved
        return False


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast the models' floating parameters (and buffers) to the AMP
    dtype in place; the optimizer keeps fp32 master weights
    (multi_precision). O1 leaves the models as they are."""
    d = to_torch_dtype(dtype)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            m.to(dtype=d)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


def _parameters(optimizer):
    return [p for group in optimizer.param_groups for p in group["params"]]


class GradScaler:
    """Dynamic loss scaling: the JAX package's schedule of `scale`,
    `unscale_` (an error when called twice before `update`), `step` (skipped
    when a gradient is not finite) and `update` (back off by decr_ratio
    after decr_every_n_nan_or_inf bad steps, never below 1; grow by
    incr_ratio after incr_every_n_steps good ones), over any torch
    optimizer's param_groups. bf16 needs no scaling; it is there for fp16
    and for parity."""

    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        """Divide every gradient by the scale in place and note whether any
        is not finite (one host read for all of them)."""
        if not self._enable:
            return
        if self._unscaled:
            raise RuntimeError(
                "unscale_() has already been called on this optimizer since "
                "the last update()")
        inv = 1.0 / self._scale
        bad = []
        for p in _parameters(optimizer):
            if p.grad is not None:
                p.grad.mul_(inv)
                bad.append((~torch.isfinite(p.grad)).any())
        self._found_inf = bool(torch.stack(bad).any()) if bad else False
        self._unscaled = True

    def step(self, optimizer):
        """Unscale (if not already) and step when the gradients are finite;
        call update() afterwards."""
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def update(self):
        self._unscaled = False
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0
        self._found_inf = False

    def is_enable(self):
        return self._enable

    def get_scale(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def set_state_dict(self, state):
        self._scale = state["scale"]
        self._good_steps = state["good_steps"]
        self._bad_steps = state["bad_steps"]


def is_float16_supported(device=None):
    """True, as in the JAX package: torch computes fp16 on both devices
    (the flash kernels' fp16 instantiation is ROADMAP.md item 21)."""
    return True


def is_bfloat16_supported(device=None):
    """True: the port trains in bf16, through the bf16 flash kernels on
    the card."""
    return True
