"""Global runtime flags (the part of paddle_tpu/utils/flags.py the port
reads).

A process-global dict, like the reference's exported flag registry
(paddle.set_flags / paddle.get_flags); a FLAGS_* environment variable of
the same name seeds a flag's default when it is defined. `flags_version`
counts the `set_flags` calls, as the JAX module's does.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Mapping, Union

_FLAGS: Dict[str, Any] = {}


def define_flag(name: str, default: Any, help_str: str = "") -> None:
    """Register a flag with a default; an env var of the same name
    overrides it, parsed by the default's type."""
    env = os.environ.get(name)
    if env is None:
        _FLAGS[name] = default
    elif isinstance(default, bool):
        _FLAGS[name] = env.lower() in ("1", "true", "yes", "on")
    elif isinstance(default, (int, float)):
        _FLAGS[name] = type(default)(env)
    else:
        _FLAGS[name] = env


_VERSION = [0]


def flags_version() -> int:
    """How many `set_flags` calls there have been."""
    return _VERSION[0]


def set_flags(flags: Mapping[str, Any]) -> None:
    """Like paddle.set_flags; an unknown name raises KeyError. Bumps
    `flags_version`."""
    for k, v in flags.items():
        if k not in _FLAGS:
            raise KeyError(f"unknown flag {k!r}")
        _FLAGS[k] = v
    _VERSION[0] += 1


def get_flags(flags: Union[Iterable[str], str]) -> Dict[str, Any]:
    """Like paddle.get_flags: a flag name or an iterable of names -> {name:
    value}; an unknown name raises KeyError."""
    if isinstance(flags, str):
        flags = [flags]
    return {k: _FLAGS[k] for k in flags}


def flag(name: str) -> Any:
    return _FLAGS[name]


define_flag("FLAGS_check_nan_inf", False, "scan op outputs for NaN/Inf")
define_flag("FLAGS_eager_op_jit", True,
            "no effect in the port: there is no per-op compile")
define_flag("FLAGS_default_dtype", "float32", "default floating dtype")
define_flag("FLAGS_use_flash_attention", True,
            "route attention through the flash kernels")
