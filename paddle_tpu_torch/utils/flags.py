"""Global runtime flags (the part of paddle_tpu/utils/flags.py the port
reads).

A process-global dict, like the reference's exported flag registry
(paddle.set_flags / paddle.get_flags); a FLAGS_* environment variable of
the same name seeds a flag's default when it is defined.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

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


def set_flags(flags: Mapping[str, Any]) -> None:
    """Like paddle.set_flags; an unknown name raises KeyError."""
    for k, v in flags.items():
        if k not in _FLAGS:
            raise KeyError(f"unknown flag {k!r}")
        _FLAGS[k] = v


def flag(name: str) -> Any:
    return _FLAGS[name]


define_flag("FLAGS_use_flash_attention", True,
            "route attention through the flash kernels")
