from paddle_tpu_torch.utils.flags import (
    define_flag, flag, flags_version, get_flags, set_flags,
)

__all__ = ["define_flag", "flag", "flags_version", "get_flags", "set_flags"]
