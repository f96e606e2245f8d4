from paddle_tpu_torch.utils.flags import define_flag, flag, set_flags

__all__ = ["define_flag", "flag", "set_flags"]
