from paddle_tpu_torch.models.llama import (
    LLAMA2_7B, Llama, LlamaConfig, rope_tables,
)

__all__ = ["LLAMA2_7B", "Llama", "LlamaConfig", "rope_tables"]
