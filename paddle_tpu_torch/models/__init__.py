from paddle_tpu_torch.models.llama import (
    LLAMA2_7B, Llama, LlamaConfig, llama_loss_fn, rope_tables,
)

__all__ = ["LLAMA2_7B", "Llama", "LlamaConfig", "llama_loss_fn",
           "rope_tables"]
