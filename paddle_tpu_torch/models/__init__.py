from paddle_tpu_torch.models.ernie import (
    ERNIE3_BASE, ErnieConfig, ErnieForPretraining,
    ErnieForSequenceClassification, ErnieForTokenClassification, ErnieModel,
    ernie_pretrain_loss_fn, mask_tokens,
)
from paddle_tpu_torch.models.llama import (
    LLAMA2_7B, Llama, LlamaConfig, llama_loss_fn, rope_tables,
)

__all__ = ["ERNIE3_BASE", "ErnieConfig", "ErnieForPretraining",
           "ErnieForSequenceClassification", "ErnieForTokenClassification",
           "ErnieModel", "LLAMA2_7B", "Llama", "LlamaConfig",
           "ernie_pretrain_loss_fn", "llama_loss_fn", "mask_tokens",
           "rope_tables"]
