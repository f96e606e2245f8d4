from paddle_tpu_torch.models.ernie import (
    ERNIE3_BASE, ErnieConfig, ErnieForPretraining,
    ErnieForSequenceClassification, ErnieForTokenClassification, ErnieModel,
    ernie_pretrain_loss_fn, mask_tokens,
)
from paddle_tpu_torch.models.gpt import (
    GPT, GPT3_1_3B, GPTConfig, build_pipeline_train_step, gpt_loss_fn,
)
from paddle_tpu_torch.models.llama import (
    LLAMA2_7B, Llama, LlamaConfig, llama_loss_fn, rope_tables,
)

__all__ = ["ERNIE3_BASE", "ErnieConfig", "ErnieForPretraining",
           "ErnieForSequenceClassification", "ErnieForTokenClassification",
           "ErnieModel", "GPT", "GPT3_1_3B", "GPTConfig", "LLAMA2_7B",
           "Llama", "LlamaConfig", "build_pipeline_train_step",
           "ernie_pretrain_loss_fn", "gpt_loss_fn", "llama_loss_fn",
           "mask_tokens", "rope_tables"]
