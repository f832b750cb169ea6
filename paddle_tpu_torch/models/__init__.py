"""Models of the port (≙ `paddle_tpu/models`): Llama and its serving
engine, MoE, BERT, GPT (`gpt`), ERNIE on one device (`ernie`) and DiT
(`dit`).

The model classes live in their modules (`models.llama`, `models.gpt`,
...); the single-card families added beside Llama are also exported
here."""
from .dit import DiT, DiTConfig, GaussianDiffusion
from .ernie import (ErnieConfig, ErnieForPretraining,
                    ErnieForSequenceClassification, ErnieModel)
from .gpt import GPTConfig, GPTForCausalLM, GPTModel

__all__ = ["DiT", "DiTConfig", "GaussianDiffusion", "ErnieConfig",
           "ErnieForPretraining", "ErnieForSequenceClassification",
           "ErnieModel", "GPTConfig", "GPTForCausalLM", "GPTModel"]
