"""Fused-op APIs of the port (≙ `paddle_tpu/incubate/nn`)."""
from . import functional  # noqa: F401
from .layer import (FusedBiasDropoutResidualLayerNorm,  # noqa: F401
                    FusedDropoutAdd, FusedFeedForward, FusedLinear,
                    FusedMultiHeadAttention, FusedRMSNorm,
                    FusedTransformerEncoderLayer)
