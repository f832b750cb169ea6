"""The absmax round-clip quantization core.

≙ `paddle_tpu/nn/quant.py` :39-58 (`absmax_round_clip_values`). Every
quantizer of the port — the engine's weight quantization
(`ops.quant_matmul.quantize_weight_values`) and its KV-page
quantization (`ops.ragged_paged_attention.ragged_scatter_quantized`) —
routes through this one function, so the rounding, the tiny-scale guard
and the asymmetric clip cannot drift between paths. Its int8 bytes equal
the JAX package's bit for bit: the quantized engine's bit-identity
contracts (preemption re-prefill, path invariance of page bytes) rest
on them.
"""
from __future__ import annotations

import torch


def absmax_round_clip_values(v: torch.Tensor, absmax, qmax: float,
                             out_dtype=None) -> torch.Tensor:
    """``clip(round(v / max(absmax, 1e-9) * qmax), -qmax-1, qmax)``.

    The division comes before the multiply and the 1e-9 guard sits on
    the divisor only, as in JAX. `torch.round` rounds half to even, as
    `jnp.round` does. The clip is asymmetric: ``-qmax-1`` keeps int8's
    -128 reachable (a value past -absmax saturates there, never wraps).
    ``absmax`` broadcasts against ``v``. ``out_dtype=None`` returns the
    float lattice values."""
    s = torch.clamp(torch.as_tensor(absmax, dtype=v.dtype,
                                    device=v.device), min=1e-9)
    q = torch.clamp(torch.round(v / s * qmax), -qmax - 1, qmax)
    return q if out_dtype is None else q.to(out_dtype)
