"""Dequant matmul: int8/fp8 weights with one f32 scale per output channel,
dequantized in the matmul epilogue.

≙ `paddle_tpu/ops/quant_matmul.py`: `WEIGHT_QMAX` / `FP8_MAX` (:51-52),
`QuantizedWeight` (:55), `quantize_weight_values` (:90-116),
`_dequant_matmul_xla` (:119-127, here `dequant_matmul_ref`) and
`dequant_matmul_values` (:184-208). A per-output-channel scale is
constant along the contraction, so it multiplies the f32 accumulator
once and the full-width weight is never written to device memory:

    y[m, n] = sum_k x[m, k] * (qw[n, k] * s[n])
            = (sum_k x[m, k] * qw[n, k]) * s[n]

Layout. The JAX package stores ``qw`` as (K, N), ``x @ qw``, with the
scale (N,) per output channel, i.e. per COLUMN. The port stores the
torch way, ``qw`` (N, K) like a `torch.nn.Linear` weight, so the scale
(N,) is per ROW. `models.convert.quantized_weight_from_numpy` carries a
JAX `QuantizedWeight` across.

`dequant_matmul_values` launches the hand-written CUDA kernel
(`csrc/dequant_matmul.cu`, which replaces the TPU's
`_dequant_matmul_kernel`) for CUDA tensors, for int8 AND float8_e4m3fn
storage (the JAX package sends fp8 through XLA because Mosaic lacks f8
tiles; on Hopper widening e4m3 in the kernel is one more template
instance). It takes any shape and masks the edges: the JAX package's
``m % 8 / k % 32 / n % 128`` restriction is a TPU tiling rule. CPU
tensors run `dequant_matmul_ref`. Serving only: no backward.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernel_route, launch_counts

WEIGHT_QMAX = 127.0          # int8 absmax lattice
FP8_MAX = 448.0              # float8_e4m3fn finite max

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_W_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}
# pdt_dequant_matmul(x, w, scale, y, M, K, N, x_dtype, w_dtype, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


class QuantizedWeight:
    """One quantized matmul weight: ``qw`` (N, K) int8 or float8_e4m3fn
    storage and ``scale`` (N,) f32, the DEQUANT multiplier of each
    output channel (row n of ``qw``): ``w ~= qw * scale[:, None]``.

    The engine builds one per quantized Linear and hands them to the
    model per dispatch; `nn.functional.linear` routes it to
    `dequant_matmul_values`, so the model code never forks on
    quantization."""

    def __init__(self, qw: torch.Tensor, scale: torch.Tensor):
        self.qw = qw
        self.scale = scale

    @property
    def shape(self):
        return self.qw.shape

    @property
    def nbytes(self) -> int:
        return self.qw.numel() * self.qw.element_size() \
            + self.scale.numel() * self.scale.element_size()

    def __repr__(self):
        return (f"QuantizedWeight(shape={tuple(self.qw.shape)}, "
                f"dtype={self.qw.dtype})")


def quantize_weight_values(w: torch.Tensor, mode: str = "int8"):
    """Per-output-channel weight quantization: ``w`` (N, K) float ->
    (storage (N, K), dequant scale (N,) f32).

    * ``int8``: the absmax lattice through the shared round-clip core
      (`nn.quant.absmax_round_clip_values`), scale = absmax / 127;
    * ``fp8``: float8_e4m3fn storage scaled so each channel's absmax
      lands on the format's finite max (448).

    The absmax is guarded at 1e-9 before either, as in JAX."""
    from ..nn.quant import absmax_round_clip_values
    if w.ndim != 2:
        raise ValueError(f"quantize_weight_values wants (N, K), got "
                         f"shape {tuple(w.shape)}")
    wf = w.float()
    absmax = torch.clamp(wf.abs().amax(dim=1), min=1e-9)      # (N,)
    if mode == "int8":
        qw = absmax_round_clip_values(wf, absmax[:, None], WEIGHT_QMAX,
                                      out_dtype=torch.int8)
        return qw, (absmax / WEIGHT_QMAX).float()
    if mode == "fp8":
        scale = (absmax / FP8_MAX).float()
        return (wf / scale[:, None]).to(torch.float8_e4m3fn), scale
    raise ValueError(f"quantize mode {mode!r}: int8|fp8")


def dequant_matmul_ref(x: torch.Tensor, qw: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (≙ `_dequant_matmul_xla`): widen the
    storage to f32, one f32 matmul, scale the accumulator per output
    channel, cast to x's dtype."""
    return ((x.float() @ qw.float().T) * scale).to(x.dtype)


def _dequant_cuda(x2: torch.Tensor, qw: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/dequant_matmul.cu` on (M, K) rows."""
    m, k = x2.shape
    if x2.dtype not in _X_DTYPES:
        raise TypeError(f"dequant matmul kernel takes float32, bfloat16 or "
                        f"float16 activations, got {x2.dtype}")
    if qw.dtype not in _W_DTYPES:
        raise TypeError(f"dequant matmul kernel takes int8 or "
                        f"float8_e4m3fn weights, got {qw.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"dequant matmul kernel wants a float32 scale, "
                        f"got {scale.dtype}")
    if qw.ndim != 2 or qw.shape[1] != k or scale.shape != (qw.shape[0],):
        raise ValueError(f"shape mismatch: x {tuple(x2.shape)}, qw "
                         f"{tuple(qw.shape)}, scale {tuple(scale.shape)} "
                         "(want qw (N, K) and scale (N,))")
    tensors = (x2, qw, scale)
    if any(not t.is_cuda or t.device != x2.device for t in tensors):
        raise ValueError("dequant matmul kernel wants x, qw and scale on "
                         "one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("dequant matmul kernel wants contiguous inputs")
    n = qw.shape[0]
    from ._build import kernel_fn
    fn = kernel_fn("dequant_matmul", "pdt_dequant_matmul", _ARGTYPES)
    y = torch.empty(m, n, dtype=x2.dtype, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                 y.data_ptr(), m, k, n, _X_DTYPES[x2.dtype],
                 _W_DTYPES[qw.dtype], stream)
    if err:
        raise RuntimeError(f"dequant matmul kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["dequant_matmul"] += 1
    return y


def dequant_matmul_values(x: torch.Tensor, qw: torch.Tensor,
                          scale: torch.Tensor,
                          use_kernel=None) -> torch.Tensor:
    """``x`` (..., K) float; ``qw`` (N, K) int8 or float8_e4m3fn;
    ``scale`` (N,) f32. Returns ``x @ (qw * scale[:, None]).T``, (..., N)
    in x's dtype, with f32 accumulation and the scale applied once to
    the accumulator.

    ``use_kernel`` None launches the CUDA kernel for a CUDA ``x`` and
    runs `dequant_matmul_ref` for a CPU ``x``; True demands the kernel;
    False runs the plain version on either device."""
    if not kernel_route(x, use_kernel):
        return dequant_matmul_ref(x, qw, scale)
    lead = x.shape[:-1]
    y = _dequant_cuda(x.reshape(-1, x.shape[-1]).contiguous(), qw, scale)
    return y.reshape(*lead, qw.shape[0])
