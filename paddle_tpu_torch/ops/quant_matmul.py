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
``m % 8 / k % 32 / n % 128`` restriction is a TPU tiling rule. The
source holds four designs, which `dequant_design` picks by shape: the
decode kernel (16-bit x, M <= 8), wgmma with TMA (16-bit x, M > 8, K a
multiple of 16), mma.sync (the other 16-bit shapes) and CUDA cores (f32
x). CPU tensors run `dequant_matmul_ref`. Serving only: no backward.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernel_route, launch_counts

WEIGHT_QMAX = 127.0          # int8 absmax lattice
FP8_MAX = 448.0              # float8_e4m3fn finite max

_X_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_W_DTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}
# pdt_dequant_matmul(x, w, scale, y, M, K, N, x_dtype, w_dtype, design,
#                    stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# the C entry's design codes
_DESIGNS = {"decode": 0, "wgmma": 1, "mma.sync": 2, "cuda_cores": 3}
# the decode kernel's rows: a decode step's 8 slots
DECODE_ROWS = 8


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


def dequant_design(dtype, m: int, k: int, n: int) -> str:
    """Which design of `csrc/dequant_matmul.cu` takes x of ``dtype`` with
    ``m`` rows, contraction ``k`` and ``n`` output channels on the card:

    * ``"decode"``: bf16 / f16 with m <= 8 and k a multiple of 64 (tensor
      cores, the block's warps splitting K);
    * ``"wgmma"``: bf16 / f16 with m > 8 and k a multiple of 16 (TMA's
      16-byte row strides of the int8 / e4m3 weight);
    * ``"mma.sync"``: the other bf16 / f16 shapes with m > 8;
    * ``"cuda_cores"``: f32 (no TF32, as the reference), and 16-bit x with
      m <= 8 off the decode kernel's k.

    ``n`` takes any value in every design (the edges are masked)."""
    if dtype not in (torch.bfloat16, torch.float16):
        return "cuda_cores"
    if m <= DECODE_ROWS:
        return "decode" if k % 64 == 0 else "cuda_cores"
    return "wgmma" if k % 16 == 0 else "mma.sync"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    # the TMA-fed and decode designs read from 16-byte aligned bases (a
    # copy only when a view is not)
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _dequant_cuda(x2: torch.Tensor, qw: torch.Tensor,
                  scale: torch.Tensor, _design=None) -> torch.Tensor:
    """Launch `csrc/dequant_matmul.cu` on (M, K) rows in the design of
    `dequant_design`, unless ``_design`` names one (private: it lets a
    caller time another design at the same shape). An input the named
    design cannot take raises before any launch."""
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
    design = _design or dequant_design(x2.dtype, m, k, n)
    sixteen = x2.dtype in (torch.bfloat16, torch.float16)
    takes = {"decode": sixteen and m <= DECODE_ROWS and k % 64 == 0,
             "wgmma": sixteen and k % 16 == 0,
             "mma.sync": sixteen, "cuda_cores": True}
    if design not in takes:
        raise ValueError(f"no dequant matmul design {design!r}")
    if not takes[design]:
        raise ValueError(f"the {design} dequant matmul does not take "
                         f"{x2.dtype} x with M {m}, K {k}")
    if design in ("decode", "wgmma"):
        x2, qw = _aligned(x2), _aligned(qw)
    from ._build import kernel_fn
    fn = kernel_fn("dequant_matmul", "pdt_dequant_matmul", _ARGTYPES)
    y = torch.empty(m, n, dtype=x2.dtype, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                 y.data_ptr(), m, k, n, _X_DTYPES[x2.dtype],
                 _W_DTYPES[qw.dtype], _DESIGNS[design], stream)
    if err:
        raise RuntimeError(f"dequant matmul kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["dequant_matmul"] += 1
    return y


def dequant_matmul_values(x: torch.Tensor, qw: torch.Tensor,
                          scale: torch.Tensor, use_kernel=None,
                          _design=None) -> torch.Tensor:
    """``x`` (..., K) float; ``qw`` (N, K) int8 or float8_e4m3fn;
    ``scale`` (N,) f32. Returns ``x @ (qw * scale[:, None]).T``, (..., N)
    in x's dtype, with f32 accumulation and the scale applied once to
    the accumulator.

    ``use_kernel`` None launches the CUDA kernel for a CUDA ``x`` and
    runs `dequant_matmul_ref` for a CPU ``x``; True demands the kernel;
    False runs the plain version on either device. ``_design`` as in
    `_dequant_cuda`."""
    if not kernel_route(x, use_kernel):
        return dequant_matmul_ref(x, qw, scale)
    lead = x.shape[:-1]
    y = _dequant_cuda(x.reshape(-1, x.shape[-1]).contiguous(), qw, scale,
                      _design)
    return y.reshape(*lead, qw.shape[0])
