"""Batched multi-LoRA matmul epilogue: per-token low-rank adapter deltas
over one shared base matmul.

≙ `paddle_tpu/ops/lora_epilogue.py`: `LoraWeight` (:58-97, here a plain
class, not a pytree), `_lora_epilogue_xla` (:100-108, here
`lora_epilogue_ref`), `lora_epilogue_values` (:148-170) and
`lora_matmul_values` (:173-188). Requests under different fine-tunes of
one base share a dispatch: the base matmul is shared, and each token
adds its own adapter's delta, picked by a per-token adapter row:

    y[t] = x[t] @ W  +  (x[t] @ A[ids[t]]) @ B[ids[t]] * s[ids[t]]

Row 0 of every stack is zeros with scale 0, the no-adapter row, so a
base-model token's delta is an exact zero. No sum runs across tokens,
so a token's result does not depend on its neighbours in the batch, and
a mixed batch gives each request the stream a dedicated engine would.

Layout. The stacks keep the JAX package's layout over a (K, N) product:
``a`` (R, K, r), ``b`` (R, r, N), ``scale`` (R,) f32, so one set of
deltas drives both packages although the port stores the base weight
(N, K).

`lora_epilogue_values` launches the hand-written CUDA kernel
(`csrc/lora_epilogue.cu`, which replaces the TPU's
`_lora_epilogue_kernel`) for CUDA tensors, at every shape (the JAX
package sends shapes off the TPU's (8, 128) grid to XLA), and runs
`lora_epilogue_ref` for CPU tensors. Serving only: no backward.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernel_route, launch_counts
from .quant_matmul import QuantizedWeight, dequant_matmul_values

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pdt_lora_epilogue(x, a, b, scale, ids, h, y, T, K, N, R, r, kchunk,
#   dtype, accumulate, stream)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# rows of A one shrink block sums: K splits into ceil(K / _K_CHUNK)
# blocks per token, whose partial sums the expand adds in order
_K_CHUNK = 512


class LoraWeight:
    """One multi-LoRA matmul weight for one dispatch: ``base``, the
    (N, K) weight tensor or a `QuantizedWeight`; the stacked adapters
    ``a`` (R, K, r) and ``b`` (R, r, N) in the model's dtype with
    ``scale`` (R,) f32 (row 0 all zeros: no adapter); and ``ids``, the
    dispatch's adapter row per token (T,) int32. The engine builds one
    per adapted matmul for each dispatch and hands it to the model like
    a `QuantizedWeight`; `nn.functional.linear` routes it to
    `lora_matmul_values`."""

    def __init__(self, base, a, b, scale, ids):
        self.base = base
        self.a = a
        self.b = b
        self.scale = scale
        self.ids = ids

    def take(self, rows: torch.Tensor) -> "LoraWeight":
        """The same weight for the packed rows ``rows`` only (the rows
        the engine samples, when this weight is the vocab head)."""
        return LoraWeight(self.base, self.a, self.b, self.scale,
                          self.ids[rows.long()])

    def __repr__(self):
        return (f"LoraWeight(shape={tuple(self.base.shape)}, "
                f"adapters={self.a.shape[0] - 1}, rank={self.a.shape[2]})")


def lora_epilogue_ref(x2: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      scale: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (≙ `_lora_epilogue_xla`): gather each
    token's adapter rows, ``h = x @ A`` and ``d = h @ B`` with the token
    axis kept elementwise, reduced in f32, times the row's scale, cast
    to x's dtype. ``x2`` is (T, K). The rank columns are taken one at a
    time, in order, each as the same contiguous product whatever the
    rank, so zero columns padded onto a stack leave every bit of the
    result as it was (the fleet store pads ranks to one ``max_rank``)."""
    ids = ids.long()
    xf = x2.float()
    av = a[ids].float()                                   # (T, K, r)
    bv = b[ids].float()                                   # (T, r, N)
    d = None
    for j in range(a.shape[2]):
        h = (xf * av[:, :, j].contiguous()).sum(1, keepdim=True)
        term = h * bv[:, j]
        d = term if d is None else d + term
    return (d * scale[ids][:, None]).to(x2.dtype)


def _lora_cuda(x2, a, b, scale, ids, y=None):
    """Launch `csrc/lora_epilogue.cu` on (T, K) rows: the delta into a
    new (T, N) tensor, or added into ``y`` (T, N) in place."""
    t, k = x2.shape
    if x2.dtype not in _DTYPES:
        raise TypeError(f"lora epilogue kernel takes float32, bfloat16 or "
                        f"float16, got {x2.dtype}")
    if a.dtype != x2.dtype or b.dtype != x2.dtype:
        raise TypeError(f"lora epilogue kernel wants the stacks in x's "
                        f"dtype {x2.dtype}, got {a.dtype} / {b.dtype}")
    if scale.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError("lora epilogue kernel wants a float32 scale and "
                        "int32 ids")
    if a.ndim != 3 or b.ndim != 3 or a.shape[1] != k \
            or b.shape[:2] != (a.shape[0], a.shape[2]) \
            or scale.shape != (a.shape[0],) or ids.shape != (t,):
        raise ValueError(f"shape mismatch: x {tuple(x2.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, scale "
                         f"{tuple(scale.shape)}, ids {tuple(ids.shape)} "
                         "(want a (R, K, r), b (R, r, N), scale (R,), "
                         "ids (T,))")
    r_stack, _, r = a.shape
    n = b.shape[2]
    if y is not None and (y.shape != (t, n) or y.dtype != x2.dtype):
        raise ValueError(f"y must be ({t}, {n}) in {x2.dtype}")
    tensors = (x2, a, b, scale, ids) + (() if y is None else (y,))
    if any(not z.is_cuda or z.device != x2.device for z in tensors):
        raise ValueError("lora epilogue kernel wants every input on one "
                         "CUDA device")
    if any(not z.is_contiguous() for z in tensors):
        raise ValueError("lora epilogue kernel wants contiguous inputs")
    from ._build import kernel_fn
    fn = kernel_fn("lora_epilogue", "pdt_lora_epilogue", _ARGTYPES)
    out = torch.empty(t, n, dtype=x2.dtype, device=x2.device) \
        if y is None else y
    h = torch.empty(t, -(-k // _K_CHUNK), r, dtype=torch.float32,
                    device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), a.data_ptr(), b.data_ptr(), scale.data_ptr(),
                 ids.data_ptr(), h.data_ptr(), out.data_ptr(), t, k, n,
                 r_stack, r, _K_CHUNK, _DTYPES[x2.dtype], int(y is not None),
                 stream)
    if err:
        raise RuntimeError(f"lora epilogue kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["lora_epilogue"] += 1
    return out


def lora_epilogue_values(x, a, b, scale, ids, use_kernel=None, y=None):
    """The per-token adapter delta: ``x`` (..., K) with T tokens in all;
    stacked ``a`` (R, K, r) / ``b`` (R, r, N) in x's dtype, ``scale``
    (R,) f32; ``ids`` (T,) int32, the adapter row of each token (0:
    none). Returns the (..., N) delta in x's dtype, or, given ``y``
    (the base output (..., N) in x's dtype), ``y + delta`` with the
    delta rounded to x's dtype first (the kernel adds in place).

    ``use_kernel`` None launches the CUDA kernel for a CUDA ``x`` and
    runs `lora_epilogue_ref` for a CPU ``x``; True demands the kernel;
    False runs the plain version on either device. An id outside
    [0, R) is an error of the caller: the kernel treats it as row 0."""
    lead = x.shape[:-1]
    n = b.shape[2]
    x2 = x.reshape(-1, x.shape[-1])
    if not kernel_route(x, use_kernel):
        d = lora_epilogue_ref(x2, a, b, scale, ids).reshape(*lead, n)
        return d if y is None else y + d.to(y.dtype)
    out = _lora_cuda(x2.contiguous(), a, b, scale, ids,
                     None if y is None else y.reshape(-1, n))
    return out.reshape(*lead, n)


def lora_matmul_values(x, w: LoraWeight, use_kernel=None):
    """``x @ base.T`` plus the per-token delta for one `LoraWeight`. The
    base matmul is exactly the unadapted path's: `F.linear` for a
    tensor, the dequant matmul for a `QuantizedWeight`; the delta is
    rounded to its dtype before the add, so a row-0 token's result is
    the plain engine's plus an exact zero."""
    base = w.base
    if isinstance(base, QuantizedWeight):
        y = dequant_matmul_values(x, base.qw, base.scale, use_kernel)
    else:
        y = torch.nn.functional.linear(x, base)
    return lora_epilogue_values(x, w.a, w.b, w.scale, w.ids, use_kernel,
                                y=y)
