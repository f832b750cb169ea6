"""RMSNorm and LayerNorm, forward and backward: hand-written CUDA kernels
beside their plain versions.

≙ `paddle_tpu/ops/norm_kernels.py` :45-136 (`_rms_fwd_kernel`,
`_rms_bwd_kernel`, the `_rms` custom VJP, `rms_norm_values`) and
:147-251 (`_ln_fwd_kernel`, `_ln_bwd_kernel`, the `_ln` custom VJP,
`layer_norm_values`). The kernels (`csrc/rms_norm.cu`,
`csrc/layer_norm.cu`) run for CUDA tensors; `rms_norm_ref` and
`layer_norm_ref` are the same functions in plain PyTorch, which the CPU
path (differentiated by torch autograd) and the on-card comparison use.
On the card each forward saves x, w and its statistics (``rstd``, and
``mean`` for LayerNorm), and the backward kernel recomputes x̂ from them
(`_RmsNormFn`, `_LayerNormFn`), as the JAX custom VJPs do.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernel_route, launch_counts

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pdt_rms_norm_fwd(x, w, o, rstd, n, h, eps, dtype, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
# pdt_rms_norm_bwd(x, w, rstd, g, dx, dw_part, dw, n, h, dtype, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]
# rows per block of the backward kernel (kBwdRows in csrc/rms_norm.cu):
# one f32 row of dw partial sums per block
_BWD_ROWS = 16
# the backward keeps one f32 row of dw partials in shared memory
_BWD_MAX_H = 49152


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """Plain PyTorch RMSNorm: ``x * rsqrt(mean(x^2) + eps) * w`` in f32,
    returned in x's dtype."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def _check(x2: torch.Tensor, w: torch.Tensor):
    h = x2.shape[1]
    if x2.dtype not in _DTYPES:
        raise TypeError(f"norm kernels take float32, bfloat16 or float16, "
                        f"got {x2.dtype}")
    if w.dtype != x2.dtype or w.shape != (h,):
        raise ValueError(f"norm kernels want w of shape ({h},) and "
                         f"dtype {x2.dtype}; got {tuple(w.shape)} "
                         f"{w.dtype}")
    if not (x2.is_cuda and w.is_cuda and x2.device == w.device):
        raise ValueError("norm kernels want x and w on one CUDA device")
    if not (x2.is_contiguous() and w.is_contiguous()):
        raise ValueError("norm kernels want contiguous x and w")


def _rms_fwd(x2: torch.Tensor, w: torch.Tensor, eps: float):
    """Launch the CUDA kernel on (n, h) rows: returns (o, rstd (n,) f32)."""
    _check(x2, w)
    n, h = x2.shape
    from ._build import kernel_fn
    fn = kernel_fn("rms_norm", "pdt_rms_norm_fwd", _ARGTYPES)
    o = torch.empty_like(x2)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), w.data_ptr(), o.data_ptr(), rstd.data_ptr(),
                 n, h, float(eps), _DTYPES[x2.dtype], stream)
    if err:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["rms_norm"] += 1
    return o, rstd


def _rms_bwd(x2, w, rstd, g2):
    """Launch the backward kernel on (n, h) rows: ``(dx, dw)``, dx in x's
    dtype, dw summed over the rows in f32 (per-block partials added in
    block order by a second kernel) and cast to w's dtype."""
    _check(x2, w)
    n, h = x2.shape
    if h > _BWD_MAX_H:
        raise ValueError(f"rms_norm backward kernel takes h <= "
                         f"{_BWD_MAX_H}; got {h}")
    if g2.shape != x2.shape or g2.dtype != x2.dtype or not g2.is_contiguous():
        raise ValueError("rms_norm backward wants a contiguous gradient of "
                         "x's shape and dtype")
    if rstd.shape != (n,) or rstd.dtype != torch.float32:
        raise ValueError("rms_norm backward wants the forward's (n,) f32 "
                         "rstd")
    from ._build import kernel_fn
    fn = kernel_fn("rms_norm", "pdt_rms_norm_bwd", _BWD_ARGTYPES)
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    part = torch.empty(-(-n // _BWD_ROWS), h, dtype=torch.float32,
                       device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), w.data_ptr(), rstd.data_ptr(),
                 g2.data_ptr(), dx.data_ptr(), part.data_ptr(),
                 dw.data_ptr(), n, h, _DTYPES[x2.dtype], stream)
    if err:
        raise RuntimeError(f"rms_norm backward kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["rms_norm_bwd"] += 1
    return dx, dw


class _RmsNormFn(torch.autograd.Function):
    """The kernel pair as one differentiable op (≙ the `_rms` custom
    VJP): the forward saves (x, w, rstd), the backward kernel reads
    them."""

    @staticmethod
    def forward(ctx, x2, w, eps):
        o, rstd = _rms_fwd(x2, w, eps)
        ctx.save_for_backward(x2, w, rstd)
        return o

    @staticmethod
    def backward(ctx, g):
        x2, w, rstd = ctx.saved_tensors
        dx, dw = _rms_bwd(x2, w, rstd, g.contiguous())
        return dx, dw, None


def rms_norm_values(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                    use_kernel=None) -> torch.Tensor:
    """RMSNorm over the last axis. A CUDA tensor goes through the kernel
    (any row count — the TPU's ``n % block_rows`` fallback has no
    counterpart here), and when autograd records the call its gradient
    goes through the backward kernel; a CPU tensor, or
    ``use_kernel=False``, through `rms_norm_ref` and torch autograd."""
    if not kernel_route(x, use_kernel):
        return rms_norm_ref(x, w, eps)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    w = w.contiguous()
    if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        return _RmsNormFn.apply(x2, w, float(eps)).reshape(shape)
    return _rms_fwd(x2, w, eps)[0].reshape(shape)


# -- layernorm ---------------------------------------------------------------
# pdt_layer_norm_fwd(x, w, b, o, mean, rstd, n, h, eps, dtype, stream)
_LN_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_float, ctypes.c_int,
                                        ctypes.c_void_p]
# pdt_layer_norm_bwd(x, w, mean, rstd, g, dx, part, dw, db, n, h, dtype,
#                    stream)
_LN_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]
# the backward keeps one f32 row of dw and one of db partials in shared
# memory
_LN_BWD_MAX_H = 24576

# limits on `ops.kernel_errors` for the LayerNorm kernels against their
# plain versions on the same inputs: both compute in f32 and round each
# output once, so bf16 outputs differ where f32 sums in another order
# straddle a rounding (at most one bf16 ulp, 2^-8 relative), f32 by the
# order of the sums. A backward without the mean(w·g) term reads
# ~1/sqrt(H) (0.017 at H = 3584) on dx (chip_smoke.py). f16 rounds at the
# same places with 3 more significant bits: bf16's limits.
LN_LIMITS = {torch.bfloat16: dict(rel=2e-3, row=8e-3),
             torch.float16: dict(rel=2e-3, row=8e-3),
             torch.float32: dict(rel=1e-5, row=1e-4)}


def layer_norm_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   eps: float = 1e-5):
    """Plain PyTorch LayerNorm over the last axis: mean and variance in
    f32 (two passes), ``(x - mu) * rsqrt(var + eps) * w + b`` in f32,
    returned in x's dtype (≙ the XLA branch of `layer_norm_values` and
    what `_ln_fwd_kernel` computes)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float()
            + b.float()).to(x.dtype)


def _ln_check(x2, w, b):
    _check(x2, w)
    if b.dtype != x2.dtype or b.shape != w.shape or not b.is_contiguous() \
            or b.device != x2.device:
        raise ValueError(f"layer_norm kernel wants a contiguous bias like w "
                         f"({tuple(w.shape)}, {w.dtype}) on x's device; got "
                         f"{tuple(b.shape)} {b.dtype}")


def _ln_fwd(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float):
    """Launch the forward kernel on (n, h) rows: (o, mean (n,) f32, rstd
    (n,) f32)."""
    _ln_check(x2, w, b)
    n, h = x2.shape
    from ._build import kernel_fn
    fn = kernel_fn("layer_norm", "pdt_layer_norm_fwd", _LN_ARGTYPES)
    o = torch.empty_like(x2)
    mean = torch.empty(n, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(),
                 mean.data_ptr(), rstd.data_ptr(), n, h, float(eps),
                 _DTYPES[x2.dtype], stream)
    if err:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["layer_norm"] += 1
    return o, mean, rstd


def _ln_bwd(x2, w, mean, rstd, g2):
    """Launch the backward kernel on (n, h) rows: ``(dx, dw, db)``, dx in
    x's dtype, dw and db summed over the rows in f32 (per-block partials
    added in block order by a second kernel) and cast to w's dtype."""
    _check(x2, w)
    n, h = x2.shape
    if h > _LN_BWD_MAX_H:
        raise ValueError(f"layer_norm backward kernel takes h <= "
                         f"{_LN_BWD_MAX_H}; got {h}")
    if g2.shape != x2.shape or g2.dtype != x2.dtype or \
            not g2.is_contiguous():
        raise ValueError("layer_norm backward wants a contiguous gradient "
                         "of x's shape and dtype")
    for t in (mean, rstd):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError("layer_norm backward wants the forward's (n,) "
                             "f32 mean and rstd")
    from ._build import kernel_fn
    fn = kernel_fn("layer_norm", "pdt_layer_norm_bwd", _LN_BWD_ARGTYPES)
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    db = torch.empty_like(w)
    part = torch.empty(2, -(-n // _BWD_ROWS), h, dtype=torch.float32,
                       device=x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    with torch.cuda.device(x2.device):
        err = fn(x2.data_ptr(), w.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), g2.data_ptr(), dx.data_ptr(),
                 part.data_ptr(), dw.data_ptr(), db.data_ptr(), n, h,
                 _DTYPES[x2.dtype], stream)
    if err:
        raise RuntimeError(f"layer_norm backward kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["layer_norm_bwd"] += 1
    return dx, dw, db


class _LayerNormFn(torch.autograd.Function):
    """The kernel pair as one differentiable op (≙ the `_ln` custom
    VJP): the forward saves (x, w, mean, rstd), the backward kernel reads
    them."""

    @staticmethod
    def forward(ctx, x2, w, b, eps):
        o, mean, rstd = _ln_fwd(x2, w, b, eps)
        ctx.save_for_backward(x2, w, mean, rstd)
        return o

    @staticmethod
    def backward(ctx, g):
        x2, w, mean, rstd = ctx.saved_tensors
        dx, dw, db = _ln_bwd(x2, w, mean, rstd, g.contiguous())
        return dx, dw, db, None


def layer_norm_values(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      eps: float = 1e-5, use_kernel=None) -> torch.Tensor:
    """LayerNorm over the last axis with a weight and a bias. A CUDA
    tensor goes through the kernel (any row count: the TPU's
    ``n % block_rows`` fallback is a tiling matter), and when autograd
    records the call its gradient goes through the backward kernel; a
    CPU tensor, or ``use_kernel=False``, through `layer_norm_ref` and
    torch autograd."""
    if not kernel_route(x, use_kernel):
        return layer_norm_ref(x, w, b, eps)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    w, b = w.contiguous(), b.contiguous()
    if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _LayerNormFn.apply(x2, w, b, float(eps)).reshape(shape)
    return _ln_fwd(x2, w, b, eps)[0].reshape(shape)
