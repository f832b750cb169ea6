"""RMSNorm forward and backward: hand-written CUDA kernels beside their
plain version.

≙ `paddle_tpu/ops/norm_kernels.py` :45-136 (`_rms_fwd_kernel`,
`_rms_bwd_kernel`, the `_rms` custom VJP, `rms_norm_values`). The
kernels (`csrc/rms_norm.cu`) run for CUDA tensors; `rms_norm_ref` is the
same function in plain PyTorch, which the CPU path (differentiated by
torch autograd) and the on-card comparison use. On the card the forward
saves x, w and its ``rstd`` output, and the backward kernel recomputes
x̂ from them (`_RmsNormFn`), as the JAX custom VJP does.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernel_route, launch_counts

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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
        raise TypeError(f"rms_norm kernel takes float32 or bfloat16, got "
                        f"{x2.dtype}")
    if w.dtype != x2.dtype or w.shape != (h,):
        raise ValueError(f"rms_norm kernel wants w of shape ({h},) and "
                         f"dtype {x2.dtype}; got {tuple(w.shape)} "
                         f"{w.dtype}")
    if not (x2.is_cuda and w.is_cuda and x2.device == w.device):
        raise ValueError("rms_norm kernel wants x and w on one CUDA device")
    if not (x2.is_contiguous() and w.is_contiguous()):
        raise ValueError("rms_norm kernel wants contiguous x and w")


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
