"""RMSNorm forward: a hand-written CUDA kernel beside its plain version.

≙ `paddle_tpu/ops/norm_kernels.py` :45-136 (`_rms_fwd_kernel`,
`_rms_fwd`, `rms_norm_values`). The kernel (`csrc/rms_norm.cu`) runs
for CUDA tensors; `rms_norm_ref` is the same function in plain PyTorch,
which the CPU path and the on-card comparison use. Only the forward is
ported: serving has no backward. The kernel still writes ``rstd``, the
residual the backward (`_rms_bwd_kernel`, a later port) reads.
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


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """Plain PyTorch RMSNorm: ``x * rsqrt(mean(x^2) + eps) * w`` in f32,
    returned in x's dtype."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def _rms_fwd(x2: torch.Tensor, w: torch.Tensor, eps: float):
    """Launch the CUDA kernel on (n, h) rows: returns (o, rstd (n,) f32)."""
    n, h = x2.shape
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


def rms_norm_values(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
                    use_kernel=None) -> torch.Tensor:
    """RMSNorm over the last axis. A CUDA tensor goes through the kernel
    (any row count — the TPU's ``n % block_rows`` fallback has no
    counterpart here); a CPU tensor, or ``use_kernel=False``, through
    `rms_norm_ref`."""
    if not kernel_route(x, use_kernel):
        return rms_norm_ref(x, w, eps)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).contiguous()
    return _rms_fwd(x2, w.contiguous(), eps)[0].reshape(shape)
