"""Rotary position embedding: a hand-written CUDA kernel beside its plain
version.

≙ `paddle_tpu/ops/rope.py` :27-37 (`_rope_kernel`), :39-47
(`rope_rotate_values`), :50-68 (`_rope_apply`), :71-86 (the `_rope`
custom VJP), :89-107 (`rope_values`) and :110-117
(`fused_rotary_position_embedding`).

The pairs are interleaved, ``(x[..., 0::2], x[..., 1::2])`` (not the
half-split ``rotate_half`` convention): pair i of position s turns by the
angle whose cosine and sine are ``cos[s, i]`` and ``sin[s, i]``, in f32,
and the result is cast back to x's dtype. The rotation is linear and
orthogonal, so its VJP is the inverse rotation of the cotangent (the same
kernel with the sine negated): `_RopeFn` saves no activation, only the
two tables, which get no gradient. The kernel (`csrc/rope.cu`) reads the
interleaved pairs in place on any (B, S, H, D) with D even; its f32
products and sums round as the plain version's separate ops do, so the
two agree bit for bit.

The serving path's per-token rope (`models.llama`) uses the plain
`rope_rotate_values` directly, as the JAX package's serving path passes
``use_pallas=False``.
"""
from __future__ import annotations

import ctypes

import torch

from . import kernel_route, launch_counts

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pdt_rope(x, cos, sin, y, B, S, H, D, sign, dtype, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def rope_rotate_values(x: torch.Tensor, c: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """Interleaved-pair rotation: the pairs are ``(x[..., 0::2],
    x[..., 1::2])`` (not the half-split ``rotate_half`` convention).
    ``c``/``s`` are f32 trig values already broadcast-shaped against
    those halves. Computed in f32, returned in x's dtype."""
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                       dim=-1).reshape(x.shape).to(x.dtype)


def rope_ref(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             sign: float = 1.0) -> torch.Tensor:
    """The plain version on (B, S, H, D) with (S, D/2) f32 tables: the
    rotation by +angle (``sign`` 1) or -angle (-1, the backward)."""
    c = cos.float()[None, :, None, :]
    s = (sin.float() * sign)[None, :, None, :]
    return rope_rotate_values(x, c, s)


def _rope_cuda(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               sign: int) -> torch.Tensor:
    """Launch the kernel on a contiguous (B, S, H, D) ``x`` and contiguous
    (S, D/2) f32 tables."""
    b, s, h, d = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"rope kernel takes float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    if d % 2 or cos.shape != (s, d // 2) or sin.shape != cos.shape:
        raise ValueError(f"rope kernel wants an even D and (S, D/2) tables; "
                         f"got x {tuple(x.shape)}, cos {tuple(cos.shape)}")
    for t in (cos, sin):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != x.device:
            raise ValueError("rope kernel wants contiguous f32 tables on "
                             "x's device")
    if not x.is_cuda:
        raise ValueError(f"rope kernel needs a CUDA tensor; got {x.device}")
    x = x.contiguous()
    if x.data_ptr() % 8:
        x = x.clone()
    y = torch.empty_like(x)
    from ._build import kernel_fn
    fn = kernel_fn("rope", "pdt_rope", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), cos.data_ptr(), sin.data_ptr(), y.data_ptr(),
                 b, s, h, d, int(sign), _DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"rope kernel launch failed: CUDA error {err}")
    launch_counts["rope"] += 1
    return y


class _RopeFn(torch.autograd.Function):
    """≙ the `_rope` custom VJP: the backward is the inverse rotation of
    the cotangent (the kernel, or the plain version, with sign -1); cos
    and sin get no gradient."""

    @staticmethod
    def forward(ctx, x, cos, sin, kernel):
        ctx.save_for_backward(cos, sin)
        ctx.kernel = kernel
        if kernel:
            return _rope_cuda(x, cos, sin, 1)
        return rope_ref(x, cos, sin, 1.0)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        if ctx.kernel:
            return _rope_cuda(g.contiguous(), cos, sin, -1), None, None, None
        return rope_ref(g, cos, sin, -1.0), None, None, None


def rope_values(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                position_offset: int = 0, use_kernel=None) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, D) at positions ``position_offset``
    .. + S - 1 of the (max_len, D/2) tables, differentiable in x. Raises
    ValueError when the positions run past the tables (the JAX package
    raises rather than let `dynamic_slice` clamp). A CUDA tensor goes
    through the kernel, a CPU tensor, or ``use_kernel=False``, through
    the plain version; ``use_kernel`` as in `ops.kernel_route`."""
    seq = x.shape[1]
    position_offset = int(position_offset)
    if position_offset + seq > cos.shape[0]:
        raise ValueError(
            f"rope: position_offset {position_offset} + seq {seq} exceeds "
            f"precomputed table length {cos.shape[0]}")
    c = cos[position_offset:position_offset + seq].to(
        device=x.device, dtype=torch.float32).contiguous()
    s = sin[position_offset:position_offset + seq].to(
        device=x.device, dtype=torch.float32).contiguous()
    kernel = kernel_route(x, use_kernel)
    return _RopeFn.apply(x, c, s, kernel)


def fused_rotary_position_embedding(q, k, cos, sin, position_offset=0,
                                    use_kernel=None):
    """≙ ``paddle.incubate.nn.functional.fused_rotary_position_embedding``:
    `rope_values` of q and of k at the same positions; ``(q', k')``."""
    return (rope_values(q, cos, sin, position_offset, use_kernel),
            rope_values(k, cos, sin, position_offset, use_kernel))
