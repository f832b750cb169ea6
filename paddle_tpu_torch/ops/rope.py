"""Rotary position embedding: hand-written CUDA kernels beside their plain
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
kernel with the sine negated): `_FusedRopeFn` saves no activation, only
the two tables, which get no gradient. The kernels
(`csrc/rope.cu`) read the interleaved pairs in place on any (B, S, H, D)
with D even; their f32 products and sums round as the plain version's
separate ops do, so the two agree bit for bit.

Two designs on the card, picked by `rope_design`: ``"vec"`` (`rope_vec`:
16-byte vectors, a thread's trig loaded once and reused over its heads,
q and k in one launch) for heads of whole 16-byte vectors at 16-byte-aligned
pointers, and ``"pair"`` (one pair a thread) for the rest. The launch
path is thin: the raw stream, the C entry makes the tensors' device
current only when it is not, and nothing is copied but a non-contiguous
input (and a table view off 16 bytes).

The serving path's per-token rope (`models.llama`) uses the plain
`rope_rotate_values` directly, as the JAX package's serving path passes
``use_pallas=False``.
"""
from __future__ import annotations

import ctypes

import torch

from . import current_stream, kernel_route, launch_counts
from ._build import kernel_fn

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pdt_rope(x, cos, sin, y, B, S, H, D, sign, dtype, device, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# pdt_rope_qk(q, k, cos, sin, yq, yk, B, S, H, HK, D, sign, dtype, device,
#             stream)
_QK_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
    + [ctypes.c_void_p]

# rope_vec's most threads a block (kMaxBlock in csrc/rope.cu), and so its
# most 16-byte vectors a head
VEC_MAX_BLOCK = 1024


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


def vec_chunks(dtype, d: int):
    """16-byte vectors in a head of ``d`` elements of ``dtype`` (the
    chunks `rope_vec`'s threads own), or None: d not a whole number of
    vectors, or more vectors than a block has threads."""
    if dtype not in _DTYPES or d <= 0:
        return None
    n = d * dtype.itemsize
    return n // 16 if n % 16 == 0 and n // 16 <= VEC_MAX_BLOCK else None


def rope_design(dtype, d: int, *ptrs):
    """Which kernel of `csrc/rope.cu` rotates heads of ``d`` elements of
    ``dtype`` with the launch's pointers ``ptrs`` (inputs, outputs,
    tables): ``"vec"`` when a head is whole 16-byte vectors
    (`vec_chunks`) and every pointer lies on 16 bytes, else ``"pair"``
    when every pointer lies on an element pair, else None (the dtype, an
    odd D, or a pointer off its pairs: no kernel takes it)."""
    if dtype not in _DTYPES or d <= 0 or d % 2:
        return None
    p = 0
    for x in ptrs:
        p |= x
    if vec_chunks(dtype, d) is not None and not p & 15:
        return "vec"
    return None if p & (2 * dtype.itemsize - 1) else "pair"


def _check_tables(x: torch.Tensor, c: torch.Tensor, sn: torch.Tensor):
    """Raise on tables the kernels do not take; return them on 16 bytes
    (a table view off 16 bytes is copied: (S, D/2) floats, small beside
    x)."""
    s, d = x.shape[1], x.shape[3]
    if d % 2 or c.shape != (s, d // 2) or sn.shape != c.shape:
        raise ValueError(f"rope kernel wants an even D and (S, D/2) tables; "
                         f"got x {tuple(x.shape)}, cos {tuple(c.shape)}")
    out = []
    for t in (c, sn):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != x.device:
            raise ValueError("rope kernel wants contiguous f32 tables on "
                             "x's device")
        out.append(t.clone() if t.data_ptr() % 16 else t)
    return out


def _launch(q: torch.Tensor, k, cos: torch.Tensor, sin: torch.Tensor,
            sign: int, _design=None):
    """Rotate (B, S, H, D) ``q`` and, unless None, (B, S, HK, D) ``k`` by
    the (S, D/2) f32 tables in the kernels: ``(q', k' or None)``. The
    design is `rope_design`'s (``_design``, private, names one: it lets a
    caller time the other at the same inputs; an input it cannot take
    raises ValueError before any launch). ``"vec"`` is one launch for
    both tensors, ``"pair"`` one a tensor."""
    code = _DTYPES.get(q.dtype)
    if code is None:
        raise TypeError(f"rope kernel takes float32, bfloat16 or float16, "
                        f"got {q.dtype}")
    if not q.is_cuda:
        raise ValueError(f"rope kernel needs a CUDA tensor; got {q.device}")
    b, s, h, d = q.shape
    hk = 0
    if k is not None:
        hk = k.shape[2]
        if k.dtype != q.dtype or k.device != q.device or \
                (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
            raise ValueError(f"rope kernel wants q and k of one dtype, B, S "
                             f"and D on one device; got {tuple(q.shape)} "
                             f"{q.dtype}, {tuple(k.shape)} {k.dtype}")
        if not k.is_contiguous():
            k = k.contiguous()
    if not q.is_contiguous():
        q = q.contiguous()
    cos, sin = _check_tables(q, cos, sin)
    yq = torch.empty_like(q)
    yk = None if k is None else torch.empty_like(k)
    ptrs = [q.data_ptr(), yq.data_ptr(), cos.data_ptr(), sin.data_ptr()]
    if k is not None:
        ptrs += [k.data_ptr(), yk.data_ptr()]
    design = rope_design(q.dtype, d, *ptrs)
    if _design not in (None, "vec", "pair"):
        raise ValueError(f"no rope design {_design!r}; want 'vec' or "
                         f"'pair'")
    if design is None or (_design == "vec" and design != "vec"):
        who = "rope_vec" if _design == "vec" else "no rope kernel"
        raise ValueError(
            f"{who} takes D={d} {q.dtype} at these pointers: rope_vec needs "
            f"heads of whole 16-byte vectors on 16 bytes, the pair design "
            f"pointers on their element pairs")
    design = _design or design
    dev = q.get_device()
    stream = current_stream(dev)
    if design == "vec":
        err = kernel_fn("rope", "pdt_rope_qk", _QK_ARGTYPES)(
            ptrs[0], ptrs[4] if hk else 0, ptrs[2], ptrs[3], ptrs[1],
            ptrs[5] if hk else 0, b, s, h, hk, d, int(sign), code, dev,
            stream)
        if err:
            raise RuntimeError(f"rope kernel launch failed: CUDA error "
                               f"{err}")
        launch_counts["rope"] += 1
        return yq, yk
    fn = kernel_fn("rope", "pdt_rope", _ARGTYPES)
    for x, y in ((q, yq), (k, yk)):
        if x is None:
            continue
        err = fn(x.data_ptr(), ptrs[2], ptrs[3], y.data_ptr(), b, s,
                 x.shape[2], d, int(sign), code, dev, stream)
        if err:
            raise RuntimeError(f"rope kernel launch failed: CUDA error "
                               f"{err}")
        launch_counts["rope"] += 1
    return yq, yk


def _rope_cuda(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               sign: int, _design=None) -> torch.Tensor:
    """The kernel on one (B, S, H, D) tensor (`_launch` with no k)."""
    return _launch(x, None, cos, sin, sign, _design)[0]


def _rotate(kernel: bool, a, b, cos, sin, sign: int):
    """``(a', b')``: each of ``a``, ``b`` that is not None rotated by
    ``sign``, in one kernel launch when both are given (``kernel``), or
    by the plain version."""
    if a is None and b is None:
        return None, None
    if not kernel:
        return tuple(None if x is None else rope_ref(x, cos, sin,
                                                     float(sign))
                     for x in (a, b))
    if a is None:
        return None, _launch(b, None, cos, sin, sign)[0]
    return _launch(a, b, cos, sin, sign)


class _FusedRopeFn(torch.autograd.Function):
    """≙ the `_rope` custom VJP, for q and (unless None) k at the same
    positions as one differentiable op: one kernel launch forward, one
    backward for both cotangents (the inverse rotation, sign -1), or a
    launch on the one that carries a gradient; the tables are all it
    saves, and get no gradient."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, kernel):
        ctx.save_for_backward(cos, sin)
        ctx.kernel = kernel
        ctx.set_materialize_grads(False)
        return _rotate(kernel, q, k, cos, sin, 1)

    @staticmethod
    def backward(ctx, gq, gk):
        cos, sin = ctx.saved_tensors
        need_q, need_k = ctx.needs_input_grad[:2]
        dq, dk = _rotate(ctx.kernel, gq if need_q else None,
                         gk if need_k else None, cos, sin, -1)
        return dq, dk, None, None, None


def _table_rows(cos, sin, seq: int, position_offset: int, device):
    """Rows ``position_offset`` .. + seq - 1 of the tables, f32 and
    contiguous on ``device``. Raises ValueError when they run past the
    tables (the JAX package raises rather than let `dynamic_slice`
    clamp)."""
    position_offset = int(position_offset)
    if position_offset + seq > cos.shape[0]:
        raise ValueError(
            f"rope: position_offset {position_offset} + seq {seq} exceeds "
            f"precomputed table length {cos.shape[0]}")
    return tuple(t[position_offset:position_offset + seq].to(
        device=device, dtype=torch.float32).contiguous() for t in (cos, sin))


def rope_values(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                position_offset: int = 0, use_kernel=None) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, D) at positions ``position_offset``
    .. + S - 1 of the (max_len, D/2) tables, differentiable in x. Raises
    ValueError when the positions run past the tables. A CUDA tensor goes
    through the kernel (`rope_design`'s), a CPU tensor, or
    ``use_kernel=False``, through the plain version; ``use_kernel`` as in
    `ops.kernel_route`."""
    c, s = _table_rows(cos, sin, x.shape[1], position_offset, x.device)
    return _FusedRopeFn.apply(x, None, c, s,
                              kernel_route(x, use_kernel))[0]


def fused_rotary_position_embedding(q, k, cos, sin, position_offset=0,
                                    use_kernel=None):
    """≙ ``paddle.incubate.nn.functional.fused_rotary_position_embedding``:
    q and k rotated at the same positions; ``(q', k')``. q and k of one
    dtype, B, S and D on one device go through `_FusedRopeFn` (on the
    card one launch forward and one backward); otherwise each through
    `rope_values`."""
    if q.dtype != k.dtype or q.device != k.device or q.dim() != 4 or \
            k.dim() != 4 or (q.shape[0], q.shape[1], q.shape[3]) != \
            (k.shape[0], k.shape[1], k.shape[3]):
        return (rope_values(q, cos, sin, position_offset, use_kernel),
                rope_values(k, cos, sin, position_offset, use_kernel))
    c, s = _table_rows(cos, sin, q.shape[1], position_offset, q.device)
    return _FusedRopeFn.apply(q, k, c, s, kernel_route(q, use_kernel))
