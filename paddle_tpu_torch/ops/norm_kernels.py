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

Each forward has two designs on the card, picked by `norm_design`: the
row held in registers and read once (`row_class`, `csrc/norm_rows.cuh`),
and a block a row that reads the row again (for the rows the first cannot
take). The launch path is kept thin for the decode step's many small
calls: the stream is read raw, a call without a backward stores no
statistics and reshapes nothing, and the C entry makes the tensors'
device current only when it is not.

Each backward has two designs too, picked by `norm_bwd_design`: the
register-row backward (`bwd_row_class`; x and g read once into
registers, persistent row groups over fixed runs of rows keeping w and
their dw / db partials in registers, one f32 partial row a block, then
the columns summed in a fixed order: `bwd_grid`, `group_rows` and
`norm_bwd_plan` model it in plain PyTorch), and the row-block backward
(a block per 16 rows, for the rows no class holds).
"""
from __future__ import annotations

import ctypes

import torch

from . import current_stream, kernel_route, launch_counts, sm_count
from ._build import kernel_fn

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# pdt_rms_norm_fwd(x, w, o, rstd, n, h, eps, dtype, wpr, nv, device, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
# pdt_rms_norm_bwd(x, w, rstd, g, dx, dw_part, dw, n, h, dtype, wpr, nv,
#                  part_rows, device, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]
# rows per block of the rowblock backward (kBwdRows in csrc/rms_norm.cu):
# one f32 row of dw partial sums per block
_BWD_ROWS = 16
# the rowblock backward keeps one f32 row of dw partials in shared memory
_BWD_MAX_H = 49152

# The forwards' register-row design (`csrc/norm_rows.cuh`): a row is h / V
# 16-byte vectors (V = 4 f32, 8 bf16 / f16) spread over the lanes of a few
# warps, at most ROW_VECS a lane, held in registers; the classes of warps
# a row that the kernels are built for (to Llama-3-8B's 4096 in f32; wider
# rows take the strided design).
ROW_WARPS = (1, 2, 4)
ROW_VECS = 8


def _class(dtype, h: int, warps, vecs):
    """``(warps a row, vectors a lane)``: the fewest of ``warps`` whose
    lanes hold the row's 16-byte vectors at most ``vecs`` each, or None
    (a row not of whole vectors, or wider than the largest)."""
    if dtype not in _DTYPES or h <= 0:
        return None
    v = 16 // dtype.itemsize
    if h % v:
        return None
    nvec = h // v
    for wpr in warps:
        if nvec <= 32 * wpr * vecs:
            return wpr, -(-nvec // (32 * wpr))
    return None


def row_class(dtype, h: int):
    """The register-row design's class for rows of ``h`` elements of
    ``dtype``: ``(warps a row, vectors a lane)``, the fewest warps whose
    lanes hold the row's 16-byte vectors at most `ROW_VECS` each (lane t
    holds vectors t, t + 32 w, ..., so lanes differ by at most one), or
    None: h not a whole number of vectors, or past the largest class
    (4 warps x 8 vectors: 4096 f32, 8192 bf16 / f16 elements)."""
    return _class(dtype, h, ROW_WARPS, ROW_VECS)


def norm_design(dtype, h: int) -> str:
    """Which forward kernel of `csrc/rms_norm.cu` / `csrc/layer_norm.cu`
    takes rows of ``h`` elements of ``dtype`` on the card:
    ``"registers"`` (the row in registers, read once: `row_class`) where a
    class holds the row, else ``"strided"`` (a block a row, read twice or
    three times; it takes every row). A pointer off 16 bytes also goes to
    the strided kernel."""
    return "strided" if row_class(dtype, h) is None else "registers"


def _route(dtype, h: int, ptrs: int, design):
    """``(warps a row, vectors a lane)`` of the forward that runs, (0, 0)
    for the strided one: ``design`` when the caller names one (private: it
    lets a caller run the other design at the same shape; an input it
    cannot take raises ValueError), else `norm_design`'s, and the strided
    design when a pointer (``ptrs``: the pointers or-ed) is off 16
    bytes."""
    if design is None:
        return (0, 0) if ptrs & 15 else (row_class(dtype, h) or (0, 0))
    if design == "strided":
        return 0, 0
    if design != "registers":
        raise ValueError(f"no norm forward design {design!r}; want "
                         f"'registers' or 'strided'")
    cls = row_class(dtype, h)
    if cls is None or ptrs & 15:
        raise ValueError(
            f"the registers norm design takes rows of whole 16-byte vectors "
            f"(up to {32 * ROW_WARPS[-1] * ROW_VECS} vectors) at 16-byte-"
            f"aligned pointers; got h={h} {dtype}"
            + (", a pointer off 16 bytes" if ptrs & 15 else ""))
    return cls


# The backwards' register-row design (`csrc/norm_rows.cuh`): the forward's
# lane map, at most BWD_ROW_VECS vectors a lane (a row group holds x, g,
# w and f32 dw / db partials of its columns), so wider rows take more
# warps: to 4096 f32, 8192 bf16 / f16 elements. A row group loads its next
# row while it computes the current one (a second register set).
BWD_ROW_WARPS = (1, 2, 4, 8)
BWD_ROW_VECS = 4
# kBwdBlock: threads of a backward block; kBwdMaxBlocksPerSm: blocks an
# SM at most, so the partial rows a call allocates an SM; kSumWarps: warps
# of a column-sum block, which sums 32 columns
BWD_BLOCK = 256
BWD_BLOCKS_PER_SM = 8
BWD_SUM_WARPS = 16


def bwd_row_class(dtype, h: int):
    """The register-row backward's class for rows of ``h`` elements of
    ``dtype``: ``(warps a row, vectors a lane)``, the fewest warps whose
    lanes hold the row's 16-byte vectors at most `BWD_ROW_VECS` each
    (lane t holds vectors t, t + 32 w, ..., as in `row_class`), or None:
    h not a whole number of vectors, or past the largest class (8 warps
    x 4 vectors: 4096 f32, 8192 bf16 / f16 elements)."""
    return _class(dtype, h, BWD_ROW_WARPS, BWD_ROW_VECS)


def norm_bwd_design(dtype, h: int) -> str:
    """Which backward kernels of `csrc/rms_norm.cu` / `csrc/layer_norm.cu`
    take rows of ``h`` elements of ``dtype`` on the card:
    ``"registers"`` (the register-row backward: `bwd_row_class`) where a
    class holds the row, else ``"rowblock"`` (a block per 16 rows, x and
    g read twice). A pointer off 16 bytes also goes to the rowblock
    kernels."""
    return "rowblock" if bwd_row_class(dtype, h) is None else "registers"


def _bwd_route(dtype, h: int, ptrs: int, design, max_h: int):
    """``(warps a row, vectors a lane)`` of the backward that runs, (0, 0)
    for the rowblock one: ``design`` when the caller names one (private;
    an input it cannot take raises ValueError), else `norm_bwd_design`'s,
    and the rowblock design when a pointer (``ptrs``: the pointers
    or-ed) is off 16 bytes. A row neither design takes raises."""
    if design not in (None, "registers", "rowblock"):
        raise ValueError(f"no norm backward design {design!r}; want "
                         f"'registers' or 'rowblock'")
    cls = bwd_row_class(dtype, h)
    if design == "registers" and (cls is None or ptrs & 15):
        raise ValueError(
            f"the registers norm backward takes rows of whole 16-byte "
            f"vectors (up to {32 * BWD_ROW_WARPS[-1] * BWD_ROW_VECS} "
            f"vectors) at 16-byte-aligned pointers; got h={h} {dtype}"
            + (", a pointer off 16 bytes" if ptrs & 15 else ""))
    if design == "registers" or (design is None and cls is not None
                                 and not ptrs & 15):
        return cls
    if h > max_h:
        raise ValueError(f"the rowblock norm backward takes h <= {max_h}; "
                         f"got {h}")
    return 0, 0


def bwd_grid(n: int, wpr: int, sms: int, blocks_per_sm: int):
    """``(blocks, row groups a block)`` of the register-row backward over
    ``n`` rows with ``wpr`` warps a row (`launch_bwd_rows` in
    `csrc/norm_rows.cuh`): `BWD_BLOCK` threads a block, unless the rows
    would then not fill the ``sms`` SMs (a row group a block then); one
    wave of the blocks an SM holds (``blocks_per_sm``, the occupancy,
    at most `BWD_BLOCKS_PER_SM`)."""
    groups = BWD_BLOCK // (32 * wpr)
    if -(-n // groups) < sms:
        groups = 1
    return min(-(-n // groups), blocks_per_sm * sms), groups


def group_rows(n: int, groups_total: int):
    """The contiguous run ``[lo, hi)`` of rows that each of the grid's
    ``groups_total`` row groups walks, in group order (group i of block
    b is ``b * groups + i``)."""
    return [(n * i // groups_total, n * (i + 1) // groups_total)
            for i in range(groups_total)]


def _sum_rows_in_order(parts: torch.Tensor, runs) -> torch.Tensor:
    """f32 sums of ``parts`` (rows, h) over each run ``[lo, hi)`` of rows,
    row after row in order (one run a row group)."""
    out = torch.zeros(len(runs), parts.shape[1], dtype=torch.float32)
    longest = max((hi - lo for lo, hi in runs), default=0)
    lo = torch.tensor([r[0] for r in runs])
    hi = torch.tensor([r[1] for r in runs])
    for k in range(longest):
        live = (lo + k) < hi
        rows = torch.where(live, lo + k, 0)
        out += torch.where(live[:, None], parts[rows], 0.0)
    return out


def norm_bwd_plan(x, w, g, rstd, mean=None, *, sms: int,
                  blocks_per_sm: int):
    """The register-row backward's plan in plain PyTorch, in its orders:
    ``(dx, dw, db)`` (db None without ``mean``: RMSNorm) for (n, h) rows
    of x and g, w, and the forward's f32 statistics. dx row by row in f32
    (dx = rstd (w g - mean(w g) - x̂ mean(w g x̂)), the mean(w g) term for
    LayerNorm only); dw = Σ g x̂ and db = Σ g: each row group of
    `bwd_grid` / `group_rows` sums its run of rows in order, a block's
    groups add in group order into its partial row, and each column's
    partial rows are summed as `norm_cols_sum` does (warp k of
    `BWD_SUM_WARPS` takes rows k, k + BWD_SUM_WARPS, ..., then the warps
    in order). The card's kernel rounds in the same places; its f32
    products may fuse into FMAs, so the two agree within f32 rounding,
    not bitwise."""
    n, h = x.shape
    wpr, _ = bwd_row_class(x.dtype, h)
    xf, gf, wf = x.float(), g.float(), w.float()
    mu = mean.float()[:, None] if mean is not None else 0.0
    r = rstd.float()[:, None]
    xh = (xf - mu) * r
    wg = gf * wf
    m2 = (wg * xh).mean(-1, keepdim=True)
    m1 = wg.mean(-1, keepdim=True) if mean is not None else 0.0
    dx = (r * (wg - m1 - xh * m2)).to(x.dtype)
    blocks, groups = bwd_grid(n, wpr, sms, blocks_per_sm)
    runs = group_rows(n, blocks * groups)

    def total(parts):
        per_group = _sum_rows_in_order(parts, runs)
        per_block = per_group[0::groups].clone()
        for k in range(1, groups):
            per_block += per_group[k::groups]
        # the column sums: warp k's rows k, k + BWD_SUM_WARPS, ... in order
        nb = per_block.shape[0]
        taken = [list(range(k, nb, BWD_SUM_WARPS))
                 for k in range(BWD_SUM_WARPS)]
        starts = [0]
        for rows in taken:
            starts.append(starts[-1] + len(rows))
        per_warp = _sum_rows_in_order(
            per_block[[i for rows in taken for i in rows]],
            list(zip(starts[:-1], starts[1:])))
        out = torch.zeros(h, dtype=torch.float32)
        for k in range(BWD_SUM_WARPS):
            out += per_warp[k]
        return out.to(w.dtype)

    dw = total(gf * xh)
    db = total(gf) if mean is not None else None
    return dx, dw, db


def rms_norm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """Plain PyTorch RMSNorm: ``x * rsqrt(mean(x^2) + eps) * w`` in f32,
    returned in x's dtype."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * w.float()).to(x.dtype)


def _code(x2: torch.Tensor) -> int:
    """x2's dtype code for the C entries; TypeError for another dtype."""
    code = _DTYPES.get(x2.dtype)
    if code is None:
        raise TypeError(f"norm kernels take float32, bfloat16 or float16, "
                        f"got {x2.dtype}")
    return code


def _check(x2: torch.Tensor, w: torch.Tensor) -> int:
    """Raise on what the kernels do not take; return x2's device index."""
    h = x2.shape[-1]
    _code(x2)
    if w.dtype != x2.dtype or w.shape != (h,):
        raise ValueError(f"norm kernels want w of shape ({h},) and "
                         f"dtype {x2.dtype}; got {tuple(w.shape)} "
                         f"{w.dtype}")
    if not (x2.is_cuda and w.is_cuda and x2.device == w.device):
        raise ValueError("norm kernels want x and w on one CUDA device")
    if not (x2.is_contiguous() and w.is_contiguous()):
        raise ValueError("norm kernels want contiguous x and w")
    return x2.get_device()


def _rms_fwd(x2: torch.Tensor, w: torch.Tensor, eps: float, _design=None,
             stats=True):
    """Launch the forward kernel on the rows of contiguous ``x2`` (any
    rank; rows along the last axis): returns (o of x2's shape, rstd (n,)
    f32, or None without ``stats``: then the kernel stores none). The
    design is `norm_design`'s unless ``_design`` names one."""
    h = x2.shape[-1]
    xp, wp = x2.data_ptr(), w.data_ptr()
    code, (wpr, nv) = _code(x2), _route(x2.dtype, h, xp | wp, _design)
    dev = _check(x2, w)
    n = x2.numel() // h if h else 0
    o = torch.empty_like(x2)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device) \
        if stats else None
    err = kernel_fn("rms_norm", "pdt_rms_norm_fwd", _ARGTYPES)(
        xp, wp, o.data_ptr(), rstd.data_ptr() if stats else 0, n, h, eps,
        code, wpr, nv, dev, current_stream(dev))
    if err:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["rms_norm"] += 1
    return o, rstd


def _bwd_part(x2, planes: int, wpr: int, n: int, h: int):
    """f32 scratch for the backward's partial rows and its row count:
    `BWD_BLOCKS_PER_SM` rows an SM for the register-row design (it
    launches at most that many blocks), ceil(n / 16) for the rowblock
    one."""
    rows = sm_count(x2.device) * BWD_BLOCKS_PER_SM if wpr \
        else -(-n // _BWD_ROWS)
    return torch.empty(planes, rows, h, dtype=torch.float32,
                       device=x2.device), rows


def _rms_bwd(x2, w, rstd, g2, _design=None):
    """Launch the backward kernels on (n, h) rows: ``(dx, dw)``, dx in x's
    dtype, dw summed over the rows in f32 (partial rows added in a fixed
    order by a second kernel) and cast to w's dtype. The design is
    `norm_bwd_design`'s unless ``_design`` names one (private: it lets a
    caller time the other at the same shape)."""
    n, h = x2.shape
    wpr, nv = _bwd_route(x2.dtype, h, x2.data_ptr() | w.data_ptr()
                         | g2.data_ptr(), _design, _BWD_MAX_H)
    dev = _check(x2, w)
    if g2.shape != x2.shape or g2.dtype != x2.dtype or not g2.is_contiguous():
        raise ValueError("rms_norm backward wants a contiguous gradient of "
                         "x's shape and dtype")
    if rstd.shape != (n,) or rstd.dtype != torch.float32:
        raise ValueError("rms_norm backward wants the forward's (n,) f32 "
                         "rstd")
    fn = kernel_fn("rms_norm", "pdt_rms_norm_bwd", _BWD_ARGTYPES)
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    part, rows = _bwd_part(x2, 1, wpr, n, h)
    err = fn(x2.data_ptr(), w.data_ptr(), rstd.data_ptr(), g2.data_ptr(),
             dx.data_ptr(), part.data_ptr(), dw.data_ptr(), n, h,
             _DTYPES[x2.dtype], wpr, nv, rows, dev, current_stream(dev))
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
    x, w = x.contiguous(), w.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        shape = x.shape
        return _RmsNormFn.apply(x.reshape(-1, shape[-1]), w,
                                float(eps)).reshape(shape)
    # no reshape: the kernel takes the rows of x in any rank; no rstd
    # without a backward
    return _rms_fwd(x, w, eps, stats=False)[0]


# -- layernorm ---------------------------------------------------------------
# pdt_layer_norm_fwd(x, w, b, o, mean, rstd, n, h, eps, dtype, wpr, nv,
#                    device, stream)
_LN_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_float] \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# pdt_layer_norm_bwd(x, w, mean, rstd, g, dx, part, dw, db, n, h, dtype,
#                    wpr, nv, part_rows, device, stream)
_LN_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]
# the rowblock backward keeps one f32 row of dw and one of db partials in
# shared memory
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


def _ln_check(x2, w, b) -> int:
    dev = _check(x2, w)
    if b.dtype != x2.dtype or b.shape != w.shape or not b.is_contiguous() \
            or b.device != x2.device:
        raise ValueError(f"layer_norm kernel wants a contiguous bias like w "
                         f"({tuple(w.shape)}, {w.dtype}) on x's device; got "
                         f"{tuple(b.shape)} {b.dtype}")
    return dev


def _ln_fwd(x2: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float,
            _design=None, stats=True):
    """Launch the forward kernel on the rows of contiguous ``x2`` (any
    rank; rows along the last axis): (o of x2's shape, mean (n,) f32,
    rstd (n,) f32), the two statistics rows of one (2, n) tensor, or
    None for both without ``stats`` (the kernel stores none). The design
    is `norm_design`'s unless ``_design`` names one."""
    h = x2.shape[-1]
    xp, wp, bp = x2.data_ptr(), w.data_ptr(), b.data_ptr()
    code, (wpr, nv) = _code(x2), _route(x2.dtype, h, xp | wp | bp,
                                        _design)
    dev = _ln_check(x2, w, b)
    n = x2.numel() // h if h else 0
    o = torch.empty_like(x2)
    st = torch.empty(2, n, dtype=torch.float32, device=x2.device) \
        if stats else None
    sp = st.data_ptr() if stats else 0
    err = kernel_fn("layer_norm", "pdt_layer_norm_fwd", _LN_ARGTYPES)(
        xp, wp, bp, o.data_ptr(), sp, sp + 4 * n if stats else 0, n, h, eps,
        code, wpr, nv, dev, current_stream(dev))
    if err:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["layer_norm"] += 1
    return (o, st[0], st[1]) if stats else (o, None, None)


def _ln_bwd(x2, w, mean, rstd, g2, _design=None, affine=True):
    """Launch the backward kernels on (n, h) rows: ``(dx, dw, db)``, dx in
    x's dtype, dw and db summed over the rows in f32 (partial rows added
    in a fixed order by a second kernel) and cast to w's dtype. The
    design as `_rms_bwd`'s. Without ``affine`` (w and b constants that
    take no gradient) it returns ``(dx, None, None)``: the register-row
    design then writes no partial rows and launches no column sums; the
    rowblock design (widths off the classes) sums them and drops them."""
    n, h = x2.shape
    wpr, nv = _bwd_route(x2.dtype, h, x2.data_ptr() | w.data_ptr()
                         | g2.data_ptr(), _design, _LN_BWD_MAX_H)
    dev = _check(x2, w)
    if g2.shape != x2.shape or g2.dtype != x2.dtype or \
            not g2.is_contiguous():
        raise ValueError("layer_norm backward wants a contiguous gradient "
                         "of x's shape and dtype")
    for t in (mean, rstd):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError("layer_norm backward wants the forward's (n,) "
                             "f32 mean and rstd")
    fn = kernel_fn("layer_norm", "pdt_layer_norm_bwd", _LN_BWD_ARGTYPES)
    dx = torch.empty_like(x2)
    sums = affine or not wpr
    dw = torch.empty_like(w) if sums else None
    db = torch.empty_like(w) if sums else None
    # without sums the grid is the same (part_rows caps the blocks) and
    # no scratch is allocated
    part, rows = _bwd_part(x2, 2, wpr, n, h) if sums else \
        (None, sm_count(x2.device) * BWD_BLOCKS_PER_SM)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    err = fn(x2.data_ptr(), w.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
             g2.data_ptr(), dx.data_ptr(), ptr(part), ptr(dw), ptr(db), n,
             h, _DTYPES[x2.dtype], wpr, nv, rows, dev, current_stream(dev))
    if err:
        raise RuntimeError(f"layer_norm backward kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["layer_norm_bwd"] += 1
    return (dx, dw, db) if affine else (dx, None, None)


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
        _, need_w, need_b, _ = ctx.needs_input_grad
        dx, dw, db = _ln_bwd(x2, w, mean, rstd, g.contiguous(),
                             affine=need_w or need_b)
        return dx, dw if need_w else None, db if need_b else None, None


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
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        shape = x.shape
        return _LayerNormFn.apply(x.reshape(-1, shape[-1]), w, b,
                                  float(eps)).reshape(shape)
    # no reshape: the kernel takes the rows of x in any rank; no
    # statistics without a backward
    return _ln_fwd(x, w, b, eps, stats=False)[0]
