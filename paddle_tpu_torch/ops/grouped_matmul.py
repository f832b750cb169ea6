"""Grouped (ragged) matmul, the MoE expert-compute primitive: a
hand-written CUDA kernel beside its plain version.

≙ `paddle_tpu/ops/grouped_matmul.py` (`_gmm_kernel` / `gmm_pallas`,
`_gmm_xla`, the `grouped_matmul_values` custom VJP :113-151):

    out[r] = lhs[r] @ rhs[g(r)]        g(r) = the group owning row r

with the rows of ``lhs`` sorted by group, ``group_sizes[e]`` of them in
group e, and rows past ``sum(group_sizes)`` zero. ``rhs`` keeps the JAX
layout, (E, K, N).

A CUDA tensor goes through the kernel (`csrc/grouped_matmul.cu`), which
takes unpadded groups (a tile that straddles two groups is computed once
for each; the TPU kernel needs every group padded to its 128-row tile)
and reads ``group_sizes`` on the device, so no launch waits for the host.
The kernel has three designs (`gmm_design`): bf16 and f16 with K and N
multiples of 8 run on wgmma with TMA-fed tiles, other bf16 / f16 shapes on
mma.sync, f32 on CUDA cores. A CPU tensor goes through `gmm_plain`. Under
autograd (`_GmmFn`, ≙ `_gmm_fwd` / `_gmm_bwd`):

* d(lhs) = the same kernel on rhs transposed: the kernel reads ``rhs``
  as (E, N, K) (``trans=True``), so ``swapaxes(rhs, 1, 2)``, a copy of
  every expert (1.76 GB a layer at the A14B width), is never made;
* d(rhs)[e] = lhs_eᵀ · dout_e, outside any kernel as in JAX (there the
  ragged_dot transpose rule): one `torch.mm` per non-empty group over its
  row range, which reads the group sizes on the host once a backward
  (ROADMAP.md: a hand-written transposed grouped matmul is later work).
"""
from __future__ import annotations

import ctypes

import torch

from . import kernel_route, launch_counts

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# rows per m tile of the kernel's bf16/f16 and f32 paths (kBM / kFBM in
# csrc/grouped_matmul.cu): the work list holds ceil(M / tile) + E items
_TILE_M = {torch.bfloat16: 128, torch.float16: 128, torch.float32: 64}
# pdt_grouped_matmul(lhs, rhs, group_sizes, work, out, M, K, N, E, trans,
#                    dtype, stream); pdt_grouped_matmul_sm90 alike
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

# limits on `ops.kernel_errors` for the kernel against `gmm_plain` on
# the same inputs. bf16: the products are exact in f32 on both sides, so the two
# differ by the order of the f32 sums and one rounding of each output to
# bf16 (2^-9 relative at most, ~1.1e-3 RMS); f32: sums of up to a few
# thousand products in another order. A skipped 32-wide K step or a row
# multiplied by the wrong group's weights reads above 0.05 (chip_smoke.py).
# f16 rounds at the same place with 3 more significant bits: bf16's limits.
GMM_LIMITS = {torch.bfloat16: dict(rel=4e-3, row=1.6e-2),
              torch.float16: dict(rel=4e-3, row=1.6e-2),
              torch.float32: dict(rel=1e-5, row=1e-4)}


def _sizes(group_sizes) -> list:
    return [int(s) for s in torch.as_tensor(group_sizes).tolist()]


def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes,
              trans: bool = False) -> torch.Tensor:
    """Plain PyTorch grouped matmul (≙ `_gmm_xla` and what `_gmm_kernel`
    computes): ``lhs`` (M, K); ``rhs`` (E, K, N), or (E, N, K) read
    transposed with ``trans``. Each group's rows times its matrix in f32,
    cast to the result dtype of ``lhs`` and ``rhs``; rows past the last
    group (and past a sum of sizes larger than M) are zero."""
    m = lhs.shape[0]
    n = rhs.shape[1] if trans else rhs.shape[2]
    out = torch.zeros(m, n, dtype=torch.result_type(lhs, rhs),
                      device=lhs.device)
    start = 0
    for e, s in enumerate(_sizes(group_sizes)):
        end = min(m, start + max(s, 0))
        if end > start:
            w = rhs[e].float()
            out[start:end] = (lhs[start:end].float()
                              @ (w.T if trans else w)).to(out.dtype)
        start = end
    return out


def gmm_design(dtype, k: int, n: int) -> str:
    """Which kernel of `csrc/grouped_matmul.cu` takes a grouped matmul of
    contraction ``k`` and width ``n`` on the card: ``"wgmma"`` for bf16 and
    f16 when K and N are multiples of 8 (TMA wants 16-byte strides),
    ``"mma.sync"`` for the other bf16 / f16 shapes, ``"cuda_cores"`` for
    f32."""
    if dtype in (torch.bfloat16, torch.float16):
        return "wgmma" if k % 8 == 0 and n % 8 == 0 else "mma.sync"
    return "cuda_cores"


def _gmm_cuda(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes,
              trans: bool, _design=None) -> torch.Tensor:
    """Launch `csrc/grouped_matmul.cu` (its work-list kernel, then the
    matmul) in the design of `gmm_design`, unless ``_design`` names one
    (private: it lets a caller run another design at the same shape). An
    input the named design cannot take raises before any launch."""
    if lhs.dtype not in _DTYPES:
        raise TypeError(f"grouped matmul kernel takes float32, bfloat16 or "
                        f"float16, got {lhs.dtype}")
    if rhs.dtype != lhs.dtype:
        raise TypeError(f"grouped matmul kernel wants lhs and rhs of one "
                        f"dtype, got {lhs.dtype} and {rhs.dtype}")
    if lhs.ndim != 2 or rhs.ndim != 3:
        raise ValueError(f"want lhs (M, K) and rhs (E, K, N); got "
                         f"{tuple(lhs.shape)} and {tuple(rhs.shape)}")
    m, k = lhs.shape
    e = rhs.shape[0]
    kr, n = (rhs.shape[2], rhs.shape[1]) if trans else rhs.shape[1:]
    if kr != k:
        raise ValueError(f"contraction mismatch: lhs {tuple(lhs.shape)}, "
                         f"rhs {tuple(rhs.shape)}, trans={trans}")
    gs = torch.as_tensor(group_sizes)
    if gs.shape != (e,):
        raise ValueError(f"want group_sizes ({e},), got {tuple(gs.shape)}")
    design = _design or gmm_design(lhs.dtype, k, n)
    takes = {"wgmma": gmm_design(lhs.dtype, k, n) == "wgmma",
             "mma.sync": lhs.dtype != torch.float32,
             "cuda_cores": lhs.dtype == torch.float32}
    if design not in takes:
        raise ValueError(f"no grouped matmul design {design!r}")
    if not takes[design]:
        raise ValueError(f"the {design} grouped matmul does not take "
                         f"{lhs.dtype} with K {k}, N {n}")
    if not (lhs.is_cuda and rhs.device == lhs.device):
        raise ValueError("grouped matmul kernel wants lhs and rhs on one "
                         "CUDA device")
    if not (lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("grouped matmul kernel wants contiguous lhs and "
                         "rhs")
    if design == "wgmma":
        # TMA reads from 16-byte aligned bases (a copy only when a view is
        # not)
        lhs, rhs = (t if t.data_ptr() % 16 == 0 else t.clone()
                    for t in (lhs, rhs))
    gs = gs.to(lhs.device, torch.int32).contiguous()
    from ._build import kernel_fn
    out = torch.empty(m, n, dtype=lhs.dtype, device=lhs.device)
    wmax = -(-m // _TILE_M[lhs.dtype]) + e
    work = torch.empty(4 * wmax, dtype=torch.int32, device=lhs.device)
    stream = torch.cuda.current_stream(lhs.device).cuda_stream
    args = [lhs.data_ptr(), rhs.data_ptr(), gs.data_ptr(), work.data_ptr(),
            out.data_ptr(), m, k, n, e, int(trans), _DTYPES[lhs.dtype]]
    symbol = ("pdt_grouped_matmul_sm90" if design == "wgmma"
              else "pdt_grouped_matmul")
    fn = kernel_fn("grouped_matmul", symbol, _ARGTYPES)
    with torch.cuda.device(lhs.device):
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"grouped matmul kernel launch failed: CUDA "
                           f"error {err}")
    launch_counts["grouped_matmul"] += 1
    return out


def gmm(lhs, rhs, group_sizes, trans=False, use_kernel=None, _design=None):
    """The grouped matmul without autograd: the kernel for a CUDA
    ``lhs``, `gmm_plain` for a CPU one (``use_kernel`` as in
    `ops.kernel_route`; ``_design`` as in `_gmm_cuda`)."""
    if kernel_route(lhs, use_kernel):
        return _gmm_cuda(lhs, rhs, group_sizes, trans, _design)
    return gmm_plain(lhs, rhs, group_sizes, trans)


def drhs_plain(lhs: torch.Tensor, dout: torch.Tensor, group_sizes,
               num_groups: int) -> torch.Tensor:
    """d(rhs)[e] = lhs_eᵀ · dout_e over each group's rows (an empty
    group's is zero), (E, K, N) in the result dtype: one `torch.mm` per
    non-empty group (≙ the transpose rule of `ragged_dot`)."""
    m, k = lhs.shape
    out = torch.zeros(num_groups, k, dout.shape[1], dtype=lhs.dtype,
                      device=lhs.device)
    start = 0
    for e, s in enumerate(_sizes(group_sizes)):
        end = min(m, start + max(s, 0))
        if end > start:
            torch.mm(lhs[start:end].T, dout[start:end], out=out[e])
        start = end
    return out


class _GmmFn(torch.autograd.Function):
    """≙ the `grouped_matmul_values` custom VJP: forward and d(lhs) by
    the kernel (or the plain version on the CPU), d(rhs) by `drhs_plain`.
    ``group_sizes`` gets no gradient."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, use_kernel):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        ctx.use_kernel = use_kernel
        return gmm(lhs, rhs, group_sizes, False, use_kernel)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        dout = dout.contiguous().to(lhs.dtype)
        dlhs = drhs = None
        if ctx.needs_input_grad[0]:
            dlhs = gmm(dout, rhs, group_sizes, True, ctx.use_kernel)
        if ctx.needs_input_grad[1]:
            drhs = drhs_plain(lhs, dout, group_sizes, rhs.shape[0]) \
                .to(rhs.dtype)
        return dlhs, drhs, None, None


def grouped_matmul_values(lhs: torch.Tensor, rhs: torch.Tensor,
                          group_sizes, use_kernel=None) -> torch.Tensor:
    """``lhs`` (M, K) with rows sorted by group; ``rhs`` (E, K, N);
    ``group_sizes`` (E,) integer (a tensor on ``lhs``'s device keeps the
    kernel's launches free of host waits). Returns (M, N) in the dtype of
    ``lhs`` (``rhs`` is cast to it first, as `_gmm_fwd` does), rows past
    the last group zero. Differentiable in ``lhs`` and ``rhs``."""
    rhs = rhs.to(lhs.dtype)
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return _GmmFn.apply(lhs.contiguous(), rhs.contiguous(),
                            torch.as_tensor(group_sizes, device=lhs.device),
                            use_kernel)
    return gmm(lhs.contiguous(), rhs.contiguous(), group_sizes, False,
               use_kernel)
