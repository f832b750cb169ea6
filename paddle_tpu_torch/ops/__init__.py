"""Device resolution and kernel launch counts shared by every op module.

≙ `paddle_tpu/ops/__init__.py` (`on_tpu`): there the platform decides
between a Pallas kernel and its XLA fallback. Here the tensor decides:
a wrapper launches its CUDA kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor — never one in place of the other. A
CUDA input a kernel cannot take raises.
"""
from __future__ import annotations

import math

import torch

# one count per hand-written kernel, bumped by its wrapper exactly where
# it launches the kernel (never by the plain version), so a run can show
# that its path went through the kernels
launch_counts = {"rms_norm": 0, "ragged_paged_attention": 0,
                 "ragged_paged_attention_int8kv": 0, "dequant_matmul": 0,
                 "lora_epilogue": 0, "paged_attention": 0,
                 "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkv": 0, "rms_norm_bwd": 0,
                 "grouped_matmul": 0, "layer_norm": 0, "layer_norm_bwd": 0,
                 "flash_varlen_fwd": 0, "flash_varlen_bwd_dq": 0,
                 "flash_varlen_bwd_dkv": 0, "flash_varlen_plan": 0,
                 "rope": 0,
                 # not kernels: CUDA inputs past the kernels' head dims,
                 # sent to the counterparts of the reference's XLA
                 # branches
                 "flash_attention_xla": 0, "flash_varlen_xla": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds on: ``device`` when the caller
    names one, else the CUDA card. Without CUDA and without an explicit
    device this raises — the port never falls back to the CPU on its
    own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return torch.device("cuda")


def kernel_errors(out, ref) -> tuple[float, float]:
    """How far a kernel's output lies from its plain version, scale-free:
    ``(rel, row)``. ``rel`` is ||out - ref|| / ||ref|| over the whole
    tensor. ``row`` is the worst row (a vector along the last axis: one
    head of one q row of attention, one output row of a grouped matmul or
    a norm): ||out_r - ref_r|| over the larger of ||ref_r|| and 2^-6 of
    the tensor's RMS row norm, so that a row whose true value cancels to
    about 0 (dq of a row with one live key, a zero row past the last
    group) is held to a small absolute limit instead. Rows equal in both
    count 0; a non-finite output gives nan, which no limit passes."""
    a, r = out.float(), ref.float()
    diff = (a - r).norm(dim=-1)
    rn = r.norm(dim=-1)
    err, total = float(diff.norm()), float(r.norm())
    rel = err / total if total > 0 else (0.0 if err == 0 else math.inf)
    floor = 2 ** -6 * rn.square().mean().sqrt()
    row = torch.where(diff == 0, 0.0, diff / torch.maximum(rn, floor))
    return rel, float(row.max())


def kernel_route(x: torch.Tensor, use_kernel) -> bool:
    """Whether a wrapper launches its kernel for tensor `x`.

    ``use_kernel`` None routes by the tensor's device; True demands the
    kernel and raises for a CPU tensor (there is no CPU build); False
    runs the plain version on either device."""
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError("the CUDA kernel needs CUDA tensors; got a "
                         f"tensor on {x.device}")
    return bool(use_kernel)
