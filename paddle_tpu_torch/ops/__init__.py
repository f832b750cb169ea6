"""Device resolution and kernel launch counts shared by every op module.

≙ `paddle_tpu/ops/__init__.py` (`on_tpu`): there the platform decides
between a Pallas kernel and its XLA fallback. Here the tensor decides:
a wrapper launches its CUDA kernel for a CUDA tensor and runs the plain
PyTorch version for a CPU tensor — never one in place of the other.
"""
from __future__ import annotations

import torch

# one count per hand-written kernel, bumped by its wrapper exactly where
# it launches the kernel (never by the plain version), so a run can show
# that its path went through the kernels
launch_counts = {"rms_norm": 0, "ragged_paged_attention": 0,
                 "ragged_paged_attention_int8kv": 0, "dequant_matmul": 0,
                 "lora_epilogue": 0, "paged_attention": 0,
                 "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkv": 0, "rms_norm_bwd": 0}


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
