"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`.

The package serves greedy Llama requests through a port of
`ContinuousBatchingEngine` (ragged paged admission + decode, or the
legacy paged path; quantized weights and KV pages; batched multi-LoRA;
checkpoint swaps through the fleet model store; on the card each
dispatch replays as a CUDA graph), and trains Llama, MoE
(Qwen2-MoE shape, capacity or dropless) and BERT masked-LM models
(`TrainStep`, every optimizer and scheduler of the JAX package, the
recipes; activation recompute; `io.DataLoader` with shared-memory
workers over the host library of ``csrc/native.cc``, file token sources
and tokenizers in `text`), saves and resumes that training
(`save` / `load`, `distributed.checkpoint` with its integrity manifests,
`distributed.fleet.elastic.ElasticManager`), and offers the packed (varlen)
attention, fused rope and fused-layer surface of the public API
(`nn.functional.flash_attn_unpadded`, `incubate.nn`), on an NVIDIA
Hopper card. Every Pallas kernel of the JAX package is a hand-written
CUDA C++ kernel here (`csrc/`), each beside a plain PyTorch version of
the same function:

* `ops.ragged_paged_attention` — ragged paged attention (full-width and
  int8 pages);
* `ops.norm_kernels` — RMSNorm and LayerNorm, forward and backward;
* `ops.quant_matmul` — the int8/fp8 dequant matmul;
* `ops.lora_epilogue` — the per-token LoRA delta (SGMV for bf16 and
  f16 up to rank 64, BGMV for f32 and larger ranks);
* `ops.paged_attention` — q = 1 paged decode attention;
* `ops.flash_attention` — flash attention forward, dQ and dK/dV;
* `ops.flash_varlen` — the same under a segment-id mask (packed
  sequences);
* `ops.rope` — rotary position embedding, forward and backward;
* `ops.grouped_matmul` — the MoE experts' grouped matmul (forward and
  the backward's d(lhs)).

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper takes its plain version;
on the card a wrapper launches its kernel, or raises for an input the
kernel cannot take.
The JAX package `paddle_tpu` is the reference this package is held
against; nothing here imports it or JAX.
"""

from .framework.io import load, save  # noqa: F401

__version__ = "0.1.0"
