"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`.

The package serves greedy Llama requests through a port of
`ContinuousBatchingEngine` (ragged paged admission + decode, or the
legacy paged path; quantized weights and KV pages; batched multi-LoRA;
checkpoint swaps through the fleet model store), and trains Llama, MoE
(Qwen2-MoE shape, capacity or dropless) and BERT masked-LM models
(`TrainStep`, `AdamW`, the recipes), and offers the packed (varlen)
attention, fused rope and fused-layer surface of the public API
(`nn.functional.flash_attn_unpadded`, `incubate.nn`), on an NVIDIA
Hopper card. Every Pallas kernel of the JAX package is a hand-written
CUDA C++ kernel here (`csrc/`), each beside a plain PyTorch version of
the same function:

* `ops.ragged_paged_attention` — ragged paged attention (full-width and
  int8 pages);
* `ops.norm_kernels` — RMSNorm and LayerNorm, forward and backward;
* `ops.quant_matmul` — the int8/fp8 dequant matmul;
* `ops.lora_epilogue` — the BGMV per-token LoRA delta;
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

__version__ = "0.1.0"
