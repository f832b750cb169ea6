"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`'s serving path.

The package serves greedy Llama requests through a port of
`ContinuousBatchingEngine` (ragged paged admission + decode, or the
legacy paged path; quantized weights and KV pages; batched multi-LoRA;
checkpoint swaps through the fleet model store) on an NVIDIA Hopper
card. The Pallas kernels on those paths are hand-written CUDA C++
kernels here (`csrc/`), each beside a plain PyTorch version of the same
function:

* `ops.ragged_paged_attention` — ragged paged attention (full-width and
  int8 pages);
* `ops.norm_kernels` — RMSNorm forward;
* `ops.quant_matmul` — the int8/fp8 dequant matmul;
* `ops.lora_epilogue` — the BGMV per-token LoRA delta;
* `ops.paged_attention` — q = 1 paged decode attention.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper takes its plain version.
The JAX package `paddle_tpu` is the reference this package is held
against; nothing here imports it or JAX.
"""

__version__ = "0.1.0"
