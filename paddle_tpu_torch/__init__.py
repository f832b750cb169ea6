"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`'s serving path.

The package serves greedy Llama requests through a port of
`ContinuousBatchingEngine` (ragged paged admission + decode) on an
NVIDIA Hopper card. The two Pallas kernels on that path are hand-written
CUDA C++ kernels here (`csrc/`), each beside a plain PyTorch version of
the same function:

* `ops.ragged_paged_attention` — ragged paged attention;
* `ops.norm_kernels` — RMSNorm forward.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``), where every kernel wrapper takes its plain version.
The JAX package `paddle_tpu` is the reference this package is held
against; nothing here imports it or JAX.
"""

__version__ = "0.1.0"
