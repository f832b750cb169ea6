#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`paddle_tpu_torch`) on one card.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` (``$CUDA_HOME`` or /usr/local/cuda) and the
repository beside this file; it exits non-zero without them and prints
no result. Phases, in order (any failure raises):

1. the card's ``nvidia-smi`` name and power limit;
2. build every kernel of `paddle_tpu_torch/csrc/` (one ``nvcc`` per
   source, in parallel, into ``build/paddle_tpu_torch/``);
3. hold each kernel against its plain PyTorch version on the card, in
   bf16 and f32, at the serving path's shapes (ragged attention over a
   decode batch of 8 slots with contexts 1..2048, a mixed admission
   batch, and a windowed batch: both designs, ``ra.DESIGNS``, the
   "split" one that every path runs bitwise on repeat and launched once
   by the entry, its tickets left zero, timed in turns
   with the "serial" one and a copy of the case's live pages by
   ``timed_in_turns`` below), with each one's time and its bound; the
   RMSNorm forward's two designs (`nk.norm_design`: the
   row in registers, and a block a row) at every main path's shape (a
   decode step's 8 rows and an admission batch at 4096, bf16 and f32;
   the 8B-width, bench and A14B-width training rows in bf16), with a
   planted fault (rstd without eps), timed in turns with
   ``torch.nn.functional.rms_norm`` three ways: ``ms`` (one call between
   two events, the wrapper's host time included), ``device_ms`` (CUDA
   graphs of 20 launches, inputs rotated over sets past 150 MB so none
   comes from the L2) and ``host_us`` (200 calls back to back on the
   host clock);
4. a tiny Llama served on the card and on the CPU gives equal greedy
   streams;
5. serve 16 seeded requests on `LlamaConfig.llama3_8b()` at full width
   and depth in bf16 through `ContinuousBatchingEngine`, with the
   kernels' launch counts set to 0 before the run and read after it;
   then 10 decode steps of a second engine on the same model under
   ``torch.profiler`` (`tools.profile_decode.profile_engine`): the
   split attention's device ms a decode step beside the run's decode
   step ms, decode tokens/s and TTFT p50 (``serving {...}``);
6. one admission dispatch of the 8B model through the kernels and
   through the plain versions (``use_kernel=True`` / ``False``).

Pipelined decode and the prefix cache add, in the same run (after 6):

5l. ``serve_8b_pipelined``: the 16 requests of 5 at ``harvest_every=4``
    (the sampled tokens stay on the card and feed the next dispatch, one
    copy to the host a window): greedy streams bitwise equal to 5's,
    launch counts by 5's formula; then k = 1 and k = 4 again in turns
    (1, 4, 4, 1), every run's streams equal; one full window of 4 decode
    dispatches of another engine under
    ``torch.cuda.set_sync_debug_mode("error")``
    (any synchronizing call fails the run); decode step ms, decode
    tokens/s and TTFT p50 of every run (``serving_k1`` /
    ``serving_k4``), and `tools.profile_decode.profile_engine`'s step ms,
    device ms a step and idle share over 12 decode steps at k = 1 and
    k = 4 (``serving_pipelined {...}``);
5m. ``serve_8b_prefix``: a seeded 512-token prefix (32 pages, the
    default ``max_prefix_entries``) with seeded suffixes of 32-512
    tokens; one warm request, then 8 more, on an engine with
    ``enable_prefix_caching=True`` and on one without: exactly 8 hits
    reusing 4096 tokens, 4096 fewer admission tokens, launch counts by
    5's formula, the hit round's admission logits (one dispatch, a row a
    request) within a tenth of `path_check`'s bound of the uncached
    engine's (max |diff| <= 0.01 x max |logit|) and with equal argmax on
    every row, while one planted wrong shared page (a hit slot's block
    table pointing one prefix page at the trash page) must break that
    check; equal streams counted and where the
    others first part, TTFT p50 and admission tokens/s of both
    (``serving_prefix {...}``), and every page free once the trie is
    drained.

The engine's program cache as CUDA graphs (the default on the card;
``_graphs=False`` is the eager yardstick) adds, in the same run:

5n. ``serve_8b_graphs``: the 16 requests of 5 on eager and graphed
    engines in turns (eager, graphed, graphed, eager) at k = 1 and at
    k = 4, every run's streams bitwise equal to 5's and its launch
    counts exact by 5's formula (a replay adds the counts its capture
    recorded); a window of 4 graphed decode dispatches under
    ``set_sync_debug_mode("error")``; every run's decode step ms, host
    us a step (the dispatch walls without the token copies), TTFT p50,
    captures, capture seconds and peak memory (``serving_graphs_k1`` /
    ``serving_graphs_k4``), and `profile_engine`'s step ms, device ms a
    step and idle share, eager and graphed in turns at both k
    (``serving_graphs {...}``). Phases 5b, 5c, 5d and 5m run graphed and
    each holds its streams bitwise to an eager engine's on the same
    requests; phases 6, 6b and 6c replay their kernel forward once as a
    captured graph, bitwise equal to the eager kernel forward. The
    tiny card-against-CPU parities that record every dispatch's logits
    (4b, 4c) run eager: the record reads the card inside the forward,
    which a capture cannot hold.

Quantized serving adds, in the same run:

3b. the dequant matmul kernel against its plain version at the serving
    shapes (decode (8, 4096)->14336, (8, 14336)->4096, (8, 4096)->128256
    and the first admission batch's (t_adm, 4096)->14336), int8 and fp8
    storage, bf16 activations, the decode and admission gate/up in f16
    too (an output rounded through bf16 must break f16's limits), plus
    one small f32 case: error, ms (at the first two decode shapes also
    device_ms and host_us, in turns with the bf16 ``F.linear``, weights
    rotated past the L2; at the admission gate/up the wgmma design, the
    parent's mma.sync design and ``F.linear`` so), bound, plain ms, ``library_ms`` (``torch._weight_int8pack_mm`` for
    int8 where the installed torch runs it on CUDA, else null with the
    reason) and ``bf16_linear_ms``, the full-width ``F.linear`` the
    quantized path has to beat;
3c. the int8-KV branch of ragged attention on the four attention cases
    of phase 3, over int8 pools and scales written by
    `ragged_scatter_quantized`, bf16 q, both designs as in phase 3;
4b. a tiny f32 Llama under ``QuantServingConfig(weights="int8" / "fp8",
    kv="int8")`` served on the card and on the CPU: equal greedy streams
    and every dispatch's logits within a stated budget (after a
    divergence, the logits up to it, over at least 3 dispatches);
5b. the 16 requests again with ``quant=QuantServingConfig("int8",
    "int8")`` on the same bf16 model object (exact launch counts: 225
    dequant matmuls, 32 int8-KV attentions, 65 RMSNorms per dispatch and
    no full-width attention), then 4 of them with ``weights="fp8"``;
6b. one admission dispatch with the quantized weights and int8 pools,
    kernels against plain versions, as in phase 6.

Multi-LoRA serving and the legacy paged path add, in the same run:

3d. the LoRA epilogue kernel against its plain version in bf16 at
    the 8B decode shapes (8 tokens; q/o 4096->4096, k/v 4096->1024,
    gate/up 4096->14336, down 14336->4096), at the first admission
    batch's (t_adm, 4096)->14336 with ids mixing rows 0..3 and with the
    batch's own segmented ids, and one small f32 case, rank 16: error,
    ms (in bf16 also device_ms, SGMV and the parent's BGMV in turns over
    adapter stacks rotated past the L2, and host_us at decode), bound,
    plain ms and ``bmm_ref_ms``
    (the gather plus two ``torch.bmm``, a labelled yardstick: no single
    PyTorch call computes the function, so ``library_ms`` is null); and
    bitwise on the card: row-0 tokens give exact zeros, a token's delta
    alone equals its delta inside the batch of 8 and of t_adm;
3e. the q = 1 paged attention kernel's two designs against its plain
    version on the decode case of phase 3 (8 slots, contexts 1..2048)
    in bf16 and f32 and windowed (w=256) in bf16, as in phase 3: ms,
    device_ms, host_us, bound, plain ms, a copy of the live pages and
    ``ragged_bq1_ms`` / ``ragged_bq1_device_ms``, the ragged split
    design at block_q = 1 on the same pages (the same work);
4c. a tiny f32 Llama with two adapters (plus base requests) served on
    the card and on the CPU: equal greedy streams and every dispatch's
    logits within a stated budget, full width and over an int8 base
    (``QuantServingConfig("int8", None)``); whether the mixed engine's
    streams equal dedicated engines' on the card is printed, not
    asserted (cuBLAS may pick another algorithm for another batch);
4d. a tiny f32 Llama under ``attention_impl="legacy"``, card against
    CPU: equal greedy streams, and equal to the ragged engine's on the
    card;
5c. ``serving_lora {...}``: the 16 requests on the same bf16 8B model
    object, round-robin over the base and three seeded rank-16 adapters
    on all seven matmuls of every layer, installed through a
    `FleetModelStore` (exact launch counts per dispatch: 7L LoRA
    epilogues, L ragged attentions, 2L+1 RMSNorms, no paged attention);
5d. ``serving_legacy {...}``: the first 8 requests under
    ``attention_impl="legacy"`` (exact counts: L paged attentions per
    decode dispatch, 2L+1 RMSNorms per dispatch, no ragged attention and
    no LoRA epilogue);
6c. one admission dispatch with the LoRA weights (three sequences under
    three adapters), kernels against plain versions, as in phase 6.

Training adds, in the same run:

3f. the flash attention kernels (forward: o and lse; backward: dQ and
    dK/dV) against their plain versions in bf16 at the 8B training
    slice's shape (B=2, S=2048, H=32, HK=8, D=128) and at the ``bench``
    recipe's (B=8, S=2048, H=16, HK=8, D=64), with each one's time,
    bound, plain time and the library's
    (``torch.nn.functional.scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)`` forward, and its backward), and on small edge
    cases: tail tiles (S=1000), Sq < Sk, Sq > Sk (rows with no key give
    exact zeros and zero gradient), a 256 window, non-causal, f32, D=32;
    each output held to scale-free limits (the whole tensor's and the
    worst row's relative error), which two planted faults of the plain
    version must break: a skipped K tile and a wrong GQA head;
3g. the RMSNorm backward's designs (`ops.norm_kernels.norm_bwd_design`:
    the register-row backward and the rowblock one) against the plain
    version (torch autograd of `rms_norm_ref`) at the main paths'
    shapes, (4096, 4096), (16384, 1024) and (4096, 3584) bf16, beside
    (4096, 4096) f32 and a ragged row count: dw bitwise on a repeat,
    then timed in turns with the library's one backward call
    (``aten._fused_rms_norm_backward``) and ``x + g`` (the same bytes)
    as the forwards are (device_ms, host_us, ms), one call's device time
    split into its two kernels by `torch.profiler`, and the registers
    instance's ptxas registers and spills (a spill fails the run);
4e. ``tiny_train_parity``: a tiny f32 Llama (D=32, GQA 4:2) on the card
    (kernels) and on the CPU (plain versions), same weights, three
    `TrainStep`s with `AdamW`: losses per step and parameters after
    step 3 within a stated budget, and ``accumulate_steps=2`` against 1
    on the card;
5e. ``train_8b_width {...}``: `recipes.llama_pretrain.train_8b_config()`,
    `LlamaConfig.llama3_8b()` cut to 4 decoder layers (full-depth AdamW
    state does not fit one card), bf16, ``AdamW(lr=3e-4,
    weight_decay=0.01, multi_precision=True)``, B=2, S=2048, one seeded
    batch, 5 steps: step ms, tokens/s, MFU (with and without the input
    embedding), peak memory, the losses (which must fall), exact
    launches per step (L of each flash kernel, 2L+1 RMSNorms and RMSNorm
    backwards); before it, one forward and backward with the kernels
    and one with the plain versions (``use_kernel=False``) on the same
    weights: the loss difference and named parameters' relative gradient
    differences against their budgets, and the same readings of the
    plain versions under a planted fault, which the gradients' budget
    must catch;
5e'. ``train_8b_resume {...}``: the training state of 5e's model moved
    to the disk and back mid-run. The free space of the temp directory
    first; then N = 6 AdamW steps uninterrupted (losses and final
    parameters kept on the host, exact launches), a second uninterrupted
    run (the noise yardstick), and a run of k = 3 steps, a checkpoint
    through `ElasticManager.save` (bf16 weights, f32 master, m and v:
    ~26.9 GB), the model and optimizer freed, fresh ones from another
    seed, `ElasticManager.resume` (verify with rehash, then load) and the
    other 3 steps: checkpoint bytes, save / verify / load seconds and
    GB/s, peak memory, the loaded state's sha256 against the manifest
    (must be equal), the resumed losses and parameters against the
    uninterrupted run and the yardstick against it, and which kernels
    give other bits on a second call with the same inputs; then the
    resume drill of `recipes.llama_pretrain` on a tiny model on the
    card and `paddle_tpu_torch.save` / `load` of card tensors, bitwise;
5f. ``train_recipe {...}``: the ported recipe in-process, ``--size bench
    --bf16 --batch-size 8 --seq-len 2048 --steps 5``: step ms, tokens/s,
    MFU (with and without the input embedding).
5h. ``train_8b_recompute {...}``: activation recompute on 5e's model and
    batch (`train_8b_config()`, B=2, S=2048, bf16). One forward and
    backward from the same weights without recompute, under policy
    "full" and under "dots_with_no_batch_dims": the loss and every
    gradient bitwise equal, and each one's peak above the weights; a
    planted fault (`_skip_tile` in the flash forward of the backward's
    recompute only) must change gradients past 5e's budget. Then 3
    AdamW steps (master weights) without and with recompute from the
    same weights: losses and every parameter bitwise equal (else the
    first tensor that differs, held to 5e's budgets), step ms, the peak
    up to each AdamW update (recompute's must be lower) and over whole
    steps (AdamW's temporaries set it; recompute's no higher), and exact
    launches a step (with
    recompute 2L flash forwards and 4L + 1 RMSNorm forwards; the Llama
    training path rotates with plain PyTorch, so rope launches none).
    Then ``train_recipe_recompute_data {...}``: the recipe with
    ``--size bench --bf16 --recompute --data tokens.bin --batch-size 8
    --seq-len 2048 --steps 5``, the file `encode_file` of the repo's
    README.md and docs/*.md (`ByteTokenizer`): step ms, tokens/s, MFU
    (the model's flops, not the recomputed ones) and peak beside 5f's;
    ``data_loader {...}``: that file's `LMBlockDataset` through
    `io.DataLoader` with 4 shared-memory workers (forked from this
    process, which holds a CUDA context) and inline, in turns: equal
    batches and batches/s of both; ``bpe {...}``: `BPETokenizer` trained
    at vocab 512 on 64 KB of the text, the native encode against the
    plain one (equal ids on 16 KB) and MB/s of each.

MoE and BERT training add, in the same run (after 5f):

3h. ``ln_phase``: the LayerNorm kernels (forward in both designs, as
    3.; backward in its designs, as 3g) against their plain versions at
    BERT-base's (16384, 768) f32 and at (4096, 3584) bf16, beside
    ``torch.nn.functional.layer_norm`` and
    ``aten.native_layer_norm_backward``; scale-free limits
    (`ops.norm_kernels.LN_LIMITS`) that two planted faults (the forward
    without the mean, dx without its mean(w·g) term) must break; the
    designs and the library timed in turns as in 3.;
4f. ``tiny moe train parity``: the tiny f32 MoE, dropless (the
    grouped-matmul kernel) and capacity, 3 AdamW steps card vs CPU;
4g. ``tiny bert train parity``: the tiny f32 BERT at dropout 0;
5g. ``train_moe_a14b_width {...}``: `recipes.moe_train.
    train_a14b_config()`, Qwen2-MoE-A14B at its published width (hidden
    3584, 28 q / 4 KV heads, 64 experts, top-8, expert FFN 2560, shared
    expert 20480, vocab 151936) cut to 1 of 28 layers, dropless, bf16,
    ``AdamW(multi_precision=True)``, B=1, S=4096, one seeded batch, 5
    steps: a kernels-vs-plain path check with a planted grouped-matmul
    fault beside it, step ms, tokens/s, MFU over the active parameters,
    peak memory, the losses, the grouped matmuls' and d(rhs)'s device ms
    in a step, the drop count (0), exact launches (6 grouped matmuls,
    1/1/1 flash, 3/3 RMSNorm a step); the flash phase has its
    (H=28, HK=4, D=128) case;
3i. ``gmm_phase``: the grouped-matmul kernel against its plain version
    at the A14B expert shapes (gate/up and down, forward and the
    transposed d(lhs) read) on the routed group sizes of 5g's first step
    and on a skewed routing: ms, bound, plain ms, ``library_ms``
    (``torch._grouped_mm`` where this torch has it) and ``mm_loop_ms``
    (a `torch.mm` per expert); scale-free limits
    (`ops.grouped_matmul.GMM_LIMITS`) that two planted faults (a
    skipped last K step, a tile->group map off by one) must break;
5h. ``train_bert_base {...}``: the BERT recipe at ``--size base
    --batch-size 32 --seq-len 512 --steps 5``, f32, dropout as
    configured: exactly 26/26 LayerNorm launches a step and no flash
    (attention dropout takes the plain path, as in JAX);
5i. ``train_moe_small {...}``: the MoE recipe at ``--size small --bf16``
    on the capacity path: no grouped-matmul launch.

Packed attention and rope add, in the same run (after 5i):

3j. ``varlen_phase``: the varlen flash kernels (forward, dQ, dK/dV)
    against their plain versions on packed cases: 4096 tokens at
    Llama-3-8B attention width (H 32, HK 8, D 128) in bf16 and an f32
    one, seeded documents ending in a padding tail (segments off the
    64-row tiles), Sq != Sk (q the suffix of k's packing), one-token
    segments, non-monotone ids, non-causal f16 and DiT's D 72; readings
    held to `ops.flash_attention.KERNEL_LIMITS`, which two planted
    faults must break (the segment mask ignored; the tile-skip test off
    by one tile). Both designs (`fv.varlen_design`: "sm90", wgmma + TMA
    over the segment tile plan, for bf16 / f16 at D 64 and 128;
    "mma.sync" for the rest) where sm90 applies, each record naming its
    ``design``; the plan kernel equal to `fv.varlen_tile_plan`
    (``flash_varlen_plan`` records); the sm90 design bitwise on repeat
    and equal to the wrapper's. Timed at the 4096-token case
    (`_varlen_timed`: device_ms by graphs of 20 launches over inputs
    rotated past the L2, the mma.sync design, the sm90 one in the plan's
    block order, `fv.SM90_ORDER`, and in the other, in turns) with
    ``library_ms`` = PyTorch's one call, `torch.nn.attention.varlen.
    varlen_attn` on the rows flattened with cumulative lengths
    (``library_call``, ``library_torch``), SDPA under an explicit
    block-diagonal causal mask (``masked_sdpa_ms``) and the per-
    document SDPA loop beside it; then the rope kernels (`_rope_phase`),
    forward and backward, both designs (`rp.rope_design`: rope_vec, q and
    k in one launch, and the pair design) bitwise against the plain
    version at the packed pretraining run's q, k and q + k shapes, in
    f32, f16 at D 72 and on a view off 16 bytes (the pair design by
    rule), with three planted faults (a sign error in the backward,
    half-split pairs, trig one position off); rope_vec, the pair design,
    two single rope_vec launches (q + k) and ``clone`` of the same
    tensors (the same bytes read and written) timed in turns at q, k and
    q + k, forward and backward (device_ms, host_us, ms), and ptxas's
    spills (one fails the run);
5j. ``packed_sft_8b {...}``: `F.flash_attn_unpadded` over 16384 packed
    tokens (seeded documents of 64-2048 tokens, a padding tail), bf16,
    causal, forward and backward: exactly 1/1/1 varlen launches and one
    plan launch, and the outputs and dQ/dK/dV within `KERNEL_LIMITS` of
    the same documents run one at a time through the dense flash
    kernels;
5k. ``packed_pretrain_8b {...}``: q/k/v projections, fused rope (theta
    500000), document-masked varlen attention and o_proj at Llama-3-8B
    width on x (2, 8192, 4096) bf16, 5 AdamW steps on a mean-square
    loss: the loss falls; step ms, peak memory, the varlen, plan and
    rope device ms a step; exactly 1/1/1 varlen, 1 plan and 1 + 1 rope
    launches a step (q and k in one launch each way); then both varlen designs on the last step's own
    inputs against the plain versions and timed as in 3j (the
    ``pretrain_8b`` records the kernels line reports).

The flash phase (3f) also holds float16 and head dims from 8 to 256 to
the kernels (72 and 136 zero-padded to tile widths 80 and 160), head
dims 100 (bf16) and 36 (f16), off the 16-byte chunks, and 264 (f32),
past the kernels, through `attention_xla` (exactly one
``flash_attention_xla`` count). The backward of bf16 and f16 at head
dims 64 and 128 runs the wgmma kernels of `csrc/flash_bwd_sm90.cu`: the
phase first counts ``HGMMA`` in their SASS (``sass_hgmma``, by
``cuobjdump -sass``; none is a failure), then holds both backward
designs to the limits (each record names its ``design``; the wgmma one
bitwise equal on repeat) and, at ``slice_8b``, ``bench``,
``slice_8b_f16`` and ``gqa7_a14b``, times them in turns (mma.sync,
wgmma, wgmma, mma.sync) beside ``delta_ms`` (the PyTorch delta),
``whole_bwd_ms`` (delta + dQ + dK/dV as `_flash_bwd` runs it) and SDPA's
backward; 5e, 5f and 5g print ``flash_bwd_ms_per_step``, the flash
backward's device time in a step (CUDA events around `_flash_bwd`).

The forward of bf16 and f16 at head dims 64 and 128 runs the wgmma
kernel of `csrc/flash_fwd_sm90.cu`, and the grouped matmul of bf16 / f16
with K and N multiples of 8 the wgmma kernel of `csrc/grouped_matmul.cu`
(`gm.gmm_design`). ``sass_hgmma`` (before the flash phase) counts
``HGMMA`` in every wgmma kernel function: the forward, dQ, dK/dV and the
grouped matmul. The flash phase holds both forward designs to the limits
(o at `KERNEL_LIMITS`, lse within 1e-3, dead rows exact zeros; the wgmma
one bitwise on repeat), times them in turns beside SDPA's forward and
times the wgmma forward + backward as one pair (``fwd_bwd_ms``) beside
SDPA's (``library_fwd_bwd_ms``); the backward reads the wgmma forward's
lse. ``gmm_phase`` holds both grouped-matmul designs on its five cases,
times them in turns, and checks four more: N off 8 (the mma.sync route),
M off the 128-row tile with a one-row group, and K off the wgmma
kernel's 64-wide k step with rhs read either way. 5e, 5f and 5g also print
``flash_fwd_ms_per_step`` (CUDA events around `_flash_fwd`).

The decode case of 3 also tries `varlen_attn` over the pages
(``block_table=``, ``seqused_k=``) as the paged attention's one-call
library (``paged_library``: its time, or its refusal in its own words).

Telemetry, fault points and attribution add, after the spec and
sampling phases, on the same 8B model:

5t. ``serve_8b_telemetry``: the 16 requests of 5 graphed at k = 1 with
    telemetry off and on in turns (off, on, on, off), every run's
    streams bitwise equal to 5's and its launches exact by 5's formula,
    each run's decode step ms, host us a step and TTFT p50; the
    decode-round decomposition's components (`observability.profile`)
    summed against the steps' measured wall; a graphed window of 4
    decode dispatches under ``set_sync_debug_mode("error")`` with
    telemetry on; `profile_round()` on a graphed engine mid-run (the top
    gap pairs, the launches of its two eager passes counted, the streams
    afterwards bitwise equal to 5's); the drills at full width:
    ``serving.prefill`` at its 3rd visit fails exactly one request and
    the other 15 streams equal 5's, ``serving.decode`` once is retried
    with equal streams, ``decode_retries`` 1, no recapture and exact
    launches, ``serving.decode`` always raises after
    ``max_decode_retries`` + 1 faults, and the 1B-draft spec engine with
    ``speculative.verify`` always armed degrades every round and fails
    no request (streams equal 5's); ``serving.alloc_page`` at the first
    page of the first legacy admission of 5d's 8 requests, after its
    prefill ran: that request fails alone and the other 7 streams equal
    5d's (``drill_legacy_alloc``); the Prometheus text parsed back by
    ``parse_prometheus`` (``telemetry {...}``).

KV page transfer adds, after 5t, on the same 8B model:

5u. ``serve_8b_migrate``: the 16 requests of 5 on a graphed source
    engine at k = 1, every even one moved at its 4th token to a second
    graphed engine on the card (`serving.transfer.migrate_request`:
    export with its sha256 manifest, verify, the install program), both
    run to the end: 16 streams equal to 5's, or each first parting at a
    near-tie of the plain engine's logits (`plain_gaps`, NEAR_TIE), the
    launches exact over both engines' dispatches,
    ``pdt_transfer_bytes_total`` equal to the payloads' summed bytes;
    a ``migrate {...}`` line a move: pages, payload MiB, export ms (the
    gather, one copy to pinned host memory, the manifest), manifest ms,
    verify ms, install ms (one pinned copy to the staging buffer and the
    install program), the whole move's ms, and the install program's
    warm-up, capture or replay; the drills: ``transfer.serialize`` and
    ``transfer.install`` faults at requests 0 and 2 (each stays on its
    source, both engines' invariants hold, the move then succeeds), a
    payload of request 1 damaged after its manifest (refused at
    ``stage="verify"``; request 1 decodes on at its source to 5's
    stream); then the first 8 requests on int8-KV engines (5b's
    ``QuantServingConfig("int8", "int8")``) with the 4 even ones moved:
    streams bitwise equal to 5b's, and the bytes a page int8 over bf16
    exactly (2 x 16 KiB + 2 x 64 B) / (2 x 32 KiB) = 0.50195; then 5m's
    warm request serialized at its 4th token and spilled into a
    `FleetPrefixStore`, the hit prompt's 32-page chain fetched and
    installed by `import_prefix` into a fresh engine: the 8 hit requests
    hit (4096 tokens reused) with 5m's cached streams; the peak memory
    (``serving_migrate {...}``).

It prints a ``{"kernels": [...]}`` line (eighteen kernels, each with
its launches on its own main-path run, and device_ms / host_us where the
phase measured them), the card line, and last ``{"ok": true, "device":
{...}}``.
"""
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
START = time.perf_counter()

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# operations/s by input type
HBM_BPS = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# one bf16 ulp relative (8 significant bits); f32 sums in another order
TOL = {"bfloat16": dict(rtol=2 ** -7, atol=1e-3),
       "float32": dict(rtol=1e-5, atol=1e-5)}
# attention: the kernel keeps softmax weights in f32, the plain version
# rounds them to the cache dtype before the weighted sum (as the JAX
# core does), so bf16 outputs differ by a few bf16 ulps
ATTN_ATOL = {"bfloat16": 2e-2, "float32": 1e-4}
N_REQUESTS = 16
N_FP8_REQUESTS = 4
LLAMA_VOCAB = 128256      # LlamaConfig.llama3_8b().vocab_size
# dequant matmul against its plain version: the widened weights and
# their products with bf16 x are exact in f32, so the two differ by the
# order of the f32 sums and one final bf16 rounding (bf16: one bf16 ulp
# relative plus 2^-8 of the largest |output|); f32: sums in another order
DQ_TOL = {"bfloat16": (2 ** -7, 2 ** -8), "float32": (1e-5, 1e-5),
          # f16 x: the widened weights and their products are exact in f32
          # as with bf16, and the one final rounding to f16 keeps 3 more
          # significant bits than bf16's: the same limits 8x tighter (one
          # f16 ulp relative plus 2^-11 of the largest |output|), which an
          # output rounded through bf16 breaks (`dq_phase` checks that)
          "float16": (2 ** -10, 2 ** -11)}
# tiny quantized Llama, card against CPU: logits of f32 sums in another
# order, and an int8 K/V element on a lattice midpoint may round one
# step apart (one such step moved the CPU port's logits 7.2e-4 from
# JAX's, tests/test_torch_quant_serving.py)
TINY_QUANT_LOGIT_BUDGET = 5e-3
# tiny f32 Llama with adapters, card against CPU: f32 sums in another
# order through every matmul, attention and epilogue (measured well
# below this on the quantized runs, whose budget covers int8 steps too)
TINY_LORA_LOGIT_BUDGET = 1e-3
N_LEGACY_REQUESTS = 8
LORA_RANK = 16
LORA_ADAPTERS = ("a1", "a2", "a3")
# flash attention, kernel against plain version: scale-free limits on
# the whole tensor's and the worst row's relative error
# (`ops.flash_attention.KERNEL_LIMITS`), shown to catch two planted
# faults of the plain version: every q row skipping the K tile (the
# kernels' 64 keys) that holds its last live key, and q head h reading
# KV head h % HK instead of h // (H / HK)
FLASH_TILE_K = 64
# tiny f32 Llama training, card against CPU: f32 sums in another order
# through every kernel and matmul. Held where that order is all that
# differs: the losses of 3 AdamW steps, and the gradients of the first
# step (each tensor's norm of the difference, relative) before Adam
# normalises them. After Adam the parameters are not: an element whose
# gradient sits at the rounding noise moves by ~lr either way with its
# sign, which the host's CPU kernels decide (one host's CPU side read
# 1.37e-4 in norm, 0.00155 in one element, H100 call). The parameters
# are held card against card (``accumulate_steps=2`` against 1), where
# the same kernels run in the same order
TINY_TRAIN_LOSS_BUDGET = 1e-4
TINY_TRAIN_GRAD_BUDGET = 1e-4
TINY_TRAIN_PARAM_BUDGET = 1e-4
# the planted fault of the gradient check: one parameter's gradient 1%
# off (100x the budget)
TINY_TRAIN_PLANTED_GRAD = "model.layers.1.mlp.down_proj.weight"
# 8B-width bf16 training, kernels against plain versions on the same
# weights: bf16 activations rounded at other places through 4 layers
# (named gradients read 0.6-1.1% apart in norm on the H100). At random
# init the loss is ~ln(vocab) whatever attention computes, so the loss
# budget is a sanity check and the gradients' budget does the work;
# the plain path under `_skip_tile` is the planted fault it must catch
TRAIN_LOSS_REL_BUDGET = 1e-4
TRAIN_GRAD_REL_BUDGET = 3e-2
TRAIN_STEPS = 5
# bench.py:1995-2000 over the H100's bf16 peak
PEAK_BF16 = 989e12
# the training and packed-attention kernels: never launched by a serving
# run
NO_TRAINING = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
               "flash_attention_bwd_dkv": 0, "rms_norm_bwd": 0,
               "grouped_matmul": 0, "layer_norm": 0, "layer_norm_bwd": 0,
               "flash_varlen_fwd": 0, "flash_varlen_bwd_dq": 0,
               "flash_varlen_bwd_dkv": 0, "flash_varlen_plan": 0,
               "rope": 0, "flash_attention_xla": 0, "flash_varlen_xla": 0}


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Median device time of one call, by CUDA events around each."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# device time apart from host time: a call's launches captured
# GRAPH_LAUNCHES to a CUDA graph and the graph replayed between two events
# (the host's wrapper does not run then), the inputs rotating over sets
# whose bytes total more than ROTATE_BYTES, so no launch reads its
# operands from the 50 MB L2; host time: HOST_CALLS calls back to back
# without a synchronise, on the host clock
GRAPH_LAUNCHES = 20
ROTATE_BYTES = 150e6
HOST_CALLS = 200


def rotation_sets(call_bytes):
    """How many input sets to rotate over: their bytes past
    ROTATE_BYTES, and at least two."""
    return max(2, math.ceil(ROTATE_BYTES / call_bytes))


def device_ms(calls, reps=3):
    """Median device ms of one call: ``calls[i]()`` runs the call on the
    i-th input set; graphs of GRAPH_LAUNCHES calls, taking the sets in
    turn, each replayed between two events, time over the count. The
    warm-up calls and the capture share one side stream (a kernel's
    per-stream scratch, such as the split tickets, is made by the
    warm-up, never during the capture)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls[:3]:
            c()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    pool = torch.cuda.graph_pool_handle()
    graphs, keep = [], []
    n_graphs = -(-len(calls) // GRAPH_LAUNCHES)
    for gi in range(n_graphs):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=pool, stream=side):
            keep.append([calls[(gi * GRAPH_LAUNCHES + i) % len(calls)]()
                         for i in range(GRAPH_LAUNCHES)])
        graphs.append(g)
    for g in graphs:
        g.replay()
    events = []
    for _ in range(reps):
        for g in graphs:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            events.append((a, b))
    torch.cuda.synchronize()
    ms = statistics.median(a.elapsed_time(b) for a, b in events)
    del graphs, keep
    torch.cuda.synchronize()
    return ms / GRAPH_LAUNCHES


def host_batch_s(call, n=HOST_CALLS):
    """Host seconds of ``n`` calls back to back without a synchronise
    (the device's queue drained before and after)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t


def timed_in_turns(named, sets_calls, turns=2, reps=7, host=True):
    """``named``: {name: fn(x_set) -> output}; every name's device_ms
    (`device_ms` over the sets, the names in turns A B C, C B A, the mean
    of the turns), and its ms (one call between two events, as
    `time_ms`) and host_us (HOST_CALLS calls back to back on the host
    clock, over the count; None without ``host``), the names interleaved
    rep by rep so that other work on the host's cores falls on all of
    them alike: medians over ``reps`` reps (3 single calls a rep for
    ms)."""
    import torch
    names = list(named)
    got = {k: {"ms": [], "device_ms": [], "host_us": []} for k in names}
    for turn in range(turns):
        for k in (names if turn % 2 == 0 else names[::-1]):
            fn = named[k]
            got[k]["device_ms"].append(device_ms(
                [(lambda s=s: fn(s)) for s in sets_calls]))
    x = sets_calls[0]
    for k in names:
        for _ in range(5):
            named[k](x)
    for rep in range(reps):
        for k in (names if rep % 2 == 0 else names[::-1]):
            fn = named[k]
            torch.cuda.synchronize()
            for _ in range(3):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn(x)
                b.record()
                b.synchronize()
                got[k]["ms"].append(a.elapsed_time(b))
            if host:
                got[k]["host_us"].append(
                    host_batch_s(lambda: fn(x)) / HOST_CALLS * 1e6)
    return {k: dict(ms=statistics.median(r["ms"]),
                    device_ms=statistics.fmean(r["device_ms"]),
                    device_ms_turns=r["device_ms"],
                    host_us=statistics.median(r["host_us"]) if host
                    else None)
            for k, r in got.items()}


# the RMSNorm forward on the main paths (rows, width, dtype): a decode
# step's 8 rows and the first admission batch of the 8B serving runs, the
# 8B-width and bench training runs and the A14B-width MoE cut (B x S rows)
def rms_shapes(t_adm):
    return [("decode", 8, 4096, "bfloat16"),
            ("admission", t_adm, 4096, "bfloat16"),
            ("train_8b_width", 4096, 4096, "bfloat16"),
            ("train_recipe", 16384, 1024, "bfloat16"),
            ("train_moe_a14b_width", 4096, 3584, "bfloat16"),
            ("decode", 8, 4096, "float32"),
            ("admission", t_adm, 4096, "float32")]


def host_parts_us(nk, x, w, eps, reps=7):
    """Where the RMSNorm entry's host time goes at a small shape: host us
    of the bare C entry (the ctypes call and the launch, outputs made
    once), of `torch.empty_like` (the output), and of the whole entry,
    interleaved rep by rep, medians."""
    import torch
    n, h = x.shape
    code = nk._code(x)
    wpr, nv = nk._route(x.dtype, h, x.data_ptr() | w.data_ptr(), None)
    fn = nk.kernel_fn("rms_norm", "pdt_rms_norm_fwd", nk._ARGTYPES)
    o = torch.empty_like(x)
    dev = x.get_device()
    args = (x.data_ptr(), w.data_ptr(), o.data_ptr(), 0, n, h, eps, code,
            wpr, nv, dev, nk.current_stream(dev))
    parts = {"c_entry": lambda: fn(*args),
             "empty_like": lambda: torch.empty_like(x),
             "entry": lambda: nk.rms_norm_values(x, w, eps)}
    got = {k: [] for k in parts}
    for rep in range(reps):
        for k, call in parts.items():
            got[k].append(host_batch_s(call) / HOST_CALLS * 1e6)
    return {k: statistics.median(v) for k, v in got.items()}


def rms_phase(shapes, results):
    """The RMSNorm forward kernel's two designs (`nk.norm_design`: the
    row in registers, and a block a row) against the plain version at
    the main paths' shapes: o within TOL, rstd within rtol 1e-5 of its
    formula, bitwise on repeat, a planted fault (rstd without eps, on
    rows small enough that eps matters) outside TOL, and the entry point
    launching the registers design exactly once. At fewer rows than SMs,
    the entry's host time in parts (`host_parts_us`). Then both designs
    (as the entry runs them without a backward: no rstd stored),
    ``torch.nn.functional.rms_norm``, the entry point (`rms_norm_values`)
    and a copy of x (a yardstick) timed by `timed_in_turns`: ms (one call
    between two events: the wrapper's host time included), device_ms
    (graphs, inputs rotated past the L2) and host_us."""
    import torch
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops import norm_kernels as nk
    lib = torch.nn.functional.rms_norm
    gen = torch.Generator(device="cuda").manual_seed(1)
    eps = 1e-5
    for label, n, h, name in shapes:
        dt = getattr(torch, name)
        isz = torch.empty((), dtype=dt).element_size()
        sets = [torch.randn(n, h, device="cuda", generator=gen).to(dt)
                for _ in range(rotation_sets(2 * n * h * isz))]
        x = sets[0]
        w = (1 + 0.1 * torch.randn(h, device="cuda", generator=gen)).to(dt)
        small = (x.float() * 1e-3).to(dt)
        ref = nk.rms_norm_ref(x, w, eps)
        want_rstd = torch.rsqrt(x.float().square().mean(-1) + eps)
        fault = (small.float() * torch.rsqrt(small.float().square().mean(
            -1, keepdim=True)) * w.float()).to(dt)
        path = nk.norm_design(dt, h)
        designs = ("strided", "registers") if path == "registers" \
            else ("strided",)
        checks = {}
        for d in designs:
            o, rstd = nk._rms_fwd(x, w, eps, _design=d)
            o2, rstd2 = nk._rms_fwd(x, w, eps, _design=d)
            os_, _ = nk._rms_fwd(small, w, eps, _design=d)
            torch.cuda.synchronize()
            checks[d] = dict(
                max_abs_err=(o.float() - ref.float()).abs().max().item(),
                ok=torch.allclose(o.float(), ref.float(), **TOL[name]),
                rstd_ok=torch.allclose(rstd, want_rstd, rtol=1e-5, atol=0),
                bitwise_repeat=bool(torch.equal(o, o2)
                                    and torch.equal(rstd, rstd2)),
                small_ok=torch.allclose(os_.float(), nk.rms_norm_ref(
                    small, w, eps).float(), **TOL[name]),
                planted_fault_rstd_without_eps_caught=not torch.allclose(
                    os_.float(), fault.float(), **TOL[name]))
        before = launch_counts["rms_norm"]
        entry = nk.rms_norm_values(x, w, eps, use_kernel=True)
        torch.cuda.synchronize()
        entry_ok = launch_counts["rms_norm"] == before + 1 and torch.equal(
            entry, nk._rms_fwd(x, w, eps, _design=path)[0])
        # the designs as the entry runs them without a backward: no rstd
        named = {d: (lambda xs, d=d: nk._rms_fwd(xs, w, eps, _design=d,
                                                  stats=False))
                 for d in designs}
        named["library"] = lambda xs: lib(xs, (h,), w, eps)
        named["entry"] = lambda xs: nk.rms_norm_values(xs, w, eps,
                                                       use_kernel=True)
        # a yardstick: the card's own copy of x (read once, written once)
        named["copy"] = lambda xs: xs.clone()
        times = timed_in_turns(named, sets)
        plain = time_ms(lambda: nk.rms_norm_ref(x, w, eps))
        host_parts = host_parts_us(nk, x, w, eps) if n < 132 else None
        # the timed calls store no rstd: x read, o written, w read once
        b_ms, b_by = bound(2 * n * h * isz + h * isz, 4 * n * h, name)
        lt = times["library"]
        for d in designs:
            t = times[d]
            rec = dict(kernel="rms_norm", case=f"rows={n}_h={h}",
                       shape_of=label, N=n, H=h, dtype=name, design=d,
                       path_design=d == path, row_class=nk.row_class(dt, h)
                       if d == "registers" else None, **checks[d],
                       tol=TOL[name], ms=t["ms"], device_ms=t["device_ms"],
                       host_us=t["host_us"], plain_ms=plain, bound_ms=b_ms,
                       bound_by=b_by,
                       bound_fraction=b_ms / t["device_ms"],
                       library_ms=lt["ms"],
                       library_device_ms=lt["device_ms"],
                       library_host_us=lt["host_us"],
                       library_bound_fraction=b_ms / lt["device_ms"],
                       library_note="torch.nn.functional.rms_norm",
                       entry_ms=times["entry"]["ms"],
                       entry_host_us=times["entry"]["host_us"],
                       entry_launches_once=entry_ok,
                       copy_device_ms=times["copy"]["device_ms"],
                       host_parts_us=host_parts, rotation_sets=len(sets))
            log("kernel " + json.dumps(rec))
            results.append(rec)
            if not (rec["ok"] and rec["rstd_ok"] and rec["bitwise_repeat"]
                    and rec["small_ok"] and entry_ok):
                raise AssertionError(f"rms_norm kernel disagrees: {rec}")
            if not rec["planted_fault_rstd_without_eps_caught"]:
                raise AssertionError(f"the RMSNorm tolerance misses the "
                                     f"planted fault: {rec}")
        del sets, x, small, ref, fault
        torch.cuda.empty_cache()


def attn_case(seqs, block_q, tail_pad, dtype, window, gen, int8kv=False,
              heads=(32, 8, 128)):
    """One ragged batch: `seqs` is [(query_len, context_len), ...], over
    ``heads`` (H, HK, D). With ``int8kv`` the pools are int8, every row
    written by `ragged_scatter_quantized`, and their scale pools come
    back too."""
    import torch
    from paddle_tpu_torch.ops.ragged_paged_attention import (
        pack_ragged_starts, ragged_scatter_quantized)
    H, HK, D = heads
    ps = 16
    ql = np.array([s[0] for s in seqs], np.int32)
    cl = np.array([s[1] for s in seqs], np.int32)
    qs, total = pack_ragged_starts(ql, block_q)
    t = total + tail_pad
    need = [-(-int(c) // ps) for c in cl]
    pps = max(need)
    P = sum(need) + 1
    perm = np.random.default_rng(int(t)).permutation(np.arange(1, P))
    bt = np.zeros((len(seqs), pps), np.int32)
    k = 0
    for s, n in enumerate(need):
        bt[s, :n] = perm[k:k + n]
        k += n
    q = torch.randn(t, H, D, device="cuda", generator=gen).to(dtype)
    kp = torch.randn(HK, P, ps, D, device="cuda", generator=gen).to(dtype)
    vp = torch.randn(HK, P, ps, D, device="cuda", generator=gen).to(dtype)
    dev = [torch.from_numpy(a).cuda() for a in (qs, ql, cl, bt)]
    scales = []
    if int8kv:
        n = P * ps
        scales = [torch.zeros(P, ps, device="cuda") for _ in range(2)]
        q8 = [torch.zeros(HK, P, ps, D, dtype=torch.int8, device="cuda")
              for _ in range(2)]
        rows = lambda a: a.permute(1, 2, 0, 3).reshape(n, HK, D)
        ragged_scatter_quantized(
            *q8, *scales, rows(kp), rows(vp),
            torch.arange(P, dtype=torch.int32, device="cuda")[None],
            torch.zeros(n, dtype=torch.int32, device="cuda"),
            torch.arange(n, dtype=torch.int32, device="cuda"))
        kp, vp = q8
    # bytes: q, o, each live K/V page once (int8 pages: one byte a value
    # and one f32 scale a row), descriptors; operations: 2*D for q.k and
    # 2*D for p.v per valid (query head, key) pair
    pages = pairs = 0
    for qlen, ctx in zip(ql, cl):
        if qlen == 0:
            continue
        first = int(ctx) - int(qlen)
        lo = 0 if window is None else max(0, first - window + 1)
        pages += (int(ctx) - 1) // ps - lo // ps + 1
        for p in range(first, int(ctx)):
            pairs += p + 1 if window is None else min(p + 1, window)
    isz = q.element_size()
    page_bytes = 2 * ps * (HK * D + 4) if int8kv else 2 * HK * ps * D * isz
    nbytes = (2 * t * H * D * isz + pages * page_bytes
              + 4 * (3 * len(seqs) + bt.size))
    ops = pairs * H * 4 * D
    return (q, kp, vp, *dev), scales, nbytes, ops


# the decode batch of the serving runs (8 slots, contexts 1..2048) and a
# mixed admission batch (prefills, a continuation, a decode row, empty
# slots)
DECODE_SEQS = [(1, c) for c in (1, 33, 300, 517, 1024, 1500, 2000, 2048)]
MIXED_SEQS = [(600, 600), (300, 1100), (1, 900), (0, 0), (37, 37), (1, 1),
              (0, 0), (0, 0)]
ATTN_CASES = [("decode", DECODE_SEQS, 1, 0, None),
              ("admission", MIXED_SEQS, 8, 16, None),
              ("windowed", MIXED_SEQS, 8, 16, 256),
              ("decode_windowed", DECODE_SEQS, 1, 0, 256)]


def live_pages(args, window, ps=16):
    """The page ids a case's attention reads (each live page of each
    sequence once), as an int64 tensor on the card."""
    import torch
    _, _, _, _, ql, cl, bt = args
    ql, cl, bt = ql.tolist(), cl.tolist(), bt.cpu().numpy()
    ids = []
    for s, (qlen, ctx) in enumerate(zip(ql, cl)):
        if qlen <= 0:
            continue
        lo = 0 if window is None else max(0, ctx - qlen - window + 1)
        ids += bt[s, lo // ps:(ctx - 1) // ps + 1].tolist()
    return torch.tensor(ids, dtype=torch.int64, device="cuda")


def tickets_left_zero(ra):
    """Whether every launch of the split designs left their tickets (the
    counters of `ra.split_tickets`) zero, as the next launch needs."""
    return all(bool((t == 0).all()) for t in ra._TICKETS.values())


def copy_live(kp, vp, idx, scales=()):
    """A yardstick: the live K/V pages (and their scales) copied out by
    `index_select`, each byte read once and written once."""
    return ([kp.index_select(1, idx), vp.index_select(1, idx)]
            + [x.index_select(0, idx) for x in scales])


def _paged_library(args, scale):
    """PyTorch's one call over paged K/V, a yardstick for the decode case
    (the port never calls it): `torch.nn.attention.varlen.varlen_attn`
    with ``block_table=`` and ``seqused_k=`` over the case's pages (laid
    out (pages, page size, HK, D)), one query row a sequence, GQA native:
    its ms (events around one call), or its refusal in its own words,
    with the page size and the torch version."""
    import inspect
    import torch
    q, kp, vp, qs, ql, cl, bt = args
    rec = dict(torch=torch.__version__, page_size=int(kp.shape[2]),
               library_ms=None)
    try:
        from torch.nn.attention import varlen as tv
        fn = tv.varlen_attn
        params = inspect.signature(fn).parameters
        n = len(ql)
        rows = q[qs.long()]
        cu_q = torch.arange(n + 1, dtype=torch.int32, device="cuda")
        cu_k = torch.cat([cl.new_zeros(1), cl.cumsum(0).to(cl.dtype)])
        kk, vv = (t.permute(1, 2, 0, 3).contiguous() for t in (kp, vp))
        kw = dict(block_table=bt, seqused_k=cl.to(torch.int32), scale=scale)
        if "enable_gqa" in params:
            kw["enable_gqa"] = True
        rec["call"] = "torch.nn.attention.varlen.varlen_attn(block_table=, " \
            "seqused_k=, enable_gqa=True)"

        def call():
            return fn(rows, kk, vv, cu_q, cu_k, 1, int(cl.max()), **kw)
        call()
        rec["library_ms"] = time_ms(call)
    except (ImportError, AttributeError, RuntimeError, TypeError,
            ValueError, NotImplementedError) as e:
        rec["refused"] = f"{type(e).__name__}: {e}"[:400]
    log("paged_library " + json.dumps(rec))
    return rec


def attn_phase(results, int8kv=False):
    """The attention cases over full-width pools in bf16 and f32, or
    with ``int8kv`` over int8 pools and their scales with bf16 q: both
    designs (`ra.DESIGNS`) against the plain version (within ATTN_ATOL,
    the split design bitwise on repeat), the entry point launching the
    split design once and the tickets left zero; then both
    designs and a copy of the case's live pages (a yardstick) timed by
    `timed_in_turns` over input sets rotated past the L2."""
    import torch
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops import ragged_paged_attention as ra
    gen = torch.Generator(device="cuda").manual_seed(5 if int8kv else 2)
    kernel = "ragged_paged_attention_int8kv" if int8kv \
        else "ragged_paged_attention"
    dtypes = (torch.bfloat16,) if int8kv else (torch.bfloat16, torch.float32)
    scale = 1.0 / math.sqrt(128)
    for label, seqs, bq, tail, win in ATTN_CASES:
        for dt in dtypes:
            name = str(dt).split(".")[1]
            first = attn_case(seqs, bq, tail, dt, win, gen, int8kv)
            nbytes, ops = first[2], first[3]
            sets = [first] + [attn_case(seqs, bq, tail, dt, win, gen, int8kv)
                              for _ in range(rotation_sets(nbytes) - 1)]
            sets = [(a, sc, live_pages(a, win)) for a, sc, _, _ in sets]
            args, scales, idx = sets[0]

            def run(st, design):
                a, sc, _ = st
                return ra._ragged_cuda(*a, scale, win, bq,
                                       *(sc or (None, None)),
                                       _design=design)
            ref = ra.ragged_paged_attention_ref(*args, scale, win, None,
                                                *scales)
            outs = {d: run(sets[0], d) for d in ra.DESIGNS}
            again = run(sets[0], "split")
            t, h, d = args[0].shape
            hk, _, ps, _ = args[1].shape
            plan = ra.split_plan(t // bq, hk, bq * (h // hk),
                                 args[6].shape[1], ps,
                                 ra.split_kernel(dt, bq, d),
                                 ra.sm_count("cuda"))
            before = dict(launch_counts)
            entry = ra.ragged_paged_attention_values(
                *args, window=win, block_q=bq, use_kernel=True,
                **(dict(k_scale=scales[0], v_scale=scales[1])
                   if int8kv else {}))
            torch.cuda.synchronize()
            entry_ok = (launch_counts[kernel] == before[kernel] + 1
                        and torch.equal(entry, outs["split"]))
            named = {dsg: (lambda st, dsg=dsg: run(st, dsg))
                     for dsg in ra.DESIGNS}
            named["copy"] = lambda st: copy_live(st[0][1], st[0][2], st[2],
                                                 st[1])
            times = timed_in_turns(named, sets)
            tickets_zero = tickets_left_zero(ra)
            plain = time_ms(lambda: ra.ragged_paged_attention_ref(
                *args, scale, win, None, *scales), iters=5, warmup=1)
            lib = _paged_library(args, scale) if (
                label == "decode" and dt == torch.bfloat16
                and not int8kv) else {}
            b_ms, b_by = bound(nbytes, ops, name)
            for dsg in ra.DESIGNS:
                out, tm = outs[dsg], times[dsg]
                err = (out.float() - ref.float()).abs().max().item()
                rec = dict(kernel=kernel, case=label, dtype=name,
                           block_q=bq, window=win, design=dsg,
                           path_design=dsg == "split",
                           split_plan=plan._asdict() if dsg == "split"
                           else None,
                           max_abs_err=err, tol=ATTN_ATOL[name],
                           bitwise_repeat=bool(torch.equal(again, out))
                           if dsg == "split" else None,
                           entry_launches_ok=entry_ok,
                           tickets_left_zero=tickets_zero, ms=tm["ms"],
                           device_ms=tm["device_ms"], host_us=tm["host_us"],
                           plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                           bound_fraction=b_ms / tm["device_ms"],
                           copy_device_ms=times["copy"]["device_ms"],
                           serial_over_split_device=times["serial"][
                               "device_ms"] / times["split"]["device_ms"],
                           library_ms=lib.get("library_ms"),
                           library_paged=lib or None,
                           rotation_sets=len(sets))
                log("kernel " + json.dumps(rec))
                results.append(rec)
                if not (err <= ATTN_ATOL[name]
                        and torch.isfinite(out).all()):
                    raise AssertionError(f"ragged attention kernel "
                                         f"disagrees: {rec}")
                if dsg == "split" and not (rec["bitwise_repeat"]
                                           and entry_ok and tickets_zero):
                    raise AssertionError(f"ragged attention: not bitwise "
                                         f"on repeat, the entry's "
                                         f"launches off, or tickets left "
                                         f"set: {rec}")
            del sets, args, scales, outs, again, entry, ref
            torch.cuda.empty_cache()


def dq_library(x, qw, sc, mode):
    """One PyTorch call that computes the same function, timed as a
    yardstick (the port never calls it): (ms, max |diff| from the plain
    version, note)."""
    import torch
    from paddle_tpu_torch.ops.quant_matmul import dequant_matmul_ref
    if mode != "int8":
        return None, None, ("no PyTorch call takes bf16 x with e4m3 "
                            "weights and per-channel scales: "
                            "torch._scaled_mm multiplies two fp8 operands, "
                            "and quantising x would change the function")
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, None, "torch._weight_int8pack_mm is not in this torch"
    s_x = sc.to(x.dtype)
    try:
        out = fn(x, qw, s_x)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, None, ("torch._weight_int8pack_mm refused: "
                            + str(e).splitlines()[0][:160])
    diff = (out.float() - dequant_matmul_ref(x, qw, sc).float()) \
        .abs().max().item()
    return (time_ms(lambda: fn(x, qw, s_x)), diff,
            "torch._weight_int8pack_mm (scales cast to x's dtype)")


def dq_phase(t_adm, results):
    """The dequant matmul kernel against its plain version at the
    serving path's shapes, int8 and fp8 storage, bf16 and f16 x. At the
    decode gate/up and down shapes the kernel and the bf16 ``F.linear``
    are also timed by `timed_in_turns` over weight sets rotated past the
    L2 (device_ms, host_us); at the admission gate/up shape the path's
    design (`dequant_design`: wgmma), the parent's mma.sync design and the
    bf16 ``F.linear`` are timed in turns the same way (device_ms). An f16
    case also rounds the kernel's output through bf16 as a control, which
    must break the f16 limits of `DQ_TOL`."""
    import torch
    from paddle_tpu_torch.ops.quant_matmul import (dequant_design,
                                                   dequant_matmul_ref,
                                                   dequant_matmul_values,
                                                   quantize_weight_values)
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [("decode_gate_up", 8, 4096, 14336, torch.bfloat16),
             ("decode_down", 8, 14336, 4096, torch.bfloat16),
             ("decode_lm_head", 8, 4096, LLAMA_VOCAB, torch.bfloat16),
             ("admission_gate_up", t_adm, 4096, 14336, torch.bfloat16),
             ("decode_gate_up", 8, 4096, 14336, torch.float16),
             ("admission_gate_up", t_adm, 4096, 14336, torch.float16),
             ("small_f32", 8, 128, 256, torch.float32)]
    for label, m, k, n, dt in cases:
        name = str(dt).split(".")[1]
        w = (0.02 * torch.randn(n, k, device="cuda", generator=gen)).to(dt)
        x = torch.randn(m, k, device="cuda", generator=gen).to(dt)
        lin_ms = time_ms(lambda: torch.nn.functional.linear(x, w))
        turns = label in ("decode_gate_up", "decode_down",
                          "admission_gate_up") and dt == torch.bfloat16
        admission = label.startswith("admission")
        for mode in ("int8", "fp8"):
            qw, sc = quantize_weight_values(w, mode)
            design = dequant_design(dt, m, k, n)
            run = lambda: dequant_matmul_values(x, qw, sc, use_kernel=True)
            out = run()
            ref = dequant_matmul_ref(x, qw, sc)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rtol, atol_rel = DQ_TOL[name]
            top = ref.float().abs().max().item()
            ok = torch.allclose(out.float(), ref.float(), rtol=rtol,
                                atol=atol_rel * top)
            repeat = torch.equal(run(), out)
            ms = time_ms(run)
            plain = time_ms(lambda: dequant_matmul_ref(x, qw, sc), iters=5,
                            warmup=1)
            lib_ms, lib_diff, lib_note = dq_library(x, qw, sc, mode)
            isz = x.element_size()
            nbytes = m * k * isz + n * k + 4 * n + m * n * isz
            b_ms, b_by = bound(nbytes, 2 * m * n * k, name)
            timed, control = {}, None
            if dt == torch.float16:
                ctl = out.to(torch.bfloat16).to(dt).float()
                control = dict(
                    max_abs_err=(ctl - ref.float()).abs().max().item(),
                    within_tol=torch.allclose(ctl, ref.float(), rtol=rtol,
                                              atol=atol_rel * top))
                ok = ok and not control["within_tol"]
                del ctl
            if turns:
                # weight sets (quantized and 16-bit) rotated past the L2
                sets = [(x, qw, sc, w)]
                for _ in range(rotation_sets(n * k) - 1):
                    ws = (0.02 * torch.randn(n, k, device="cuda",
                                             generator=gen)).to(dt)
                    sets.append((x, *quantize_weight_values(ws, mode), ws))
                named = {design: (lambda st, d=design: dequant_matmul_values(
                    st[0], st[1], st[2], use_kernel=True, _design=d))}
                if admission:
                    named["mma.sync"] = lambda st: dequant_matmul_values(
                        st[0], st[1], st[2], use_kernel=True,
                        _design="mma.sync")
                named["linear"] = lambda st: torch.nn.functional.linear(
                    st[0], st[3])
                t = timed_in_turns(named, sets, host=not admission)
                ms = t[design]["ms"]
                timed = dict(device_ms=t[design]["device_ms"],
                             host_us=t[design]["host_us"],
                             bound_fraction=b_ms / t[design]["device_ms"],
                             designs={d: t[d] for d in named
                                      if d != "linear"},
                             bf16_linear_device_ms=t["linear"]["device_ms"],
                             bf16_linear_host_us=t["linear"]["host_us"],
                             rotation_sets=len(sets))
                for d in named:
                    if d not in (design, "linear"):
                        o = dequant_matmul_values(x, qw, sc, _design=d)
                        timed["designs"][d]["max_abs_err"] = \
                            (o.float() - ref.float()).abs().max().item()
                        ok = ok and torch.allclose(
                            o.float(), ref.float(), rtol=rtol,
                            atol=atol_rel * top)
                        del o
                del sets
            rec = dict(kernel="dequant_matmul", case=label, mode=mode,
                       dtype=name, design=design, M=m, K=k, N=n,
                       max_abs_err=err, max_abs_out=top,
                       tol=dict(rtol=rtol, atol=atol_rel * top),
                       bitwise_repeat=repeat, ms=ms, **timed,
                       bf16_rounded_control=control,
                       plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms, library_max_abs_diff=lib_diff,
                       library_note=lib_note,
                       bf16_linear_ms=lin_ms if dt == torch.bfloat16
                       else None,
                       f16_linear_ms=lin_ms if dt == torch.float16
                       else None)
            log("kernel " + json.dumps(rec))
            if not (ok and repeat and torch.isfinite(out).all()):
                raise AssertionError(f"dequant matmul kernel disagrees: "
                                     f"{rec}")
            results.append(rec)
            del qw, sc, out, ref
        del w, x
        torch.cuda.empty_cache()


def lora_phase(t_adm, results, seg_ids):
    """The LoRA epilogue kernel against its plain version at the 8B
    serving shapes (rank 16, four stack rows), with bitwise checks of row
    0 and of batch invariance. Ids at decode and in the ``admission_gate_up``
    case interleave rows 0..3 token by token; ``admission_segmented`` takes
    ``seg_ids``, the rows of the first admission batch's own prompts (a
    sequence's tokens together, sequence s under row s % 4, as
    `serve_8b_lora` assigns them). The path's design (`lora_design`: SGMV
    for bf16) and the parent's BGMV design are timed in turns by
    `timed_in_turns` over adapter stacks rotated past the L2 (device_ms;
    host_us at decode)."""
    import torch
    from paddle_tpu_torch.ops.lora_epilogue import (lora_design,
                                                    lora_epilogue_ref,
                                                    lora_epilogue_values)
    gen = torch.Generator(device="cuda").manual_seed(7)
    r, n_rows = LORA_RANK, 4
    scale = torch.tensor([0.0, 1.0, 0.5, 2.0], device="cuda")
    cases = [("decode_q_o", 8, 4096, 4096, torch.bfloat16),
             ("decode_k_v", 8, 4096, 1024, torch.bfloat16),
             ("decode_gate_up", 8, 4096, 14336, torch.bfloat16),
             ("decode_down", 8, 14336, 4096, torch.bfloat16),
             ("admission_gate_up", t_adm, 4096, 14336, torch.bfloat16),
             ("admission_segmented", t_adm, 4096, 14336, torch.bfloat16),
             ("small_f32", 8, 128, 256, torch.float32)]
    for label, t, k, n, dt in cases:
        name = str(dt).split(".")[1]
        x = torch.randn(t, k, device="cuda", generator=gen).to(dt)
        a = (torch.randn(n_rows, k, r, device="cuda", generator=gen)
             / math.sqrt(k)).to(dt)
        b = (0.1 * torch.randn(n_rows, r, n, device="cuda",
                               generator=gen)).to(dt)
        a[0] = 0
        b[0] = 0
        if label == "admission_segmented":
            ids = seg_ids.to("cuda", torch.int32)
        else:
            ids = (torch.arange(t, device="cuda", dtype=torch.int32) * 3) \
                % n_rows
        design = lora_design(dt, r)
        run = lambda: lora_epilogue_values(x, a, b, scale, ids,
                                           use_kernel=True)
        plain_fn = lambda: lora_epilogue_ref(x, a, b, scale, ids)
        il = ids.long()

        def bmm_ref():
            h = torch.bmm(x[:, None, :], a[il])
            return (torch.bmm(h, b[il])[:, 0] * scale[il, None]).to(dt)
        out = run()
        ref = plain_fn()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rtol, atol_rel = DQ_TOL[name]
        top = ref.float().abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), rtol=rtol,
                            atol=atol_rel * top)
        # bitwise: no sum runs across tokens, so a token's delta does not
        # depend on its batch; row-0 tokens are exact zeros
        zeros = bool((out[ids == 0] == 0).all())
        alone = all(torch.equal(lora_epilogue_values(
            x[i:i + 1], a, b, scale, ids[i:i + 1], use_kernel=True),
            out[i:i + 1]) for i in (0, 1, 2, 3, t // 2, t - 1))
        in8 = torch.equal(lora_epilogue_values(
            x[:8], a, b, scale, ids[:8], use_kernel=True), out[:8])
        ms = time_ms(run)
        timed = {}
        if dt == torch.bfloat16:
            sets = [(x, a, b)]
            for _ in range(rotation_sets((k * r + r * n) * n_rows
                                         * x.element_size()) - 1):
                sets.append((x, a.clone().normal_(generator=gen),
                             b.clone().normal_(generator=gen)))
            named = {d: (lambda st, d=d: lora_epilogue_values(
                st[0], st[1], st[2], scale, ids, use_kernel=True,
                _design=d)) for d in (design, "bgmv")}
            tt = timed_in_turns(named, sets,
                                host=label.startswith("decode"))
            ms = tt[design]["ms"]
            parent = lora_epilogue_values(x, a, b, scale, ids,
                                          use_kernel=True, _design="bgmv")
            ok = ok and torch.allclose(parent.float(), ref.float(),
                                       rtol=rtol, atol=atol_rel * top)
            timed = dict(device_ms=tt[design]["device_ms"],
                         host_us=tt[design]["host_us"], designs=tt,
                         parent_max_abs_err=(parent.float() - ref.float())
                         .abs().max().item(),
                         rotation_sets=len(sets))
            del sets, parent
        plain = time_ms(plain_fn, iters=5, warmup=1)
        bmm_ms = time_ms(bmm_ref, iters=5, warmup=1)
        isz = x.element_size()
        live = ids[ids > 0]
        rows_used = len(torch.unique(live))
        nbytes = (rows_used * (k * r + r * n) * isz + t * k * isz
                  + t * n * isz + 4 * t + 4 * n_rows)
        b_ms, b_by = bound(nbytes, len(live) * 2 * (k * r + r * n), name)
        if timed:
            timed["bound_fraction"] = b_ms / timed["device_ms"]
        rec = dict(kernel="lora_epilogue", case=label, dtype=name,
                   design=design, T=t, K=k, N=n, rank=r, max_abs_err=err,
                   max_abs_out=top, tol=dict(rtol=rtol, atol=atol_rel * top),
                   distinct_ids=rows_used, row0_exact_zero=zeros,
                   alone_equals_batch=alone, batch8_equals_batch=in8, ms=ms,
                   **timed, plain_ms=plain,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   library_note="no single PyTorch call computes a "
                   "per-token gathered low-rank product",
                   bmm_ref_ms=bmm_ms)
        log("kernel " + json.dumps(rec))
        if not (ok and zeros and alone and in8
                and torch.isfinite(out).all()):
            raise AssertionError(f"lora epilogue kernel disagrees: {rec}")
        results.append(rec)
        del x, a, b, out, ref


def paged_phase(results):
    """The q = 1 paged attention kernel's two designs against its plain
    version on the decode case of `attn_phase`, bf16 and f32, and
    windowed (w=256) in bf16 (the split design bitwise on repeat, the
    entry launching it once, the tickets left zero); then both
    designs, the ragged split design at block_q = 1 on the same pages
    (the same work) and a copy of the live pages timed by
    `timed_in_turns`."""
    import torch
    from paddle_tpu_torch.ops import launch_counts
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import ragged_paged_attention as ra
    gen = torch.Generator(device="cuda").manual_seed(6)
    scale = 1.0 / math.sqrt(128)
    for label, dt, win in (("decode", torch.bfloat16, None),
                           ("decode", torch.float32, None),
                           ("decode_windowed", torch.bfloat16, 256)):
        name = str(dt).split(".")[1]
        first = attn_case(DECODE_SEQS, 1, 0, dt, win, gen)
        nbytes, ops = first[2], first[3]
        sets = [first] + [attn_case(DECODE_SEQS, 1, 0, dt, win, gen)
                          for _ in range(rotation_sets(nbytes) - 1)]
        sets = [(a, live_pages(a, win)) for a, _, _, _ in sets]
        args = sets[0][0]
        q, kp, vp, _, _, cl, bt = args

        def run(st, design):
            qq, kk, vv, _, _, cc, bb = st[0]
            return pa._paged_cuda(qq, kk, vv, cc, bb, scale, win,
                                  _design=design)
        ref = pa.paged_attention_ref(q, kp, vp, cl, bt, scale, win)
        outs = {d: run(sets[0], d) for d in ra.DESIGNS}
        again = run(sets[0], "split")
        plan = ra.split_plan(q.shape[0], kp.shape[0],
                             q.shape[1] // kp.shape[0], bt.shape[1],
                             kp.shape[2], "cuda_cores", ra.sm_count("cuda"))
        before = dict(launch_counts)
        entry = pa.paged_attention_values(q, kp, vp, cl, bt, window=win,
                                          use_kernel=True)
        torch.cuda.synchronize()
        entry_ok = (launch_counts["paged_attention"]
                    == before["paged_attention"] + 1
                    and torch.equal(entry, outs["split"]))
        named = {dsg: (lambda st, dsg=dsg: run(st, dsg))
                 for dsg in ra.DESIGNS}
        named["ragged_bq1"] = lambda st: ra._ragged_cuda(
            *st[0], scale, win, 1)
        named["copy"] = lambda st: copy_live(st[0][1], st[0][2], st[1])
        times = timed_in_turns(named, sets)
        tickets_zero = tickets_left_zero(ra)
        plain = time_ms(lambda: pa.paged_attention_ref(q, kp, vp, cl, bt,
                                                       scale, win),
                        iters=5, warmup=1)
        b_ms, b_by = bound(nbytes, ops, name)
        for dsg in ra.DESIGNS:
            out, tm = outs[dsg], times[dsg]
            err = (out.float() - ref.float()).abs().max().item()
            rec = dict(kernel="paged_attention", case=label, dtype=name,
                       window=win, design=dsg, path_design=dsg == "split",
                       split_plan=plan._asdict() if dsg == "split" else None,
                       max_abs_err=err, tol=ATTN_ATOL[name],
                       bitwise_repeat=bool(torch.equal(again, out))
                       if dsg == "split" else None,
                       entry_launches_ok=entry_ok,
                       tickets_left_zero=tickets_zero, ms=tm["ms"],
                       device_ms=tm["device_ms"], host_us=tm["host_us"],
                       plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       bound_fraction=b_ms / tm["device_ms"],
                       copy_device_ms=times["copy"]["device_ms"],
                       serial_over_split_device=times["serial"]["device_ms"]
                       / times["split"]["device_ms"],
                       library_ms=None,
                       ragged_bq1_ms=times["ragged_bq1"]["ms"],
                       ragged_bq1_device_ms=times["ragged_bq1"]["device_ms"],
                       rotation_sets=len(sets))
            log("kernel " + json.dumps(rec))
            results.append(rec)
            if not (err <= ATTN_ATOL[name] and torch.isfinite(out).all()):
                raise AssertionError(f"paged attention kernel disagrees: "
                                     f"{rec}")
            if dsg == "split" and not (rec["bitwise_repeat"] and entry_ok
                                       and tickets_zero):
                raise AssertionError(f"paged attention: not bitwise on "
                                     f"repeat, the entry's launches off, "
                                     f"or tickets left set: {rec}")
        del sets, args, outs, again, entry, ref
        torch.cuda.empty_cache()


def tiny_parity():
    """A tiny f32 Llama served on the card (kernels) and on the CPU
    (plain versions) must give equal greedy streams."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    cfg = LlamaConfig.tiny()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 20, 47, 3)]
    streams = []
    for dev in ("cuda", "cpu"):
        model = LlamaForCausalLM(cfg, device="cpu", seed=3).to(dev)
        eng = ContinuousBatchingEngine(model, max_batch_size=2,
                                       max_seq_len=64, prefill_chunk=16,
                                       device=dev)
        for p in prompts:
            eng.add_request(p, max_new_tokens=8)
        streams.append(eng.run())
    log(f"tiny parity: card {streams[0]} cpu {streams[1]}")
    if streams[0] != streams[1]:
        raise AssertionError("tiny Llama greedy streams differ between "
                             "the card and the CPU")


def recorded_run(model, eng, jobs):
    """Serve ``jobs`` [(prompt, adapter or None)] on ``eng`` (8 new
    tokens each), recording each dispatch's logits and which of their
    rows to compare (a decode dispatch has one row per slot; an empty
    slot reads the trash page, whose bytes are unspecified). Returns
    (streams, records)."""
    import torch
    rec = []
    decoding = [False]
    head, decode = model.logits, eng._decode

    def logits(h, *a, **kw):
        out = head(h, *a, **kw)
        live = [r is not None for r in eng._slot_req] \
            if decoding[0] else [True] * out.shape[0]
        rec.append((out.float().cpu(), torch.tensor(live)))
        return out

    def traced(finished):
        decoding[0] = True
        try:
            decode(finished)
        finally:
            decoding[0] = False
    model.logits = logits
    eng._decode = traced
    try:
        for p, adapter in jobs:
            eng.add_request(p, max_new_tokens=8, adapter=adapter)
        streams = eng.run()
    finally:
        del model.logits, eng._decode
    eng.check_invariants()
    return streams, rec


def compare_records(recs):
    """(largest |logit difference|, dispatches compared) between the
    card's and the CPU's records, up to and including the first
    dispatch whose greedy tokens differ."""
    import torch
    worst, n_cmp = 0.0, 0
    for (a, live), (b, _) in zip(*recs):
        a, b = a[live], b[live]
        worst = max(worst, (a - b).abs().max().item())
        n_cmp += 1
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            break
    return worst, n_cmp


def tiny_quant_parity():
    """A tiny f32 Llama under quantized serving on the card (kernels)
    and on the CPU (plain versions): equal greedy streams, and every
    dispatch's logits within `TINY_QUANT_LOGIT_BUDGET` — if the streams
    diverge, over the dispatches up to the first whose greedy tokens
    differ, which must be at least 3."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                                 QuantServingConfig)
    cfg = LlamaConfig.tiny()
    rng = np.random.default_rng(3)
    jobs = [(rng.integers(0, cfg.vocab_size, n), None)
            for n in (5, 20, 47, 3)]
    for weights in ("int8", "fp8"):
        streams, recs = [], []
        for dev in ("cuda", "cpu"):
            model = LlamaForCausalLM(cfg, device="cpu", seed=3).to(dev)
            # eager: the logits record reads the card inside every
            # forward, which a graph capture cannot hold
            eng = ContinuousBatchingEngine(
                model, max_batch_size=2, max_seq_len=64, prefill_chunk=16,
                device=dev, quant=QuantServingConfig(weights, "int8"),
                _graphs=False)
            out, rec = recorded_run(model, eng, jobs)
            streams.append(out)
            recs.append(rec)
        worst, n_cmp = compare_records(recs)
        same = streams[0] == streams[1]
        log(f"tiny quant parity ({weights} weights, int8 KV): streams "
            f"{'equal' if same else 'DIVERGE'}; max |logit diff| "
            f"{worst:.3g} over {n_cmp} of {len(recs[0])} dispatches "
            f"(budget {TINY_QUANT_LOGIT_BUDGET}); card {streams[0]} "
            f"cpu {streams[1]}")
        if worst > TINY_QUANT_LOGIT_BUDGET or (not same and n_cmp < 3):
            raise AssertionError("tiny quantized Llama: card and CPU "
                                 "logits disagree beyond the budget")


def tiny_adapters(model, names=("a1", "a2")):
    """Seeded rank-8 deltas (A (K, r), B (r, N)) on three matmuls of the
    tiny Llama, the vocab head among them."""
    params = dict(model.named_parameters())
    out = {}
    for i, name in enumerate(names):
        rng = np.random.default_rng(i + 1)
        deltas = {}
        for nm in ("model.layers.0.self_attn.q_proj.weight",
                   "model.layers.1.mlp.down_proj.weight", "lm_head.weight"):
            n, k = params[nm].shape
            deltas[nm] = (rng.normal(size=(k, 8)).astype(np.float32) * 0.3,
                          rng.normal(size=(8, n)).astype(np.float32) * 0.3)
        out[name] = deltas
    return out


def tiny_lora_parity():
    """A tiny f32 Llama serving base and two adapters in one engine on the
    card (kernels) and on the CPU (plain versions): equal greedy streams
    and every dispatch's logits within `TINY_LORA_LOGIT_BUDGET`, full
    width and over an int8 base. Whether the card's mixed streams equal
    dedicated engines' is printed only."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                                 QuantServingConfig)
    cfg = LlamaConfig.tiny()
    rng = np.random.default_rng(4)
    names = (None, "a1", "a2")
    jobs = [(rng.integers(0, cfg.vocab_size, n), names[i % 3])
            for i, n in enumerate((5, 20, 47, 3, 30, 9))]

    def engine(dev, quant, adapters=("a1", "a2")):
        model = LlamaForCausalLM(cfg, device="cpu", seed=3).to(dev)
        # eager, as in tiny_quant_parity: the record reads the card
        eng = ContinuousBatchingEngine(model, max_batch_size=3,
                                       max_seq_len=64, device=dev,
                                       quant=quant, _graphs=False)
        deltas = tiny_adapters(model)
        for name in adapters:
            eng.install_adapter(name, deltas[name])
        return model, eng

    for label, quant in (("full width", None),
                         ("int8 base", QuantServingConfig("int8", None))):
        streams, recs = [], []
        for dev in ("cuda", "cpu"):
            out, rec = recorded_run(*engine(dev, quant), jobs)
            streams.append(out)
            recs.append(rec)
        worst, n_cmp = compare_records(recs)
        same = streams[0] == streams[1]
        log(f"tiny lora parity ({label}, 2 adapters + base): streams "
            f"{'equal' if same else 'DIVERGE'}; max |logit diff| "
            f"{worst:.3g} over {n_cmp} of {len(recs[0])} dispatches "
            f"(budget {TINY_LORA_LOGIT_BUDGET}); card {streams[0]} cpu "
            f"{streams[1]}")
        if not same or worst > TINY_LORA_LOGIT_BUDGET:
            raise AssertionError(f"tiny LoRA Llama ({label}): card and "
                                 "CPU disagree")
    mixed, _ = recorded_run(*engine("cuda", None), jobs)
    dedicated = {}
    for name in names:
        sub = [(i, j) for i, j in enumerate(jobs) if j[1] == name]
        out, _ = recorded_run(*engine("cuda", None, [name] if name else []),
                              [j for _, j in sub])
        dedicated.update((i, out[k]) for k, (i, _) in enumerate(sub))
    log(f"tiny lora: mixed engine's streams equal dedicated engines' on "
        f"the card: {all(mixed[i] == dedicated[i] for i in mixed)}")


def tiny_legacy_parity():
    """A tiny f32 Llama under ``attention_impl="legacy"`` on the card
    (paged attention kernel) and on the CPU: equal greedy streams, also
    equal to the ragged engine's on the card."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    cfg = LlamaConfig.tiny()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 20, 47, 3)]
    streams = {}
    for dev, impl in (("cuda", "legacy"), ("cpu", "legacy"),
                      ("cuda", "ragged")):
        model = LlamaForCausalLM(cfg, device="cpu", seed=3).to(dev)
        eng = ContinuousBatchingEngine(model, max_batch_size=2,
                                       max_seq_len=64, device=dev,
                                       attention_impl=impl)
        for p in prompts:
            eng.add_request(p, max_new_tokens=8)
        streams[dev, impl] = eng.run()
        eng.check_invariants()
    log(f"tiny legacy parity: card {streams['cuda', 'legacy']} cpu "
        f"{streams['cpu', 'legacy']} card ragged {streams['cuda', 'ragged']}")
    if not (streams["cuda", "legacy"] == streams["cpu", "legacy"]
            == streams["cuda", "ragged"]):
        raise AssertionError("tiny Llama legacy streams differ (card, CPU, "
                             "ragged)")


def make_requests(vocab):
    """The served requests: seeded prompts of 32..1024 tokens, each
    asking for 32..64 new tokens."""
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(N_REQUESTS):
        n = int(rng.integers(32, 1025))
        new = int(rng.integers(32, 65))
        reqs.append((rng.integers(0, vocab, n), new))
    return reqs


def serve_8b():
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    torch.cuda.synchronize()
    log(f"built llama3_8b bf16 on the card in "
        f"{time.perf_counter() - t0:.1f}s "
        f"({cfg.num_params() / 1e9:.2f}B parameters)")
    eng = ContinuousBatchingEngine(model, max_batch_size=8,
                                   max_seq_len=2048)
    if cfg.vocab_size != LLAMA_VOCAB:
        raise AssertionError("llama3_8b vocab changed")
    reqs = make_requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    for p, new in reqs:
        eng.add_request(p, max_new_tokens=new)
    done = []
    while len(done) < N_REQUESTS:
        done += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    L = cfg.num_hidden_layers
    by_rid = {r.rid: r for r in done}
    for rid, (_, new) in enumerate(reqs):
        r = by_rid[rid]
        if r.status != "finished" or len(r.output) != new:
            raise AssertionError(f"request {rid}: {r.status} with "
                                 f"{len(r.output)} of {new} tokens")
    eng.check_invariants()
    if len(eng._free) != eng.num_pages - 1:
        raise AssertionError("pages still held after the run")
    check_serving_counts(eng, counts, L)
    streams = [by_rid[rid].output for rid in range(N_REQUESTS)]
    stats = serving_stats(eng, done, wall)
    del eng
    # the attention's device time a decode step, by torch.profiler over 10
    # decode steps of a second engine on the same model (8 seeded prompts
    # of 32-1024 tokens; tools/profile_decode.py), beside the run's numbers
    from paddle_tpu_torch.tools.profile_decode import profile_engine
    prof = profile_engine(model, None, 10)
    fam = prof["by_family"].get("split_attention", {})
    stats.update(attention_device_ms_per_step=fam.get("device_ms_per_step"),
                 attention_launches_per_step=fam.get("launches_per_step"),
                 profiled_device_ms_per_step=prof["device_ms_per_step"],
                 profiled_step_ms=prof["step_ms"],
                 profiled_idle_share=prof["idle_share"])
    log("serving " + json.dumps(stats))
    return model, counts, reqs, streams, stats


def check_serving_counts(eng, counts, L, extra=0):
    """A full-width bf16 serving run's launches: every dispatch runs each
    layer's attention once and every RMSNorm once, and nothing else;
    ``extra`` eager decode passes (`profile_round`'s) each count as one
    more dispatch."""
    nd = eng.num_dispatches + extra
    want = {"ragged_paged_attention": L * nd, "rms_norm": (2 * L + 1) * nd,
            "ragged_paged_attention_int8kv": 0, "dequant_matmul": 0,
            "lora_epilogue": 0, "paged_attention": 0, **NO_TRAINING}
    log(f"launches {counts} expected {want} over {nd} dispatches "
        f"({eng.num_admission_dispatches} admission, "
        f"{eng.num_decode_dispatches} decode)")
    if counts != want:
        raise AssertionError("launch counts do not match the dispatches")


def serving_stats(eng, done, wall):
    import torch
    ttft = sorted(r.first_token_time - r.arrival_time for r in done)
    return dict(requests=len(done), wall_s=wall,
                ttft_p50_s=statistics.median(ttft),
                admission_tokens=eng.admission_tokens,
                admission_tokens_per_s=eng.admission_tokens
                / eng.admission_seconds,
                decode_tokens=eng.decode_tokens,
                decode_tokens_per_s=eng.decode_tokens / eng.decode_seconds,
                decode_step_ms=1e3 * eng.decode_seconds
                / eng.num_decode_dispatches,
                host_us_per_step=1e6 * eng.decode_dispatch_seconds
                / eng.num_decode_dispatches,
                graph_captures=eng.num_graph_captures,
                graph_capture_s=eng.graph_capture_seconds,
                dispatches=eng.num_dispatches,
                admission_dispatches=eng.num_admission_dispatches,
                decode_dispatches=eng.num_decode_dispatches,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

# the pipelined window of `serve_8b_pipelined` and the profiled steps of
# both loops (a multiple of the window, so the profile ends on one)
HARVEST_EVERY = 4
PROFILE_STEPS = 12
# `serve_8b_prefix`: a 512-token shared prefix (32 pages of 16, the
# default max_prefix_entries) and seeded suffixes; one warm request
# registers it, then N_PREFIX_HITS more hit it
PREFIX_LEN = 512
PREFIX_SUFFIX = (32, 512)
N_PREFIX_HITS = 8


def step_summary(stats):
    return {k: stats[k] for k in ("decode_step_ms", "decode_tokens_per_s",
                                  "ttft_p50_s")}


def sync_free_window(model, graphs):
    """One full window of `HARVEST_EVERY` decode dispatches of an 8B
    engine at ``harvest_every=HARVEST_EVERY``, under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that waits for
    the card inside the window (a host read of a device value, a
    pageable copy) raises. With ``graphs`` the decode program is
    captured in the steps before (a capture synchronizes), so the window
    holds replays only. The window is then drained."""
    import torch
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048,
                                   harvest_every=HARVEST_EVERY,
                                   _graphs=graphs)
    rng = np.random.default_rng(2)
    for _ in range(8):
        eng.add_request(rng.integers(0, model.config.vocab_size,
                                     int(rng.integers(32, 1025))),
                        max_new_tokens=64)
    eng.step()                    # admission (its copy syncs) + dispatch 1
    eng.step()                    # dispatch 2: pinned buffers warmed
    eng.quiesce()
    if graphs and eng._decode_program.graph is None:
        raise AssertionError("the decode program was not captured")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(HARVEST_EVERY):
            eng.step()
        held = len(eng._pending)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    drained = eng.quiesce()
    eng.check_invariants()
    log(f"sync-free window ({'graphed' if graphs else 'eager'}): {held} "
        "decode dispatches with no synchronizing call under "
        f"set_sync_debug_mode('error'), {drained} harvested in one copy")
    if held != HARVEST_EVERY or drained != HARVEST_EVERY:
        raise AssertionError("the window did not hold its dispatches")


def serve_run(model, reqs, k, graphs=True, **kw):
    """Serve ``reqs`` on a fresh 8B engine at ``harvest_every=k``, graphed
    or eager (``kw``: more engine options), with the launch counts and
    the peak memory reset before: (engine, streams, counts, stats)."""
    import torch
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    gc.collect()                  # nothing of an earlier run in the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048,
                                   harvest_every=k, _graphs=graphs, **kw)
    reset_launch_counts()
    t0 = time.perf_counter()
    for p, new in reqs:
        eng.add_request(p, max_new_tokens=new)
    done = []
    while len(done) < len(reqs):
        done += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    by_rid = {r.rid: r for r in done}
    streams = [by_rid[rid].output for rid in range(len(reqs))]
    return eng, streams, counts, serving_stats(eng, done, wall)


def serve_8b_pipelined(model, reqs, want_streams, k1_stats):
    """The 16 requests of `serve_8b` again at ``harvest_every=4``: greedy
    streams bitwise equal to the k = 1 run's, launch counts by
    `check_serving_counts`; then k = 1 and k = 4 in turns (1, 4, 4, 1),
    each run's streams equal too; a window free of synchronizing calls;
    every run's decode step ms, tokens/s and TTFT p50, and
    `profile_engine`'s idle share and device ms a step at k = 1 and
    k = 4."""
    from paddle_tpu_torch.tools.profile_decode import profile_engine
    eng, streams, counts, stats = serve_run(model, reqs, HARVEST_EVERY)
    same = sum(a == b for a, b in zip(streams, want_streams))
    log(f"pipelined k={HARVEST_EVERY}: {same} of {N_REQUESTS} streams "
        "bitwise equal to k=1")
    if streams != want_streams:
        raise AssertionError("pipelined streams differ from k=1's")
    eng.check_invariants()
    if len(eng._free) != eng.num_pages - 1:
        raise AssertionError("pages still held after the pipelined run")
    check_serving_counts(eng, counts, model.config.num_hidden_layers)
    del eng
    turns = {1: [step_summary(k1_stats)], HARVEST_EVERY: [step_summary(stats)]}
    for k in (1, HARVEST_EVERY, HARVEST_EVERY, 1):
        _, streams, _, st = serve_run(model, reqs, k)
        if streams != want_streams:
            raise AssertionError(f"k={k} streams differ from the first run's")
        turns[k].append(step_summary(st))
    sync_free_window(model, graphs=False)
    for k, runs in turns.items():
        log(f"serving_k{k} " + json.dumps(runs))
    prof = {k: profile_engine(model, None, PROFILE_STEPS, harvest_every=k)
            for k in (1, HARVEST_EVERY)}
    stats.update(turns={f"k{k}": runs for k, runs in turns.items()},
                 profiled={f"k{k}": {f: p[f] for f in (
                     "step_ms", "device_ms_per_step", "idle_share")}
                     for k, p in prof.items()})
    log("serving_pipelined " + json.dumps(stats))


def serve_8b_graphs(model, reqs, want_streams):
    """The program cache as CUDA graphs at 8B: the 16 requests of
    `serve_8b` on eager (``_graphs=False``) and graphed engines in turns
    (eager, graphed, graphed, eager) at k = 1 and k = 4. Every run's
    streams bitwise equal to `serve_8b`'s and its launch counts exact by
    `check_serving_counts` (a replay adds what its capture recorded);
    a graphed window free of synchronizing calls; every run's decode
    step ms, host us a step, TTFT p50, captures, capture seconds and
    peak memory; `profile_engine`'s step ms, device ms a step and idle
    share, eager and graphed in turns at both k; the decode graph's
    replay wall (`decode_replay_ms`)."""
    from paddle_tpu_torch.tools.profile_decode import profile_engine
    L = model.config.num_hidden_layers
    fields = ("decode_step_ms", "host_us_per_step", "decode_tokens_per_s",
              "ttft_p50_s", "admission_tokens_per_s", "graph_captures",
              "graph_capture_s", "peak_mem_gib", "wall_s")
    turns = {}
    for k in (1, HARVEST_EVERY):
        for graphs in (False, True, True, False):
            eng, streams, counts, st = serve_run(model, reqs, k, graphs)
            same = sum(a == b for a, b in zip(streams, want_streams))
            side = f"k{k}_{'graphed' if graphs else 'eager'}"
            log(f"{side}: {same} of {N_REQUESTS} streams bitwise equal to "
                f"serve_8b's; {eng.num_graph_captures} captures, programs "
                f"{list(eng._ragged_programs)}")
            if streams != want_streams:
                raise AssertionError(f"{side}: streams differ from "
                                     "serve_8b's")
            check_serving_counts(eng, counts, L)
            if graphs != (eng.num_graph_captures > 0):
                raise AssertionError(f"{side}: {eng.num_graph_captures} "
                                     "captures")
            turns.setdefault(side, []).append({f: st[f] for f in fields})
            del eng
    sync_free_window(model, graphs=True)
    prof = {}
    for k in (1, HARVEST_EVERY):
        for graphs in (False, True, True, False):
            p = profile_engine(model, None, PROFILE_STEPS, harvest_every=k,
                               graphs=graphs)
            fam = p["by_family"].get("split_attention", {})
            prof.setdefault(f"k{k}_{'graphed' if graphs else 'eager'}",
                            []).append(dict(
                {f: p[f] for f in ("step_ms", "device_ms_per_step",
                                   "idle_share", "captures")},
                attention_launches_per_step=fam.get("launches_per_step"),
                attention_device_ms_per_step=fam.get("device_ms_per_step"),
                family_device_ms_per_step={
                    f: v["device_ms_per_step"]
                    for f, v in p["by_family"].items()}))
    replay = [decode_replay_ms(model) for _ in range(2)]
    for k in (1, HARVEST_EVERY):
        log(f"serving_graphs_k{k} " + json.dumps(
            {s: turns[s] for s in turns if s.startswith(f"k{k}_")}))
    log("serving_graphs " + json.dumps(dict(turns=turns, profiled=prof,
                                            decode_replay_ms=replay)))


def decode_replay_ms(model, reps=20):
    """The card's wall of one graphed decode step: the decode program of
    an 8-slot engine (8 seeded prompts of 32-1024 tokens, as
    `profile_engine` admits) replayed ``reps`` times back to back on its
    last inputs, between two CUDA events. Beside the profiled sum of its
    kernels' times it gives the gaps between a graph's kernels."""
    import torch
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048)
    rng = np.random.default_rng(0)
    for _ in range(8):
        eng.add_request(rng.integers(0, model.config.vocab_size,
                                     int(rng.integers(32, 1025))),
                        max_new_tokens=64)
    for _ in range(3):            # admission, the warm-up, the capture
        eng.step()
    graph = eng._decode_program.graph
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def eager_streams(model, reqs, prepare=None, adapters=(None,), **kw):
    """The streams of ``reqs`` on an eager 8B engine (``_graphs=False``;
    ``prepare(engine)`` installs what a phase's engine had): the
    yardstick that a graphed phase's streams are held to, bitwise."""
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048,
                                   _graphs=False, **kw)
    if prepare is not None:
        prepare(eng)
    rids = [eng.add_request(p, max_new_tokens=n,
                            adapter=adapters[i % len(adapters)])
            for i, (p, n) in enumerate(reqs)]
    out = eng.run()
    return [out[r] for r in rids]


def check_eager_equal(label, streams, eager):
    same = sum(a == b for a, b in zip(streams, eager))
    log(f"{label}: {same} of {len(streams)} graphed streams bitwise equal "
        "to an eager engine's")
    if streams != eager:
        raise AssertionError(f"{label}: graphed streams differ from the "
                             "eager engine's")


def graph_replay(fn):
    """``fn()`` once eagerly on a side stream (the warm-up that makes the
    split tickets of that stream), then captured there as a CUDA graph
    and replayed once: the replay's output. The capture launches nothing
    but the wrappers count it, so the launch counts are restored."""
    import torch
    from paddle_tpu_torch.ops import launch_counts
    saved = dict(launch_counts)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    launch_counts.update(saved)
    return out.clone()


def prefix_requests(vocab):
    """`N_PREFIX_HITS` + 1 seeded prompts: the shared prefix and a
    suffix of 32..512 tokens each, asking for 32..64 new tokens."""
    rng = np.random.default_rng(16)
    prefix = rng.integers(0, vocab, PREFIX_LEN)
    reqs = []
    for _ in range(N_PREFIX_HITS + 1):
        n = int(rng.integers(PREFIX_SUFFIX[0], PREFIX_SUFFIX[1] + 1))
        reqs.append((np.concatenate([prefix, rng.integers(0, vocab, n)]),
                     int(rng.integers(32, 65))))
    return reqs


def prefix_run(model, reqs, cached, graphs=True):
    """Serve the warm request to completion, then the hit requests on an
    engine with or without the prefix cache, recording the hit round's
    admission logits (one row per slot: the round admits all of them in
    one dispatch). Returns (engine, streams, admission logits, the
    round's TTFT p50, admission tokens, admission seconds)."""
    import torch
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048,
                                   enable_prefix_caching=cached,
                                   _graphs=graphs)
    eng.add_request(reqs[0][0], max_new_tokens=reqs[0][1])
    eng.run()
    # the hit round's admission is its key's first use, an eager run, so
    # the logits hook below records it on a graphed engine too
    rec, head, decode = [], model.logits, eng._decode
    decoding = [False]

    def logits(h, *a, **kw):
        out = head(h, *a, **kw)
        if not decoding[0]:
            rec.append(out.float())
        return out

    def traced(finished):
        decoding[0] = True
        try:
            return decode(finished)
        finally:
            decoding[0] = False
    tok0, sec0 = eng.admission_tokens, eng.admission_seconds
    model.logits, eng._decode = logits, traced
    try:
        rids = [eng.add_request(p, max_new_tokens=n) for p, n in reqs[1:]]
        done = []
        while len(done) < N_PREFIX_HITS:
            done += eng.step()
    finally:
        del model.logits, eng._decode
    torch.cuda.synchronize()
    by_rid = {r.rid: r for r in done}
    if len(rec) != 1:
        raise AssertionError(f"the hit round took {len(rec)} admission "
                             "dispatches, not one")
    ttft = statistics.median(r.first_token_time - r.arrival_time
                             for r in done)
    return (eng, [by_rid[r].output for r in rids], rec[0], ttft,
            eng.admission_tokens - tok0, eng.admission_seconds - sec0)


def planted_prefix_logits(model, reqs):
    """The hit round's admission logits on a cached engine with ONE wrong
    shared page: the first hit slot's middle prefix page reads the trash
    page, as a stale or unset block-table entry would (swapping two
    shared pages would not do: attention does not see the order of its
    keys). Returns (logits, that slot); the engine is dropped after the
    round's first step."""
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048,
                                   enable_prefix_caching=True)
    eng.add_request(reqs[0][0], max_new_tokens=reqs[0][1])
    eng.run()
    attach, head, rec, planted = eng._attach_shared, model.logits, [], []

    def attach_wrong(slot, shared):
        n = attach(slot, shared)
        if not planted:
            planted.append(slot)
            eng._bt[slot, len(shared) // 2] = 0
        return n

    def logits(h, *a, **kw):
        out = head(h, *a, **kw)
        rec.append(out.float())
        return out
    eng._attach_shared, model.logits = attach_wrong, logits
    try:
        for p, n in reqs[1:]:
            eng.add_request(p, max_new_tokens=n)
        eng.step()
    finally:
        del model.logits
    return rec[0], planted[0]


def logits_disagree(a, b):
    """Which rows of the cached engine's admission logits ``a`` break the
    check against the uncached engine's ``b``: max |diff| <= 0.01 x
    max |logit| and equal argmax. Both engines run the same kernels and
    only the batch that a row's projections ran in differs, so the bound
    is a tenth of `path_check`'s (kernels against plain versions), which
    one wrong shared page stays under at 8B width."""
    scale = b.abs().max()
    return ((a - b).abs().amax(-1) > 0.01 * scale) \
        | (a.argmax(-1) != b.argmax(-1))


def serve_8b_prefix(model):
    """The prefix cache at 8B width: one warm request, then 8 requests
    sharing its 512-token prefix, on an engine with the cache and on one
    without. Exactly 8 hits reusing 4096 tokens, 4096 fewer admission
    tokens, the hit round's admission logits within `logits_disagree`'s
    bound of the uncached engine's and with equal argmax on every row,
    and every page free once the trie is drained. A planted wrong shared
    page must break that check."""
    import torch
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    reqs = prefix_requests(model.config.vocab_size)
    reset_launch_counts()
    cached = prefix_run(model, reqs, True)
    counts = dict(launch_counts)
    plain = prefix_run(model, reqs, False)
    eng = cached[0]
    check_serving_counts(eng, counts, model.config.num_hidden_layers)
    reused = N_PREFIX_HITS * PREFIX_LEN
    saved = plain[4] - cached[4]
    a, b = cached[2], plain[2]
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).tolist()
    same = [x == y for x, y in zip(cached[1], plain[1])]
    bad, slot = planted_prefix_logits(model, reqs)
    check_eager_equal("prefix (cached)", cached[1],
                      prefix_run(model, reqs, True, graphs=False)[1])
    planted_diff = (bad[slot] - b[slot]).abs().max().item()
    planted_caught = bool(logits_disagree(bad, b)[slot])
    parts = {i: next((j for j, (x, y) in enumerate(zip(p, q)) if x != y),
                     min(len(p), len(q)))
             for i, (p, q, eq) in enumerate(zip(cached[1], plain[1], same))
             if not eq}
    rec = dict(prefix_hits=eng.prefix_hits,
               prefix_tokens_reused=eng.prefix_tokens_reused,
               admission_tokens_cached=cached[4],
               admission_tokens_uncached=plain[4],
               ttft_p50_s_cached=cached[3], ttft_p50_s_uncached=plain[3],
               admission_tokens_per_s_cached=cached[4] / cached[5],
               admission_tokens_per_s_uncached=plain[4] / plain[5],
               max_abs_logit_diff=diff, max_abs_logit=scale,
               argmax_agrees=agree, streams_equal=sum(same),
               first_parting_token=parts,
               planted_wrong_page_diff=planted_diff,
               planted_argmax_agrees=bool(bad[slot].argmax()
                                          == b[slot].argmax()),
               planted_caught=planted_caught)
    log("serving_prefix " + json.dumps(rec))
    if eng.prefix_hits != N_PREFIX_HITS or eng.prefix_tokens_reused != reused:
        raise AssertionError("prefix cache hits or reused tokens off")
    if saved != reused:
        raise AssertionError(f"cached admission saved {saved} tokens, not "
                             f"{reused}")
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()) \
            or a.shape != (N_PREFIX_HITS, model.config.vocab_size) \
            or logits_disagree(a, b).any():
        raise AssertionError("cached and uncached admission logits "
                             "disagree")
    if not planted_caught:
        raise AssertionError("a wrong shared page passes the logits check")
    while eng._evict_one():
        pass
    eng.check_invariants()
    if len(eng._free) != eng.num_pages - 1 or eng._page_rc[1:].any():
        raise AssertionError("pages held after the trie was drained")
    return cached[1]



def serve_8b_quant(model, reqs, weights, n_requests):
    """Serve the first `n_requests` of `reqs` on the same bf16 8B model
    object with ``quant=QuantServingConfig(weights, "int8")`` and check
    the launch counts exactly. Returns (counts, the engine's quantized
    weights, the streams); the engine itself is freed."""
    import torch
    from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                                 QuantServingConfig)
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    L = model.config.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(model, max_batch_size=8,
                                   max_seq_len=2048,
                                   quant=QuantServingConfig(weights, "int8"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if eng.quant_weight_layers != 7 * L + 1:
        raise AssertionError(f"{eng.quant_weight_layers} quantized "
                             f"weights, expected {7 * L + 1}")
    reqs = reqs[:n_requests]
    reset_launch_counts()
    t0 = time.perf_counter()
    for p, new in reqs:
        eng.add_request(p, max_new_tokens=new)
    done = []
    while len(done) < len(reqs):
        done += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    by_rid = {r.rid: r for r in done}
    for rid, (_, new) in enumerate(reqs):
        r = by_rid[rid]
        if r.status != "finished" or len(r.output) != new:
            raise AssertionError(f"quantized request {rid}: {r.status} "
                                 f"with {len(r.output)} of {new} tokens")
    eng.check_invariants()
    if len(eng._free) != eng.num_pages - 1:
        raise AssertionError("pages still held after the quantized run")
    nd = eng.num_dispatches
    want = {"rms_norm": (2 * L + 1) * nd, "ragged_paged_attention": 0,
            "ragged_paged_attention_int8kv": L * nd,
            "dequant_matmul": (7 * L + 1) * nd, "lora_epilogue": 0,
            "paged_attention": 0,
**NO_TRAINING}
    log(f"launches ({weights} weights, int8 KV) {counts} expected {want} "
        f"over {nd} dispatches ({eng.num_admission_dispatches} admission, "
        f"{eng.num_decode_dispatches} decode)")
    if counts != want:
        raise AssertionError("quantized launch counts do not match the "
                             "dispatches")
    stats = serving_stats(eng, done, wall)
    # every dispatch makes the same launches: split by the dispatch kind
    stats.update(dequant_matmul_launches=dict(
        admission=(7 * L + 1) * eng.num_admission_dispatches,
        decode=(7 * L + 1) * eng.num_decode_dispatches))
    info = eng.cache_memory_info()
    stats.update(weights=weights, kv="int8", page_bytes=info["page_bytes"],
                 kv_pool_gib=info["bytes_pool"] / 2 ** 30,
                 quant_weight_bytes=eng.quant_weight_bytes,
                 quant_weight_gib=eng.quant_weight_bytes / 2 ** 30,
                 quant_build_s=build_s)
    tag = "serving_quant" if weights == "int8" else "serving_quant_fp8"
    log(f"{tag} " + json.dumps(stats))
    qweights = eng._qweights
    del eng
    streams = [by_rid[rid].output for rid in range(len(reqs))]
    check_eager_equal(tag, streams, eager_streams(
        model, reqs, quant=QuantServingConfig(weights, "int8")))
    return counts, qweights, streams


def serve_8b_lora(model, reqs):
    """Serve `reqs` on the same bf16 8B model object round-robin over the
    base and `LORA_ADAPTERS` (seeded rank-16 deltas on the seven matmuls
    of every layer, registered with and installed through a
    `FleetModelStore`) and check the launch counts exactly. Returns
    (counts, the engine), the engine for `path_check`."""
    import torch
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.serving import FleetModelStore, model_id
    from paddle_tpu_torch.tools.profile_decode import seeded_lora_deltas
    L = model.config.num_hidden_layers
    t0 = time.perf_counter()
    store = FleetModelStore(base_model="llama3_8b", max_rank=LORA_RANK)
    for i, name in enumerate(LORA_ADAPTERS):
        store.register_adapter(name, seeded_lora_deltas(model, 100 + i,
                                                        LORA_RANK))
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048)
    for name in LORA_ADAPTERS:
        store.ensure("card0", eng, model_id("llama3_8b", name))
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    if eng.lora_adapters_resident != len(LORA_ADAPTERS):
        raise AssertionError("adapters not resident after ensure()")
    names = (None,) + LORA_ADAPTERS
    reset_launch_counts()
    t0 = time.perf_counter()
    for i, (p, new) in enumerate(reqs):
        eng.add_request(p, max_new_tokens=new,
                        adapter=names[i % len(names)])
    done = []
    while len(done) < len(reqs):
        done += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    by_rid = {r.rid: r for r in done}
    for rid, (_, new) in enumerate(reqs):
        r = by_rid[rid]
        if r.status != "finished" or len(r.output) != new:
            raise AssertionError(f"LoRA request {rid}: {r.status} with "
                                 f"{len(r.output)} of {new} tokens")
    eng.check_invariants()
    if len(eng._free) != eng.num_pages - 1:
        raise AssertionError("pages still held after the LoRA run")
    nd = eng.num_dispatches
    want = {"rms_norm": (2 * L + 1) * nd, "ragged_paged_attention": L * nd,
            "ragged_paged_attention_int8kv": 0, "dequant_matmul": 0,
            "lora_epilogue": 7 * L * nd, "paged_attention": 0,
**NO_TRAINING}
    log(f"launches (LoRA) {counts} expected {want} over {nd} dispatches "
        f"({eng.num_admission_dispatches} admission, "
        f"{eng.num_decode_dispatches} decode)")
    if counts != want:
        raise AssertionError("LoRA launch counts do not match the "
                             "dispatches")
    stats = serving_stats(eng, done, wall)
    stats.update(lora_epilogue_launches=dict(
        admission=7 * L * eng.num_admission_dispatches,
        decode=7 * L * eng.num_decode_dispatches))
    stats.update(adapters=len(LORA_ADAPTERS), rank=LORA_RANK,
                 adapted_matmuls=7 * L,
                 lora_adapter_bytes=eng.lora_adapter_bytes,
                 lora_adapter_gib=eng.lora_adapter_bytes / 2 ** 30,
                 register_and_install_s=install_s, store=store.stats())
    log("serving_lora " + json.dumps(stats))
    check_eager_equal(
        "serving_lora", [by_rid[rid].output for rid in range(len(reqs))],
        eager_streams(model, reqs, adapters=names, prepare=lambda e: [
            store.ensure("card1", e, model_id("llama3_8b", name))
            for name in LORA_ADAPTERS]))
    return counts, eng


def serve_8b_legacy(model, reqs):
    """Serve the first `N_LEGACY_REQUESTS` of `reqs` on the same bf16 8B
    model object with ``attention_impl="legacy"`` and check the launch
    counts exactly. Returns (the counts, the streams)."""
    import torch
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    L = model.config.num_hidden_layers
    reqs = reqs[:N_LEGACY_REQUESTS]
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(model, max_batch_size=8,
                                   max_seq_len=2048,
                                   attention_impl="legacy")
    reset_launch_counts()
    t0 = time.perf_counter()
    for p, new in reqs:
        eng.add_request(p, max_new_tokens=new)
    done = []
    while len(done) < len(reqs):
        done += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    by_rid = {r.rid: r for r in done}
    for rid, (_, new) in enumerate(reqs):
        r = by_rid[rid]
        if r.status != "finished" or len(r.output) != new:
            raise AssertionError(f"legacy request {rid}: {r.status} with "
                                 f"{len(r.output)} of {new} tokens")
    eng.check_invariants()
    if len(eng._free) != eng.num_pages - 1:
        raise AssertionError("pages still held after the legacy run")
    check_legacy_counts(eng, counts, L)
    log("serving_legacy " + json.dumps(serving_stats(eng, done, wall)))
    del eng
    streams = [by_rid[rid].output for rid in range(len(reqs))]
    check_eager_equal("serving_legacy", streams,
                      eager_streams(model, reqs, attention_impl="legacy"))
    return counts, streams


def check_legacy_counts(eng, counts, L):
    """A legacy serving run's launches: 2L + 1 RMSNorms a dispatch and L
    paged attentions a decode dispatch, nothing else (the page scatter
    and the prefill's attention launch no kernel)."""
    nd = eng.num_dispatches
    want = {"rms_norm": (2 * L + 1) * nd, "ragged_paged_attention": 0,
            "ragged_paged_attention_int8kv": 0, "dequant_matmul": 0,
            "lora_epilogue": 0,
            "paged_attention": L * eng.num_decode_dispatches,
            **NO_TRAINING}
    log(f"launches (legacy) {counts} expected {want} over {nd} dispatches "
        f"({eng.num_admission_dispatches} prefill, "
        f"{eng.num_decode_dispatches} decode)")
    if counts != want:
        raise AssertionError("legacy launch counts do not match the "
                             "dispatches")


# `generate_8b`: 4 prompts of 512 tokens, 32 new tokens each; beam
# search at B = 1
GEN_BATCH = 4
GEN_PROMPT = 512
GEN_NEW = 32
GEN_BEAMS = 4
# `serve_8b_legacy_chunked`: the chunk of the legacy chunked prefill
LEGACY_CHUNK = 256


def gen_prefill_check(model, ids, cache_len, want=None, near_ties=False):
    """`generate()`'s prefill (one causal pass over the prompts into
    zeroed caches, the last row through the vocab matmul) of a bf16
    model through the kernels and through the plain versions: the
    launches of the kernel pass (``want``, by default the 8B Llama's),
    and the two logits within `path_check`'s 0.1 x max |logit| with equal
    argmax on every row; with ``near_ties`` a row's two picks may differ
    where the plain logits of both lie within the max |logit diff| (GPT-2
    at random init: |logits| near 200, where one bf16 step is 1.0)."""
    import torch
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = model.config
    logits = {}
    for use_kernel in (True, False):
        caches = [tuple(torch.zeros(ids.shape[0], cache_len,
                                    cfg.num_key_value_heads, cfg.head_dim,
                                    device="cuda", dtype=torch.bfloat16)
                        for _ in range(2))
                  for _ in range(cfg.num_hidden_layers)]
        reset_launch_counts()
        with torch.no_grad():
            hidden = model.model(ids, caches, use_kernel=use_kernel)
            logits[use_kernel] = model.logits(hidden[:, -1]).float()
        if use_kernel:
            counts = dict(launch_counts)
        del caches, hidden
    a, b = logits[True], logits[False]
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).tolist()
    if near_ties:
        picked = b.gather(1, a.argmax(-1, keepdim=True))[:, 0]
        agree = (picked >= b.amax(-1) - diff).tolist()
    L = cfg.num_hidden_layers
    log(f"generate prefill check: max |logit diff| {diff:.4g} (max |logit| "
        f"{scale:.4g}), argmax agrees per row {agree}, kernel launches "
        f"{ {k: n for k, n in counts.items() if n} }")
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()) \
            or a.shape != (ids.shape[0], cfg.vocab_size) \
            or diff > 0.1 * scale or not all(agree):
        raise AssertionError("generate prefill: kernel and plain logits "
                             "disagree")
    want = want or {"flash_attention_fwd": L, "rms_norm": 2 * L + 1}
    if counts != {**{k: 0 for k in counts}, **want}:
        raise AssertionError("generate prefill: launches off")
    return diff, scale


def gen_timed(model, ids, **kw):
    """(ids, scores, wall seconds, launches) of one `generate()` call,
    the launch counts set to 0 just before it."""
    import torch
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    toks, scores = model.generate(ids, max_new_tokens=GEN_NEW, **kw)
    torch.cuda.synchronize()
    return toks, scores, time.perf_counter() - t0, dict(launch_counts)


def sync_free_decode(model, ids, **kw):
    """`generate()` with its decode loop (`_generate` / `_beam_generate`:
    the first token from the prefill's logits, then every cached step)
    run under ``torch.cuda.set_sync_debug_mode("error")``: any call in
    the loop that waits for the card raises. Returns the ids."""
    import torch
    name = "_beam_generate" if kw.get("decode_strategy") == "beam_search" \
        else "_generate"
    loop = getattr(model, name)

    def checked(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    setattr(model, name, checked)
    try:
        toks, _ = model.generate(ids, max_new_tokens=GEN_NEW, **kw)
    finally:
        delattr(model, name)
    return toks


def generate_8b(model):
    """`LlamaForCausalLM.generate()` on the 8B model, bf16: 4 prompts of
    512 tokens and 32 new tokens, greedy, top-p 0.9 sampling (seeded;
    two runs equal) and beam search K = 4 at B = 1. The prefill's logits
    through the kernels against the plain versions; exact launches each
    run (flash attention forward L, in the prefill; RMSNorm (2L + 1) a
    forward, 32 forwards); every decode loop free of synchronizing
    calls; prefill ms, decode ms a step, tokens/s, peak memory."""
    import torch
    cfg = model.config
    L = cfg.num_hidden_layers
    rng = np.random.default_rng(18)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (GEN_BATCH, GEN_PROMPT))
                           .astype(np.int32)).cuda()
    cache_len = GEN_PROMPT + GEN_NEW
    diff, scale = gen_prefill_check(model, ids, cache_len)
    want = {"flash_attention_fwd": L, "rms_norm": (2 * L + 1) * GEN_NEW}
    sampling = dict(decode_strategy="sampling", top_p=0.9)
    beam = dict(decode_strategy="beam_search", num_beams=GEN_BEAMS)
    # the warm-up runs, each decode loop under the sync check
    greedy0 = sync_free_decode(model, ids)
    sync_free_decode(model, ids, generator=torch.Generator("cuda")
                     .manual_seed(1), **sampling)
    sync_free_decode(model, ids[:1], **beam)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    greedy, gscores, wall, counts = gen_timed(model, ids)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    runs = {"greedy": counts}
    samples = []
    for _ in range(2):
        toks, _, swall, runs["sampling"] = gen_timed(
            model, ids, generator=torch.Generator("cuda").manual_seed(7),
            **sampling)
        samples.append(toks)
    btoks, bscore, bwall, runs["beam"] = gen_timed(model, ids[:1], **beam)
    with torch.no_grad():
        caches_t = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model._zero_caches_prefill(ids, cache_len)
            torch.cuda.synchronize()
            caches_t.append(time.perf_counter() - t0)
    prefill_s = statistics.median(caches_t)
    rec = dict(batch=GEN_BATCH, prompt_len=GEN_PROMPT, new_tokens=GEN_NEW,
               prefill_max_abs_logit_diff=diff, prefill_max_abs_logit=scale,
               prefill_ms=1e3 * prefill_s,
               decode_ms_per_step=1e3 * (wall - prefill_s) / (GEN_NEW - 1),
               greedy_wall_s=wall,
               greedy_tokens_per_s=GEN_BATCH * GEN_NEW / wall,
               sampling_wall_s=swall, beam_wall_s=bwall,
               beam_score=bscore.item(), peak_mem_gib=peak,
               greedy_equal_warm_up=bool(torch.equal(greedy, greedy0)),
               sampling_runs_equal=bool(torch.equal(*samples)),
               sampled_tokens_equal_greedy=int((samples[0] == greedy)
                                               .sum()),
               launches={k: {n: c for n, c in v.items() if c}
                         for k, v in runs.items()})
    log("generate_8b " + json.dumps(rec))
    for name, got in runs.items():
        if got != {**{k: 0 for k in got}, **want}:
            raise AssertionError(f"generate_8b {name}: launches {got}, "
                                 f"expected {want}")
    if not (torch.equal(greedy, greedy0) and torch.equal(*samples)):
        raise AssertionError("generate_8b: a repeated run differs")
    if greedy.shape != (GEN_BATCH, GEN_NEW) or btoks.shape != (1, GEN_NEW) \
            or not (torch.isfinite(gscores).all()
                    and torch.isfinite(bscore).all()) \
            or int(greedy.min()) < 0 or int(greedy.max()) >= cfg.vocab_size:
        raise AssertionError("generate_8b: outputs malformed")
    return runs["greedy"]


def serve_8b_dense(model, reqs):
    """The first `N_LEGACY_REQUESTS` of `reqs` on ``kv_layout="dense"``
    (per-slot (8, 2048, HK, D) caches, the legacy bucketed prefill and
    the dense (B, 1) decode program, captured): exact launches (RMSNorm
    (2L + 1) a dispatch, no attention kernel: the dense decode's
    attention is plain, as in JAX), streams bitwise equal to an eager
    engine's, step ms, TTFT p50, peak memory."""
    reqs = reqs[:N_LEGACY_REQUESTS]
    eng, streams, counts, stats = legacy_graphed_run(model, reqs,
                                                     kv_layout="dense")
    if eng._decode_program is None or eng._decode_program.graph is None:
        raise AssertionError("the dense decode program was not captured")
    stats.update(cache_memory=eng.cache_memory_info())
    log("serving_dense " + json.dumps(stats))
    del eng
    check_eager_equal("serving_dense", streams,
                      eager_streams(model, reqs, kv_layout="dense"))
    return counts


def admission_logits_run(model, reqs, warm=True, planted=False, **kw):
    """Serve ``reqs`` on an eager 8B legacy engine (``_graphs=False``: the
    logits are read inside the forward), recording each request's
    first-token logits (the last real row of its admission: a bucketed,
    suffix or last-chunk prefill). With ``warm`` the first request is
    served alone first and the rest are the round that is recorded.
    With ``planted`` the round's first suffix prefill reads the trash
    page in place of its middle shared page, and the run stops after
    that admission. Returns (engine, streams, logits (n, V))."""
    import torch
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048,
                                   attention_impl="legacy", _graphs=False,
                                   **kw)
    if warm:
        eng.add_request(reqs[0][0], max_new_tokens=reqs[0][1])
        eng.run()
        reqs = reqs[1:]
    last, firsts = [None], []
    head = model.logits

    def logits(h, *a, **k):
        out = head(h, *a, **k)
        last[0] = out
        return out

    def first_of(fn):
        # an admission's last logits call is its first token's row
        def call(*a, **k):
            out = fn(*a, **k)
            firsts.append(last[0][-1].float())
            return out
        return call
    admit_shared = eng._admit_shared
    up = eng._upload

    def planted_shared(slot, req, prompt, pages):
        def upload(*arrays, dst=None):
            if dst is not None and len(arrays) == 4:   # ids, row, pages,
                wrong = np.array(arrays[2], np.int32)  # sampling key
                wrong[len(wrong) // 2] = 0
                arrays = (*arrays[:2], wrong, arrays[3])
            return up(*arrays, dst=dst)
        eng._upload = upload
        try:
            return admit_shared(slot, req, prompt, pages)
        finally:
            del eng._upload
    eng._admit_shared = first_of(planted_shared if planted
                                 else admit_shared)
    eng._admit_chunked = first_of(eng._admit_chunked)
    eng._legacy_prefill = first_of(eng._legacy_prefill)
    model.logits = logits
    try:
        rids = [eng.add_request(p, max_new_tokens=n) for p, n in reqs]
        if planted:
            eng.step()
            return eng, None, torch.stack(firsts)
        out = eng.run()
    finally:
        del model.logits
        del eng._admit_shared, eng._admit_chunked, eng._legacy_prefill
    torch.cuda.synchronize()
    return eng, [out[r] for r in rids], torch.stack(firsts)


def legacy_graphed_run(model, reqs, warm=False, **kw):
    """``reqs`` on a graphed 8B legacy engine (the program cache; paged,
    or dense with ``kv_layout="dense"``), the launch counts set to 0 just
    before (after the warm request with ``warm``) and checked exactly
    after: RMSNorm (2L + 1) a dispatch, the paged attention L a paged
    decode dispatch, nothing else. Returns (engine, streams, launches,
    stats of the counted run)."""
    import torch
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048,
                                   attention_impl="legacy", **kw)
    if warm:
        eng.add_request(reqs[0][0], max_new_tokens=reqs[0][1])
        eng.run()
        reqs = reqs[1:]
    disp = eng.num_admission_dispatches, eng.num_decode_dispatches
    reset_launch_counts()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=n) for p, n in reqs]
    done = []
    while len(done) < len(reqs):
        done += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    by_rid = {r.rid: r for r in done}
    for rid, (_, new) in zip(rids, reqs):
        r = by_rid[rid]
        if r.status != "finished" or len(r.output) != new:
            raise AssertionError(f"legacy request {rid}: {r.status} with "
                                 f"{len(r.output)} of {new} tokens")
    L = model.config.num_hidden_layers
    n_adm = eng.num_admission_dispatches - disp[0]
    n_dec = eng.num_decode_dispatches - disp[1]
    want = {**{k: 0 for k in counts},
            "rms_norm": (2 * L + 1) * (n_adm + n_dec),
            "paged_attention": L * n_dec if eng.layout == "paged" else 0}
    if counts != want:
        raise AssertionError(f"legacy launches {counts}, expected {want} "
                             f"over {n_adm} admission and {n_dec} decode "
                             "dispatches")
    ttft = sorted(by_rid[r].first_token_time - by_rid[r].arrival_time
                  for r in rids)
    stats = dict(requests=len(reqs), wall_s=wall,
                 ttft_p50_s=statistics.median(ttft),
                 admission_dispatches=n_adm, decode_dispatches=n_dec,
                 decode_step_ms=1e3 * eng.decode_seconds
                 / eng.num_decode_dispatches,
                 graph_captures=eng.num_graph_captures,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches={k: n for k, n in counts.items() if n})
    return eng, [by_rid[r].output for r in rids], counts, stats


def fresh_prefix_logits(model, reqs, pad=16):
    """Each hit's first-token logits computed as the legacy engine's
    suffix program computes them (the suffix padded to its ``pad``
    bucket, at ``position_offset`` 512 over 512 + bucket keys under the
    key-validity mask, the same shapes), but over shared rows computed
    afresh by a masked prefill of the prefix tokens alone instead of
    read from the pages: (hits, V). Cached against uncached also differs
    in the batch of the suffix rows' projections, which cuBLAS does not
    compute bitwise alike at every size; this reference differs from the
    cached admission only in where the shared rows come from."""
    import torch
    cfg = model.config
    hk, hd = cfg.num_key_value_heads, cfg.head_dim
    prefix = torch.from_numpy(np.asarray(reqs[1][0][:PREFIX_LEN],
                                         np.int32)).cuda()[None]
    dt = next(model.parameters()).dtype
    pre = [tuple(torch.zeros(1, PREFIX_LEN, hk, hd, device="cuda", dtype=dt)
                 for _ in range(2)) for _ in range(cfg.num_hidden_layers)]
    out = []
    with torch.no_grad():
        model.model(prefix, pre, attention_mask=torch.ones(
            1, PREFIX_LEN, dtype=torch.bool, device="cuda"))
        for p, _ in reqs[1:]:
            suffix = np.asarray(p[PREFIX_LEN:], np.int32)
            n = len(suffix)
            bucket = -(-n // pad) * pad
            ids = torch.zeros(1, bucket, dtype=torch.int32, device="cuda")
            ids[0, :n] = torch.from_numpy(suffix).cuda()
            caches = [tuple(torch.cat([c, c.new_zeros(1, bucket, hk, hd)],
                                      1) for c in layer) for layer in pre]
            valid = (torch.arange(PREFIX_LEN + bucket, device="cuda")
                     < PREFIX_LEN + n)[None]
            logits = model(ids, caches, attention_mask=valid,
                           rows=torch.tensor([n - 1], device="cuda"),
                           position_offset=PREFIX_LEN)
            out.append(logits[-1].float())
    return torch.stack(out)


def serve_8b_legacy_prefix(model):
    """The prefix mix of `serve_8b_prefix` (a warm request, then 8
    requests sharing its 512-token prefix) on the legacy path: graphed
    with the cache (exact launches, hits, tokens reused, every page back
    once the trie drains), its streams bitwise equal to the eager cached
    engine's; the round's first-token logits within `logits_disagree`'s
    bound of `fresh_prefix_logits` (the same suffix prefills over shared
    rows computed afresh), and within `path_check`'s 0.1 x max |logit|
    of the uncached engine's, argmax equal on every row; a planted wrong
    shared page (the suffix program gathering the trash page in place
    of the middle prefix page) must break the first check."""
    import torch
    reqs = prefix_requests(model.config.vocab_size)
    eng, streams, counts, stats = legacy_graphed_run(
        model, reqs, warm=True, enable_prefix_caching=True)
    reused = N_PREFIX_HITS * PREFIX_LEN
    hits, got_reused = eng.prefix_hits, eng.prefix_tokens_reused
    suffix_keys = list(eng._suffix_programs)
    while eng._evict_one():
        pass
    eng.check_invariants()
    if len(eng._free) != eng.num_pages - 1 or eng._page_rc[1:].any():
        raise AssertionError("legacy prefix: pages held after the trie "
                             "was drained")
    del eng
    ceng, cstreams, a = admission_logits_run(model, reqs,
                                             enable_prefix_caching=True)
    peng, pstreams, b = admission_logits_run(model, reqs)
    saved = peng.admission_tokens - ceng.admission_tokens
    del ceng, peng
    _, _, bad = admission_logits_run(model, reqs, planted=True,
                                     enable_prefix_caching=True)
    ref = fresh_prefix_logits(model, reqs)
    # every hit of the planted round read a wrong page: the first is held
    planted_caught = bool(logits_disagree(bad, ref)[0])
    scale = b.abs().max().item()
    stats.update(prefix_hits=hits, prefix_tokens_reused=got_reused,
                 admission_tokens_saved=saved, suffix_programs=suffix_keys,
                 max_abs_logit=scale,
                 fresh_row_diffs=(a - ref).abs().amax(-1).tolist(),
                 uncached_row_diffs=(a - b).abs().amax(-1).tolist(),
                 argmax_agrees_uncached=(a.argmax(-1)
                                         == b.argmax(-1)).tolist(),
                 streams_equal_uncached=sum(x == y for x, y in
                                            zip(cstreams, pstreams)),
                 planted_wrong_page_diff=(bad[0] - ref[0]).abs().max().item(),
                 planted_caught=planted_caught)
    log("serving_legacy_prefix " + json.dumps(stats))
    check_eager_equal("serving_legacy_prefix", streams, cstreams)
    if hits != N_PREFIX_HITS or got_reused != reused or saved != reused:
        raise AssertionError("legacy prefix: hits, reused or saved tokens "
                             "off")
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()) \
            or a.shape != (N_PREFIX_HITS, model.config.vocab_size) \
            or logits_disagree(a, ref).any():
        raise AssertionError("legacy prefix: the cached first-token logits "
                             "disagree with the fresh-prefix reference")
    if (a - b).abs().max().item() > 0.1 * scale \
            or (a.argmax(-1) != b.argmax(-1)).any():
        raise AssertionError("legacy prefix: cached and uncached first-"
                             "token logits disagree")
    if not planted_caught:
        raise AssertionError("legacy prefix: a wrong shared page passes the "
                             "logits check")
    return counts


def serve_8b_legacy_chunked(model, reqs):
    """The first `N_LEGACY_REQUESTS` of `reqs` on the legacy path at
    ``prefill_chunk=256``: graphed (the chunk program, every chunk a
    dispatch: exact launches, paged attention L a decode dispatch), its
    streams bitwise equal to the eager engine's; each request's
    first-token logits against the unchunked engine's within
    `logits_disagree`'s bound with equal argmax."""
    import torch
    reqs = reqs[:N_LEGACY_REQUESTS]
    eng, streams, counts, stats = legacy_graphed_run(
        model, reqs, prefill_chunk=LEGACY_CHUNK)
    chunks = sum(-(-len(p) // LEGACY_CHUNK) for p, _ in reqs
                 if len(p) >= LEGACY_CHUNK)
    if eng._chunk_program is None or eng._chunk_program.runs != chunks \
            or eng._chunk_program.graph is None:
        raise AssertionError("legacy chunked: the chunk program did not run "
                             f"{chunks} chunks or was not captured")
    del eng
    _, cstreams, a = admission_logits_run(model, reqs, warm=False,
                                          prefill_chunk=LEGACY_CHUNK)
    _, pstreams, b = admission_logits_run(model, reqs, warm=False)
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    stats.update(chunk=LEGACY_CHUNK, chunks=chunks,
                 max_abs_logit_diff=diff, max_abs_logit=scale,
                 argmax_agrees=(a.argmax(-1) == b.argmax(-1)).tolist(),
                 streams_equal_unchunked=sum(x == y for x, y in
                                             zip(cstreams, pstreams)))
    log("serving_legacy_chunked " + json.dumps(stats))
    check_eager_equal("serving_legacy_chunked", streams, cstreams)
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()) \
            or a.shape != (len(reqs), model.config.vocab_size) \
            or logits_disagree(a, b).any():
        raise AssertionError("legacy chunked: first-token logits disagree "
                             "with the unchunked engine's")
    return counts


# -- speculative decoding and engine sampling ---------------------------
# `serve_8b_spec`: the draft's proposals a round, and the requests the
# target serves as its own draft (the full-acceptance case)
SPEC_K = 4
N_SELF_DRAFT = 8
# the planted wrong accept's requests (of `make_requests`)
N_PLANTED_SPEC = 4
# the near-tie rule: a spec stream may leave the plain one only at a step
# where the plain engine's top-2 logit gap is below this share of the
# row's max |logit| (the verify rows run tensor-core attention with P in
# bf16 and other cuBLAS row batches than a decode row: up to ~0.01 x max
# |logit| apart, PERF.md §7)
NEAR_TIE = 0.01
# `serve_8b_sample`: the sampled requests, on the ragged and the legacy
# path, and the sampling knobs
N_SAMPLE_REQUESTS = 8
N_SAMPLE_LEGACY = 4
SAMPLE_KW = dict(do_sample=True, temperature=0.8, top_p=0.9)
# the spec engine's attention launches timed beside the decode row's: a
# verify dispatch (8 slots of k + 1 live rows in 8-row q blocks, contexts
# up to 2048) and a draft-scan step at the 1B draft's head dim 64 (two
# dead rows with query_len 0)
VERIFY_SEQS = [(SPEC_K + 1, c) for c in (5, 37, 300, 517, 1024, 1500, 2000,
                                         2048)]
DRAFT_SEQS = [(1, 1), (1, 33), (0, 300), (1, 517), (1, 1024), (0, 1500),
              (1, 2000), (1, 2048)]
SPEC_ATTN_CASES = [("verify", VERIFY_SEQS, 8, (32, 8, 128)),
                   ("draft_decode", DRAFT_SEQS, 1, (32, 8, 64))]


def draft_1b_config():
    """The 8B spec phases' draft: the widths of Meta's published
    Llama-3.2-1B config (hidden 2048, intermediate 8192, 16 layers, 32
    heads and 8 KV heads of dim 64, vocab 128256, tied embeddings, rope
    theta 500000) with a rope table of the serving runs' 2048 positions;
    weights random from a seed: the shape is real, the weights are
    not."""
    from paddle_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=LLAMA_VOCAB, hidden_size=2048,
                       intermediate_size=8192, num_hidden_layers=16,
                       num_attention_heads=32, num_key_value_heads=8,
                       max_position_embeddings=2048, rope_theta=500000.0,
                       tie_word_embeddings=True)


def spec_attn_phase(results):
    """The ragged attention kernel at the spec engine's shapes (bf16):
    against the plain version within ATTN_ATOL, dead rows exact zeros,
    then timed (`timed_in_turns`) beside a copy of the live pages."""
    import torch
    from paddle_tpu_torch.ops import ragged_paged_attention as ra
    gen = torch.Generator(device="cuda").manual_seed(19)
    for label, seqs, bq, heads in SPEC_ATTN_CASES:
        scale = 1.0 / math.sqrt(heads[2])
        first = attn_case(seqs, bq, 0, torch.bfloat16, None, gen,
                          heads=heads)
        nbytes, ops = first[2], first[3]
        sets = [first] + [attn_case(seqs, bq, 0, torch.bfloat16, None, gen,
                                    heads=heads)
                          for _ in range(rotation_sets(nbytes) - 1)]
        sets = [(a, live_pages(a, None)) for a, _, _, _ in sets]
        args = sets[0][0]
        out = ra._ragged_cuda(*args, scale, None, bq)
        ref = ra.ragged_paged_attention_ref(*args, scale, None, None)
        err = (out.float() - ref.float()).abs().max().item()
        seq, _ = ra.token_arrays(args[3].cpu().numpy(), args[4].cpu().numpy(),
                                 args[5].cpu().numpy(), args[0].shape[0])
        dead_zero = bool((out[torch.from_numpy(seq < 0).cuda()] == 0).all())
        times = timed_in_turns(
            {"split": lambda st: ra._ragged_cuda(*st[0], scale, None, bq),
             "copy": lambda st: copy_live(st[0][1], st[0][2], st[1])}, sets)
        plain = time_ms(lambda: ra.ragged_paged_attention_ref(
            *args, scale, None, None), iters=5, warmup=1)
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        tm = times["split"]
        rec = dict(kernel="ragged_paged_attention", case=label,
                   dtype="bfloat16", block_q=bq, heads=list(heads),
                   seqs=seqs, design="split", path_design=False,
                   max_abs_err=err, tol=ATTN_ATOL["bfloat16"],
                   dead_rows_zero=dead_zero, ms=tm["ms"],
                   device_ms=tm["device_ms"], host_us=tm["host_us"],
                   plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                   bound_fraction=b_ms / tm["device_ms"],
                   copy_device_ms=times["copy"]["device_ms"],
                   library_ms=None, rotation_sets=len(sets))
        log("kernel " + json.dumps(rec))
        results.append(rec)
        if not (err <= ATTN_ATOL["bfloat16"] and dead_zero
                and torch.isfinite(out).all()):
            raise AssertionError(f"ragged attention at the spec shapes "
                                 f"disagrees: {rec}")
        del sets, args, out, ref
        torch.cuda.empty_cache()


def plain_gaps(model, reqs):
    """The plain engine's streams of ``reqs`` and, at every token it
    emits, its top-2 logit gap over the row's max |logit|: an eager 8B
    engine (``_graphs=False``, so that the logits can be read in the
    forward) with the vocab head wrapped to record the row of each slot
    that emits in a dispatch (a decode step's live slots, an admission's
    last pieces): (streams, {(request index, token index): gap ratio})."""
    import torch
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048,
                                   _graphs=False)
    head, decode, admit = model.logits, eng._decode, eng._dispatch_ragged
    gaps, live = {}, []

    def logits(h, *a, **kw):
        out = head(h, *a, **kw)
        if live:
            row = out.float()
            top = torch.topk(row, 2, dim=-1).values
            ratio = ((top[:, 0] - top[:, 1]) / row.abs().amax(-1)).tolist()
            for slot, key in live:
                gaps[key] = ratio[slot]
        return out

    def traced(finished):
        live[:] = [(i, (r.rid, len(r.output)))
                   for i, r in enumerate(eng._slot_req) if r is not None]
        try:
            decode(finished)
        finally:
            live.clear()

    def traced_admit(batch, finished):
        # an admission's logits rows are its slots' sample rows, in slot
        # order
        live[:] = [(p["slot"], (p["req"].rid, len(p["req"].output)))
                   for p in batch if p["sample"]]
        try:
            return admit(batch, finished)
        finally:
            live.clear()
    model.logits = logits
    eng._decode = traced
    eng._dispatch_ragged = traced_admit
    try:
        rids = [eng.add_request(p, max_new_tokens=n) for p, n in reqs]
        out = eng.run()
    finally:
        del model.logits, eng._decode, eng._dispatch_ragged
    return [out[r] for r in rids], gaps


def first_divergences(want, got, gap_at):
    """Each stream of ``got`` that leaves ``want``: (its index, the first
    differing token index, ``gap_at(index, token index)``)."""
    out = []
    for i, (a, b) in enumerate(zip(want, got)):
        if a != b:
            d = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            out.append((i, d, gap_at(i, d)))
    return out


def near_ties_only(divs):
    return all(g is not None and g < NEAR_TIE for _, _, g in divs)


def spec_launches(eng, model, draft):
    """A spec run's launches: each layer's attention and every RMSNorm
    once per target dispatch (admission, verify) and once per draft
    forward (a backfill prefill is one, a draft scan K + 1); nothing
    else."""
    L, Ld = model.config.num_hidden_layers, draft.config.num_hidden_layers
    nt = eng.num_admission_dispatches + eng.num_decode_dispatches
    nd = eng.num_draft_prefills + (eng._spec_k + 1) * eng.num_draft_scans
    return {"rms_norm": (2 * L + 1) * nt + (2 * Ld + 1) * nd,
            "ragged_paged_attention": L * nt + Ld * nd,
            "ragged_paged_attention_int8kv": 0, "dequant_matmul": 0,
            "lora_epilogue": 0, "paged_attention": 0, **NO_TRAINING}


def spec_run(model, draft, reqs, graphs=True):
    """Serve ``reqs`` on a fresh 8B spec engine (``SpecConfig(draft,
    SPEC_K)``), graphed or eager, the launch counts and the peak memory
    reset before: (engine, streams, counts, stats)."""
    import torch
    from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                                 SpecConfig)
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048,
                                   spec_decode=SpecConfig(draft, k=SPEC_K),
                                   _graphs=graphs)
    reset_launch_counts()
    t0 = time.perf_counter()
    for p, new in reqs:
        eng.add_request(p, max_new_tokens=new)
    done = []
    while len(done) < len(reqs):
        done += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    by_rid = {r.rid: r for r in done}
    streams = [by_rid[rid].output for rid in range(len(reqs))]
    eng.check_invariants()
    if len(eng._free) != eng.num_pages - 1 \
            or len(eng._d_free) != eng._d_num_pages - 1:
        raise AssertionError("spec run: pages still held after the run")
    rounds = max(eng.num_spec_rounds, 1)
    ttft = sorted(r.first_token_time - r.arrival_time for r in done)
    info = eng.spec_info()
    stats = dict(requests=len(reqs), k=SPEC_K, wall_s=wall,
                 ttft_p50_s=statistics.median(ttft),
                 acceptance_rate=info["acceptance_rate"],
                 rounds=info["rounds"], proposed=info["proposed"],
                 accepted=info["accepted"],
                 decode_tokens=eng.decode_tokens,
                 decode_tokens_per_s=eng.decode_tokens / eng.decode_seconds,
                 tokens_per_round=eng.decode_tokens / rounds,
                 ms_per_round=1e3 * eng.decode_seconds / rounds,
                 draft_ms_per_round=1e3 * eng.spec_draft_seconds / rounds,
                 verify_ms_per_round=1e3 * eng.spec_verify_seconds / rounds,
                 admission_dispatches=eng.num_admission_dispatches,
                 verify_dispatches=eng.num_decode_dispatches,
                 draft_prefills=eng.num_draft_prefills,
                 draft_scans=eng.num_draft_scans,
                 graph_captures=eng.num_graph_captures,
                 graph_capture_s=eng.graph_capture_seconds,
                 verify_programs=[list(k) for k in eng._verify_programs],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches={k: n for k, n in counts.items() if n})
    return eng, streams, counts, stats


def spec_round_reads(model, draft, rounds=12):
    """Spec rounds of an 8-slot 8B spec engine (8 seeded prompts of
    32-1024 tokens), each under ``torch.cuda.set_sync_debug_mode("warn")``
    with `_harvest_sync` let through and counted. In a round whose
    programs all replay (no warm-up, no capture in it) the card is read
    exactly twice (the proposals, the verify picks), nothing else
    synchronizes, and the draft scan program runs once, as one graph
    replay. Returns the rounds checked."""
    import warnings
    import torch
    from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                                 SpecConfig)
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048,
                                   spec_decode=SpecConfig(draft, k=SPEC_K))
    rng = np.random.default_rng(2)
    for _ in range(8):
        eng.add_request(rng.integers(0, model.config.vocab_size,
                                     int(rng.integers(32, 1025))),
                        max_new_tokens=64)
    reads, read = [0], eng._harvest_sync

    def counted(t):
        reads[0] += 1
        torch.cuda.set_sync_debug_mode("default")
        try:
            return read(t)
        finally:
            torch.cuda.set_sync_debug_mode("warn")
    checked = []
    for _ in range(rounds):
        captures, n_rounds = eng.num_graph_captures, eng.num_spec_rounds
        n_progs = len(eng._programs())
        scan = eng._draft_scan_program
        scan_runs = scan.runs if scan is not None else 0
        torch.cuda.synchronize()
        eng._harvest_sync = counted
        reads[0] = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
                eng._harvest_sync = read
        syncs = [str(w.message)[:80] for w in caught
                 if "synchroniz" in str(w.message)]
        if eng.num_spec_rounds == n_rounds + 1 \
                and eng.num_graph_captures == captures \
                and n_progs == len(eng._programs()):
            scan = eng._draft_scan_program
            checked.append(dict(reads=reads[0], syncs=syncs,
                                scan_replays=scan.runs - scan_runs,
                                scan_graph=scan.graph is not None))
    eng.quiesce()
    log(f"spec round reads: {len(checked)} replay-only rounds of {rounds}: "
        f"{checked}")
    if len(checked) < 3 or any(
            c["reads"] != 2 or c["syncs"] or c["scan_replays"] != 1
            or not c["scan_graph"] for c in checked):
        raise AssertionError("spec rounds: not exactly two host reads and "
                             "one draft-scan replay a round")
    return len(checked)


def serve_8b_spec(model, reqs, want_streams):
    """The 16 requests of `serve_8b` on a graphed spec engine (k = 4) with
    the 1B-shaped draft, and the first `N_SELF_DRAFT` with the target as
    its own draft. For each: acceptance, rounds, proposed and accepted,
    decode tokens/s, ms a round with the draft's and the verify's host
    ms apart, TTFT p50, captures, peak memory, exact launches
    (`spec_launches`), and the streams against the plain engine's: equal,
    or each first divergence at a near-tie of the plain engine's logits
    (`plain_gaps`, NEAR_TIE). The 1B-draft run graphed against eager
    bitwise; two host reads a round (`spec_round_reads`); a planted wrong
    accept (one more proposal accepted than matched) must fail the
    stream check. Returns the draft model and `plain_gaps`' gaps."""
    import torch
    from paddle_tpu_torch.models import serving
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    t0 = time.perf_counter()
    draft = LlamaForCausalLM(draft_1b_config(), device="cuda",
                             dtype=torch.bfloat16, seed=1)
    plain, gaps = plain_gaps(model, reqs)
    same = sum(a == b for a, b in zip(plain, want_streams))
    log(f"spec: the plain eager engine's streams, {same} of {len(reqs)} "
        "bitwise equal to serve_8b's")
    if plain != want_streams:
        raise AssertionError("spec: the recorded plain engine's streams "
                             "differ from serve_8b's")
    rec = {}
    for label, d, sub in (("draft_1b", draft, reqs),
                          ("self_draft", model, reqs[:N_SELF_DRAFT])):
        eng, streams, counts, st = spec_run(model, d, sub)
        divs = first_divergences(plain, streams,
                                 lambda i, t: gaps.get((i, t)))
        st.update(streams_equal_plain=sum(a == b for a, b in
                                          zip(streams, plain)),
                  divergences=len(divs), first_divergences=divs,
                  near_ties_only=near_ties_only(divs))
        rec[label] = st
        log(f"serving_spec_{label} " + json.dumps(st))
        want = spec_launches(eng, model, d)
        if counts != want:
            raise AssertionError(f"spec {label}: launches {counts}, "
                                 f"expected {want}")
        if not st["near_ties_only"] or eng.num_draft_scans == 0 \
                or eng._draft_scan_program.graph is None:
            raise AssertionError(f"spec {label}: a stream leaves the plain "
                                 "one off a near-tie, or no captured scan")
        if label == "draft_1b":
            graphed = streams
        del eng
    _, eager, _, est = spec_run(model, draft, reqs, graphs=False)
    check_eager_equal("serving_spec", graphed, eager)
    rec["eager_draft_1b"] = {k: est[k] for k in (
        "ms_per_round", "draft_ms_per_round", "verify_ms_per_round",
        "decode_tokens_per_s", "wall_s")}
    rec["replay_only_rounds_checked"] = spec_round_reads(model, draft)
    right = serving.spec_accept_greedy

    def wrong(greedy, props):
        j, bonus = right(greedy, props)
        return np.minimum(j + 1, (props >= 0).sum(1)).astype(np.int32), bonus
    serving.spec_accept_greedy = wrong
    try:
        _, bad, _, _ = spec_run(model, draft, reqs[:N_PLANTED_SPEC])
    finally:
        serving.spec_accept_greedy = right
    bad_divs = first_divergences(plain, bad, lambda i, t: gaps.get((i, t)))
    rec["planted_wrong_accept"] = dict(divergences=len(bad_divs),
                                       first_divergences=bad_divs,
                                       caught=not near_ties_only(bad_divs))
    rec["seconds"] = time.perf_counter() - t0
    log("serving_spec " + json.dumps(rec))
    if near_ties_only(bad_divs):
        raise AssertionError("spec: a planted wrong accept passes the "
                             "stream check")
    return draft, gaps


def generate_8b_spec(model, draft):
    """`speculative_generate` on the 8B model with the 1B-shaped draft:
    `generate_8b`'s 4 prompts of 512 tokens, 32 new tokens, k = 4.
    Greedy: ids against `generate()`'s greedy ids, equal or each first
    divergence at a near-tie of the target's logits there (one causal
    forward over the prompt and the greedy tokens before it); exact flash
    launches (the two prefills) and RMSNorm launches a whole number of
    rounds; wall and tokens/s. Sampling at temperature 0.8: two runs of
    one generator seed equal; the acceptance rate."""
    import torch
    from paddle_tpu_torch.models.speculative import speculative_generate
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = model.config
    L, Ld = cfg.num_hidden_layers, draft.config.num_hidden_layers
    rng = np.random.default_rng(18)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (GEN_BATCH, GEN_PROMPT))
                           .astype(np.int32)).cuda()
    greedy, _ = model.generate(ids, max_new_tokens=GEN_NEW)
    kw = dict(max_new_tokens=GEN_NEW, num_draft_tokens=SPEC_K)
    speculative_generate(model, draft, ids, **kw)          # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    toks, rate = speculative_generate(model, draft, ids, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: n for k, n in launch_counts.items() if n}
    want_g = greedy.tolist()

    def gap_at(i, t):
        row_ids = torch.cat([ids[i], greedy[i, :t]])[None]
        with torch.no_grad():
            row = model(row_ids)[0, -1].float()
        top = torch.topk(row, 2).values
        return float((top[0] - top[1]) / row.abs().max())
    divs = first_divergences(want_g, toks.tolist(), gap_at)
    per_round = (2 * L + 1) + (SPEC_K + 1) * (2 * Ld + 1)
    extra = counts.get("rms_norm", 0) - (2 * L + 1) - (2 * Ld + 1)
    samples = []
    for _ in range(2):
        s, srate = speculative_generate(
            model, draft, ids, do_sample=True, temperature=0.8,
            generator=torch.Generator("cuda").manual_seed(7), **kw)
        samples.append((s, float(srate)))
    rec = dict(batch=GEN_BATCH, prompt_len=GEN_PROMPT, new_tokens=GEN_NEW,
               k=SPEC_K, greedy_wall_s=wall,
               greedy_tokens_per_s=GEN_BATCH * GEN_NEW / wall,
               acceptance_rate=float(rate),
               rows_equal_generate=sum(a == b for a, b in
                                       zip(toks.tolist(), want_g)),
               divergences=len(divs), first_divergences=divs,
               near_ties_only=near_ties_only(divs),
               rounds=extra // per_round, launches=counts,
               sampling_acceptance_rate=samples[0][1],
               sampling_runs_equal=bool(torch.equal(samples[0][0],
                                                    samples[1][0])))
    log("generate_8b_spec " + json.dumps(rec))
    if counts.get("flash_attention_fwd") != L + Ld or extra % per_round \
            or set(counts) != {"flash_attention_fwd", "rms_norm"}:
        raise AssertionError(f"generate_8b_spec: launches {counts}")
    if not rec["near_ties_only"] or not rec["sampling_runs_equal"] \
            or toks.shape != (GEN_BATCH, GEN_NEW):
        raise AssertionError("generate_8b_spec: ids leave generate()'s off "
                             "a near-tie, or a seeded run differs")


def serve_8b_sample(model, reqs, want_streams, gaps):
    """The first `N_SAMPLE_REQUESTS` of `reqs` with ``do_sample=True,
    temperature=0.8, top_p=0.9``: graphed (seed 0), eager (seed 0),
    graphed again (seed 0) and graphed at seed 1; the three seed-0 runs
    bitwise equal, seed 1 another stream; ``top_k=1`` graphed against
    `serve_8b`'s greedy streams: equal up to an exact tie at the top of
    the plain engine's logits (``gaps``, `plain_gaps`': 0.0), where
    top-k keeps every tied token, as JAX's filter does, and the draw
    picks one while argmax takes the lowest index; exact launches
    (`check_serving_counts`); decode step ms. Then the first
    `N_SAMPLE_LEGACY` on the legacy path, graphed against eager and at
    another seed."""
    L = model.config.num_hidden_layers
    sub = reqs[:N_SAMPLE_REQUESTS]
    runs, stats = {}, {}
    for name, graphs, kw in (("seed0_graphed", True, dict(seed=0)),
                             ("seed0_eager", False, dict(seed=0)),
                             ("seed0_graphed_again", True, dict(seed=0)),
                             ("seed1_graphed", True, dict(seed=1)),
                             ("top_k_1", True, dict(seed=0, top_k=1))):
        eng, streams, counts, st = serve_run(model, sub, 1, graphs,
                                             **SAMPLE_KW, **kw)
        check_serving_counts(eng, counts, L)
        runs[name] = streams
        stats[name] = {f: st[f] for f in ("decode_step_ms",
                                           "decode_tokens_per_s",
                                           "ttft_p50_s", "graph_captures")}
        del eng
    lruns = {}
    for name, kw in (("seed0_graphed", dict(seed=0)),
                     ("seed0_eager", dict(seed=0, _graphs=False)),
                     ("seed1_graphed", dict(seed=1))):
        eng, lruns[name], _, st = legacy_graphed_run(
            model, reqs[:N_SAMPLE_LEGACY], **SAMPLE_KW, **kw)
        stats["legacy_" + name] = {f: st[f] for f in ("decode_step_ms",
                                                      "ttft_p50_s")}
        del eng
    rec = dict(
        runs=stats,
        seed0_graphed_equal_eager=runs["seed0_graphed"]
        == runs["seed0_eager"],
        seed0_runs_equal=runs["seed0_graphed"]
        == runs["seed0_graphed_again"],
        seed1_streams_differing=sum(a != b for a, b in zip(
            runs["seed1_graphed"], runs["seed0_graphed"])),
        top_k_1_equal_greedy=sum(a == b for a, b in zip(
            runs["top_k_1"], want_streams)),
        top_k_1_divergences=first_divergences(
            want_streams, runs["top_k_1"], lambda i, t: gaps.get((i, t))),
        sampled_equal_greedy=sum(a == b for a, b in zip(
            runs["seed0_graphed"], want_streams)),
        legacy_graphed_equal_eager=lruns["seed0_graphed"]
        == lruns["seed0_eager"],
        legacy_seed1_differs=lruns["seed1_graphed"]
        != lruns["seed0_graphed"])
    log("serving_sample " + json.dumps(rec))
    if not (rec["seed0_graphed_equal_eager"] and rec["seed0_runs_equal"]
            and rec["seed1_streams_differing"]
            and all(g == 0.0 for _, _, g in rec["top_k_1_divergences"])
            and rec["legacy_graphed_equal_eager"]
            and rec["legacy_seed1_differs"]):
        raise AssertionError("serving_sample: a seeded stream is not "
                             "reproduced, or top_k=1 leaves greedy off an "
                             "exact tie")


def telemetry_run(model, reqs, on, **kw):
    """`serve_run` at k = 1, graphed, with telemetry ``on`` or off (the
    registry and the trace ring emptied first) and each step timed on
    the host: (engine, streams, counts, stats, the steps' summed wall)."""
    import torch
    import paddle_tpu_torch.observability as telemetry
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    telemetry.reset()
    telemetry.clear_events()
    if on:
        telemetry.enable()
    else:
        telemetry.disable()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048,
                                   **kw)
    reset_launch_counts()
    t0 = time.perf_counter()
    for p, new in reqs:
        eng.add_request(p, max_new_tokens=new)
    done, steps = [], 0.0
    while len(done) < len(reqs):
        s0 = time.perf_counter()
        done += eng.step()
        steps += time.perf_counter() - s0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    by_rid = {r.rid: r for r in done}
    streams = [by_rid[rid].output for rid in range(len(reqs))]
    return eng, streams, counts, serving_stats(eng, done, wall), steps


def telemetry_drill(model, reqs, arms, **kw):
    """The 16 requests on a graphed 8B engine (``kw``: engine options)
    with ``arms`` ({site: FaultInjector.arm options}) armed, telemetry
    on: (engine, requests by id, counts), or the exception it raised
    in place of the requests."""
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.utils.faults import FaultInjector
    eng = ContinuousBatchingEngine(model, max_batch_size=8, max_seq_len=2048,
                                   **kw)
    reset_launch_counts()
    for p, new in reqs:
        eng.add_request(p, max_new_tokens=new)
    done = []
    with FaultInjector(seed=0) as fi:
        for site, opts in arms.items():
            fi.arm(site, **opts)
        try:
            while eng._queue or any(r is not None for r in eng._slot_req):
                done += eng.step()
        except Exception as e:              # noqa: BLE001 - returned
            return eng, e, dict(launch_counts)
    return eng, {r.rid: r for r in done}, dict(launch_counts)


def serve_8b_telemetry(model, reqs, want_streams, draft, legacy_streams):
    """Telemetry, fault points and attribution at 8B (phase 5t of the
    module docstring); ``legacy_streams`` are `serve_8b_legacy`'s. Any
    failed check raises."""
    import torch
    import paddle_tpu_torch.observability as telemetry
    from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                                 SpecConfig)
    from paddle_tpu_torch.observability import profile
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    L = model.config.num_hidden_layers
    rec = {"turns": {"off": [], "on": []}}
    try:
        for on in (False, True, True, False):
            eng, streams, counts, st, steps = telemetry_run(model, reqs, on)
            side = "on" if on else "off"
            if streams != want_streams:
                raise AssertionError(f"telemetry {side}: streams differ "
                                     "from serve_8b's")
            check_serving_counts(eng, counts, L)
            run = {f: st[f] for f in ("decode_step_ms", "host_us_per_step",
                                      "ttft_p50_s", "decode_tokens_per_s",
                                      "graph_captures", "wall_s")}
            if on:
                snap = telemetry.snapshot()
                rounds = profile.round_summary(snap)
                total = sum(r["total_s"] for r in rounds.values())
                run.update(steps_wall_s=steps, components_s={
                    c: r["total_s"] for c, r in rounds.items()},
                    components_share_of_wall=total / steps,
                    components_median_ms={c: 1e3 * r["median_s"]
                                          for c, r in rounds.items()},
                    compiles=profile.compile_summary(snap),
                    graph_capture_s=eng.graph_capture_seconds,
                    spans=len(telemetry.events()))
                if not 0.9 <= total / steps <= 1.0:
                    raise AssertionError(
                        f"the decomposition sums to {total:.4f}s of the "
                        f"steps' {steps:.4f}s")
                prom = telemetry.to_prometheus()
                parsed = telemetry.parse_prometheus(prom)
                if parsed != {k: v for k, v in snap.items()
                              if k != "enabled"}:
                    raise AssertionError("the Prometheus text does not "
                                         "parse back to the snapshot")
                run["prometheus_lines"] = prom.count("\n")
            rec["turns"][side].append(run)
            del eng
        telemetry.enable()
        sync_free_window(model, graphs=True)
        # profile_round on a graphed engine, 3 steps in (admission, the
        # decode program's warm-up and its capture), then on to the end
        telemetry.reset()
        eng = ContinuousBatchingEngine(model, max_batch_size=8,
                                       max_seq_len=2048)
        reset_launch_counts()
        for p, new in reqs:
            eng.add_request(p, max_new_tokens=new)
        done = []
        for _ in range(3):
            done += eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = eng.profile_round()
        pr_s = time.perf_counter() - t0
        while len(done) < len(reqs):
            done += eng.step()
        by_rid = {r.rid: r for r in done}
        streams = [by_rid[i].output for i in range(len(reqs))]
        if streams != want_streams:
            raise AssertionError("profile_round: later streams differ "
                                 "from serve_8b's")
        check_serving_counts(eng, dict(launch_counts), L, extra=2)
        pairs = {r["op_pair"] for r in rows}
        want_pairs = {"embed->rmsnorm", "rmsnorm->qkv", "qkv->rope",
                      "rope->kv_scatter", "kv_scatter->attention",
                      "attention->oproj", "oproj->mlp", "mlp->rmsnorm"}
        if pairs != want_pairs:
            raise AssertionError(f"profile_round pairs {sorted(pairs)}")
        rec["profile_round"] = dict(
            seconds=pr_s, captures=eng.num_graph_captures,
            gap_ms_sum=1e3 * sum(r["gap_s"] for r in rows),
            device_ms_sum=1e3 * sum(r["device_s"] for r in rows),
            top=[{"op_pair": r["op_pair"], "gap_ms": 1e3 * r["gap_s"],
                  "device_ms": 1e3 * r["device_s"], "count": r["count"]}
                 for r in rows])
        log("profile_round " + json.dumps(rec["profile_round"]))
        del eng
        # the drills
        eng, got, counts = telemetry_drill(
            model, reqs, {"serving.prefill": dict(nth=3)})
        failed = [i for i, r in got.items() if r.status == "failed"]
        others = [i for i in range(len(reqs)) if i not in failed]
        same = sum(got[i].output == want_streams[i] for i in others)
        rec["drill_prefill"] = dict(failed=failed, error=got[2].error,
                                    others_equal=same,
                                    lifecycle=eng.lifecycle_info())
        check_serving_counts(eng, counts, L)
        if failed != [2] or same != len(others):
            raise AssertionError(f"prefill drill: failed {failed}, "
                                 f"{same} of {len(others)} streams equal")
        del eng
        # a page-allocation fault after a legacy prefill ran, before its
        # rows reach the pages: that request fails alone
        lreqs = reqs[:N_LEGACY_REQUESTS]
        eng, got, counts = telemetry_drill(
            model, lreqs, {"serving.alloc_page": dict(nth=1)},
            attention_impl="legacy")
        if isinstance(got, Exception):
            raise AssertionError(f"legacy alloc drill raised {got!r}")
        failed = [i for i, r in got.items() if r.status == "failed"]
        same = sum(got[i].output == legacy_streams[i]
                   for i in range(len(lreqs)) if i not in failed)
        rec["drill_legacy_alloc"] = dict(
            failed=failed, error=got[0].error, others_equal=same,
            lifecycle=eng.lifecycle_info(), pool_writes=eng._pool_writes)
        check_legacy_counts(eng, counts, L)
        eng.check_invariants()
        if failed != [0] or same != len(lreqs) - 1 \
                or len(eng._free) != eng.num_pages - 1:
            raise AssertionError(f"legacy alloc drill: failed {failed}, "
                                 f"{same} of {len(lreqs) - 1} streams equal")
        del eng
        eng, got, counts = telemetry_drill(
            model, reqs, {"serving.decode": dict(nth=5)})
        streams = [got[i].output for i in range(len(reqs))]
        rec["drill_decode_once"] = dict(
            streams_equal=sum(a == b for a, b in zip(streams, want_streams)),
            lifecycle=eng.lifecycle_info(), captures=eng.num_graph_captures,
            retries_counted=telemetry.value(
                "pdt_serving_decode_retries_total"))
        check_serving_counts(eng, counts, L)
        if streams != want_streams \
                or eng.lifecycle_info()["decode_retries"] != 1 \
                or eng.num_graph_captures \
                != rec["turns"]["on"][0]["graph_captures"]:
            raise AssertionError("decode drill: a retried step changed "
                                 "the streams, was not counted or "
                                 "recaptured a program")
        del eng
        eng, got, _ = telemetry_drill(model, reqs,
                                      {"serving.decode": dict(always=True)},
                                      max_decode_retries=2)
        rec["drill_decode_always"] = dict(
            raised=f"{type(got).__name__}: {got}",
            site=getattr(got, "site", None), lifecycle=eng.lifecycle_info())
        if getattr(got, "site", None) != "serving.decode" \
                or eng.num_decode_retries != 3:
            raise AssertionError("decode drill: an always-armed decode did "
                                 "not raise after max_decode_retries + 1")
        del eng
        eng, got, _ = telemetry_drill(
            model, reqs, {"speculative.verify": dict(always=True)},
            spec_decode=SpecConfig(draft, k=SPEC_K))
        streams = [got[i].output for i in range(len(reqs))]
        info = eng.spec_info()
        rec["drill_spec_verify"] = dict(
            spec=info, statuses=sorted({r.status for r in got.values()}),
            streams_equal=sum(a == b for a, b in zip(streams, want_streams)),
            degraded_counted=telemetry.value("pdt_spec_degraded_total",
                                             site="verify"))
        if info["degraded"] < 1 or info["rounds"] != 0 \
                or rec["drill_spec_verify"]["statuses"] != ["finished"] \
                or streams != want_streams:
            raise AssertionError("spec drill: a degraded round failed a "
                                 "request or changed a stream")
        del eng
    finally:
        telemetry.disable()
        telemetry.reset()
        telemetry.clear_events()
    for side in ("off", "on"):
        log(f"telemetry_{side} " + json.dumps(rec["turns"][side]))
    log("telemetry " + json.dumps(rec))


# `serve_8b_migrate`: a request moves once it holds MIGRATE_AT tokens; the
# int8-KV run serves the first N_QUANT_MIGRATE requests (one admission
# batch, as the int8 phase's first) and moves the even ones
MIGRATE_AT = 4
N_QUANT_MIGRATE = 8
# the drills of the bf16 run, at a request's move: a fault at either end
# (then the move again), a payload damaged after its manifest (the
# request stays on its source)
MIGRATE_DRILLS = {0: "transfer.serialize", 2: "transfer.install",
                  1: "transfer.payload"}


def _resident(eng, rid):
    return any(r is not None and r.rid == rid for r in eng._slot_req)


def migrate_run(model, reqs, moves, drills=None, **kw):
    """Serve ``reqs`` on a graphed 8B source engine at k = 1 and move each
    request whose index is in ``moves`` to a graphed target engine on the
    same card (`serving.transfer.migrate_request`) once it holds
    `MIGRATE_AT` tokens; run both to the end. ``drills`` ({index: fault
    site}) first fails that request's move once: ``transfer.serialize``
    or ``transfer.install`` raised, ``transfer.payload`` damaged after
    the manifest (refused at verify; the request then stays on its
    source). Each move is timed: the export (gather, one D2H copy, the
    manifest's sha256), the manifest alone, the target's
    `verify_payload`, the install (one pinned H2D copy and the install
    program) and the whole migration, with the install program's state.
    Returns (streams by index, move records, drill records, source,
    target); telemetry must be on."""
    import torch
    import paddle_tpu_torch.observability as telemetry
    from paddle_tpu_torch.models import serving
    from paddle_tpu_torch.serving import transfer
    from paddle_tpu_torch.utils.faults import FaultError, FaultInjector
    gc.collect()                  # an earlier run's engines off the card
    src, dst = [serving.ContinuousBatchingEngine(
        model, max_batch_size=8, max_seq_len=2048, **kw) for _ in range(2)]
    # each timed call's host wall by name, in call order: a move's first
    # `payload_checksums` is the export's manifest, its second the one
    # inside `verify_payload`
    times = {}
    real = {n: getattr(serving, n) for n in ("payload_checksums",
                                             "verify_payload")}

    def timed(name, fn, sync=False):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if sync:
                    torch.cuda.synchronize()
                times.setdefault(name, []).append(time.perf_counter() - t0)
        return call
    for name, fn in real.items():
        setattr(serving, name, timed(name, fn))
    src.export_pages = timed("export", src.export_pages)
    dst._install_kv = timed("install", dst._install_kv, sync=True)
    drills = dict(drills or {})
    todo = set(moves) | set(drills)
    rids = [src.add_request(p, max_new_tokens=n) for p, n in reqs]
    done, moved, drilled = {}, [], {}

    def drill(i, site):
        before = telemetry.value("pdt_transfer_failures_total",
                                 stage="verify")
        with FaultInjector(seed=0) as fi:
            if site == "transfer.payload":
                fi.arm_corrupt(site, mode="bitflip", nth=1)
            else:
                fi.arm(site, nth=1)
            try:
                transfer.migrate_request(src, dst, rids[i])
            except (FaultError, serving.PayloadCorruption) as e:
                err = f"{type(e).__name__}: {e}"
            else:
                raise AssertionError(f"migrate drill {site}: the move "
                                     "went through")
        src.check_invariants()
        dst.check_invariants()
        live = _resident(src, rids[i])
        drilled[i] = dict(site=site, error=err[:120], live_on_source=live,
                          target_running=dst.lifecycle_info()["running"],
                          verify_failures=telemetry.value(
                              "pdt_transfer_failures_total",
                              stage="verify") - before)
        if not live:
            raise AssertionError(f"migrate drill {site}: the request left "
                                 "its source")

    def move(i):
        times.clear()
        t0 = time.perf_counter()
        req, payload = transfer.migrate_request(src, dst, rids[i])
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        n = payload["n_pages"]
        runs = dst._install_programs[n].runs
        moved.append(dict(
            index=i, pages=n, nbytes=transfer.payload_nbytes(payload),
            payload_mib=transfer.payload_nbytes(payload) / 2 ** 20,
            export_ms=1e3 * times["export"][0],
            manifest_ms=1e3 * times["payload_checksums"][0],
            verify_ms=1e3 * times["verify_payload"][0],
            install_ms=1e3 * times["install"][0], total_ms=1e3 * total,
            install_program={1: "warm-up", 2: "capture+replay"}.get(
                runs, "replay")))

    try:
        while any(r is not None for e in (src, dst) for r in e._slot_req) \
                or src._queue:
            for r in src.step():
                done[int(r.request_id)] = r.output
            for i in sorted(todo):
                req = src.get_request(rids[i])
                if req is None or not _resident(src, rids[i]) \
                        or len(req.output) < MIGRATE_AT:
                    continue
                todo.discard(i)
                if i in drills:
                    drill(i, drills[i])
                if i in moves:
                    move(i)
            for r in dst.step():
                done[int(r.request_id)] = r.output
    finally:
        for name, fn in real.items():
            setattr(serving, name, fn)
    torch.cuda.synchronize()
    if todo:
        raise AssertionError(f"requests {sorted(todo)} never reached "
                             f"{MIGRATE_AT} tokens on the source")
    for eng in (src, dst):
        eng.check_invariants()
        if len(eng._free) != eng.num_pages - 1:
            raise AssertionError("pages held after the migration run")
    return [done[i] for i in range(len(reqs))], moved, drilled, src, dst


def spill_revive(model, want_streams):
    """`serve_8b_prefix`'s warm request on an engine with the prefix
    cache, serialized at its `MIGRATE_AT`-th token and spilled into a
    `FleetPrefixStore`; the spilled chain of a hit prompt fetched and
    installed by `import_prefix` into a fresh engine, then the 8 hit
    requests: 8 hits reusing 4096 tokens, and the streams of
    `serve_8b_prefix`'s cached run (its pages came from the same warm
    admission)."""
    import torch
    from paddle_tpu_torch.models.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.observability import profile
    from paddle_tpu_torch.serving import FleetPrefixStore, transfer
    preqs = prefix_requests(model.config.vocab_size)
    warm = ContinuousBatchingEngine(model, max_batch_size=8,
                                    max_seq_len=2048,
                                    enable_prefix_caching=True)
    rid = warm.add_request(preqs[0][0], max_new_tokens=preqs[0][1])
    while len(warm.get_request(rid).output) < MIGRATE_AT:
        warm.step()
    payload = transfer.serialize_request(warm, rid)
    del warm
    # a budget for the whole chain: the default 32 MiB holds 16 pages at
    # 8B width, and the LRU would drop the chain's head first
    store = FleetPrefixStore(page_size=16, spill_budget_bytes=1 << 30)
    spilled = store.spill_payload(payload)
    del payload
    fresh = ContinuousBatchingEngine(model, max_batch_size=8,
                                     max_seq_len=2048,
                                     enable_prefix_caching=True)
    entry = store.fetch(preqs[1][0])
    if entry is None:
        raise AssertionError("spill: the hit prompt's chain is not held")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    installed = fresh.import_prefix(*entry)
    torch.cuda.synchronize()
    import_ms = 1e3 * (time.perf_counter() - t0)
    store.note_lookup("spill")
    rids = [fresh.add_request(p, max_new_tokens=n) for p, n in preqs[1:]]
    out = fresh.run()
    streams = [out[r] for r in rids]
    rec = dict(spilled_pages=spilled, spilled_mib=store.spilled_bytes / 2 ** 20,
               fetched_pages=len(entry[0]), installed=installed,
               import_prefix_ms=import_ms, prefix_hits=fresh.prefix_hits,
               prefix_tokens_reused=fresh.prefix_tokens_reused,
               streams_equal_cached=sum(a == b for a, b in
                                        zip(streams, want_streams)),
               store=store.stats(), ledger=profile.memory_ledger(
                   [fresh], prefix_store=store))
    fresh.check_invariants()
    if installed != PREFIX_LEN // 16 or fresh.prefix_hits != N_PREFIX_HITS \
            or fresh.prefix_tokens_reused != N_PREFIX_HITS * PREFIX_LEN \
            or streams != want_streams:
        raise AssertionError(f"spill: {installed} pages installed, "
                             f"{fresh.prefix_hits} hits, "
                             f"{rec['streams_equal_cached']} streams equal")
    return rec


def serve_8b_migrate(model, reqs, want_streams, gaps, quant_streams,
                     prefix_streams):
    """KV page transfer at 8B (phase 5u of the module docstring): the 16
    requests with every even one moved to a second engine at its
    `MIGRATE_AT`-th token and the three transfer drills, against
    `serve_8b`'s streams (bitwise, or each first parting at a near-tie
    of the plain engine's logits, `plain_gaps`); 4 moves on int8-KV
    engines against the int8 phase's streams, and the int8 / bf16 bytes
    a page; the spilled prefix revived. Any failed check raises."""
    import torch
    import paddle_tpu_torch.observability as telemetry
    from paddle_tpu_torch.models.serving import QuantServingConfig
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    L = model.config.num_hidden_layers
    t_phase = time.perf_counter()
    rec = {}
    telemetry.reset()
    telemetry.enable()
    try:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        evens = list(range(0, len(reqs), 2))
        streams, moved, drilled, src, dst = migrate_run(
            model, reqs, evens, MIGRATE_DRILLS)
        check_serving_counts(src, dict(launch_counts), L,
                             extra=dst.num_dispatches)
        divs = first_divergences(want_streams, streams,
                                 lambda i, t: gaps.get((i, t)))
        nbytes = sum(m["nbytes"] for m in moved)
        counted = telemetry.value("pdt_transfer_bytes_total")
        rec["bf16"] = dict(
            moved=len(moved), streams_equal=sum(
                a == b for a, b in zip(streams, want_streams)),
            first_divergences=divs, near_ties_only=near_ties_only(divs),
            transfer_bytes_total=counted, payload_nbytes_sum=nbytes,
            migrations_total=telemetry.value(
                "pdt_transfer_migrations_total"),
            failures={s: telemetry.value("pdt_transfer_failures_total",
                                         stage=s)
                      for s in ("serialize", "install", "verify")},
            drills=drilled, install_captures=sum(
                p.graph is not None
                for p in dst._install_programs.values()),
            migrations=moved)
        del src, dst
        for m in moved:
            log("migrate " + json.dumps(m))
        if len(moved) != len(evens) or counted != nbytes \
                or not rec["bf16"]["near_ties_only"] \
                or [drilled[i]["live_on_source"] for i in sorted(drilled)] \
                != [True] * 3 or drilled[1]["verify_failures"] != 1:
            raise AssertionError("migrate: a move, a stream, the byte count "
                                 "or a drill is off: "
                                 + json.dumps(rec["bf16"])[:2000])
        qreqs = reqs[:N_QUANT_MIGRATE]
        qstreams, qmoved, _, src, dst = migrate_run(
            model, qreqs, list(range(0, N_QUANT_MIGRATE, 2)),
            quant=QuantServingConfig("int8", "int8"))
        del src, dst
        per_page = {k: statistics.median(m["nbytes"] / m["pages"]
                                         for m in ms)
                    for k, ms in (("bf16", moved), ("int8", qmoved))}
        ratio = per_page["int8"] / per_page["bf16"]
        # a page row int8 over the model's dtype: int8 k and v and one f32
        # scale each, over k and v at full width (at 8B bf16 (2 x 1024 +
        # 8) / (2 x 2048) = 0.50195)
        cfg = model.config
        row = 2 * cfg.num_key_value_heads * cfg.head_dim
        want_ratio = (row + 2 * 4) \
            / (row * next(model.parameters()).element_size())
        rec["int8"] = dict(moved=len(qmoved), streams_equal=sum(
            a == b for a, b in zip(qstreams, quant_streams)),
            bytes_per_page=per_page, ratio=ratio, ratio_expected=want_ratio,
            migrations=qmoved)
        for m in qmoved:
            log("migrate_int8 " + json.dumps(m))
        if qstreams != quant_streams[:N_QUANT_MIGRATE] \
                or ratio != want_ratio:
            raise AssertionError("migrate int8: streams or bytes off: "
                                 + json.dumps(rec["int8"])[:2000])
        rec["spill"] = spill_revive(model, prefix_streams)
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["seconds"] = time.perf_counter() - t_phase
        log("serving_migrate " + json.dumps(
            {k: ({kk: vv for kk, vv in v.items() if kk != "migrations"}
                 if isinstance(v, dict) else v) for k, v in rec.items()}))
    finally:
        telemetry.disable()
        telemetry.reset()
        telemetry.clear_events()


def path_check(model, reqs, weights=None, lora_engine=None):
    """One admission dispatch of the 8B model through the kernels and
    through the plain versions, on fresh pools each: full-width pools,
    or, with the quantized ``weights``, int8 pools and their scales.
    With ``lora_engine`` the dispatch reads that engine's adapter stacks,
    sequence s under adapter row s + 1."""
    import torch
    from paddle_tpu_torch.models.llama import RaggedKVCacheView
    from paddle_tpu_torch.ops.ragged_paged_attention import \
        pack_ragged_batch
    cfg = model.config
    ps, n_seq = 16, 3
    pieces = [{"seq": s, "tokens": list(reqs[s][0]), "offset": 0,
               "sample": True} for s in range(n_seq)]
    pk = pack_ragged_batch(pieces, n_seq, block_q=8, pad_to=16)
    need = [-(-len(p["tokens"]) // ps) for p in pieces]
    pps = max(need)
    bt = np.zeros((n_seq, pps), np.int32)
    nxt = 1
    for s, n in enumerate(need):
        bt[s, :n] = np.arange(nxt, nxt + n)
        nxt += n
    dev = {k: torch.from_numpy(np.asarray(pk[k])).cuda()
           for k in ("ids", "token_seq", "positions", "query_start",
                     "query_len", "context_len", "sample_rows")}
    bt_d = torch.from_numpy(bt).cuda()
    quant = weights is not None
    if lora_engine is not None:
        # padding rows (token_seq -1) take the last sequence's row
        rows = (np.arange(n_seq, dtype=np.int32) + 1)[pk["token_seq"]]
        weights = lora_engine._dispatch_weights(torch.from_numpy(rows).cuda())
    logits = {}
    for use_kernel in (True, False, "graph"):
        pools = [tuple(torch.zeros(cfg.num_key_value_heads, nxt, ps,
                                   cfg.head_dim, device="cuda",
                                   dtype=torch.int8 if quant
                                   else torch.bfloat16) for _ in range(2))
                 + tuple(torch.zeros(nxt, ps, device="cuda")
                         for _ in range(2 if quant else 0))
                 for _ in range(cfg.num_hidden_layers)]
        views = [RaggedKVCacheView(e[0], e[1], bt_d, dev["token_seq"],
                                   dev["positions"], dev["query_start"],
                                   dev["query_len"], dev["context_len"], 8,
                                   None, *e[2:])
                 for e in pools]

        def forward():
            with torch.no_grad():
                return model(dev["ids"][None], views,
                             rows=dev["sample_rows"],
                             use_kernel=use_kernel is not False,
                             weights=weights).float()
        # "graph": the kernel forward captured and replayed, as the
        # engine's admission programs run it
        logits[use_kernel] = graph_replay(forward) if use_kernel == "graph" \
            else forward()
        del pools, views
    a, b = logits[True], logits[False]
    replay_equal = torch.equal(logits["graph"], a)
    diff = (a - b).abs().max().item()
    scale = b.abs().max().item()
    agree = (a.argmax(-1) == b.argmax(-1)).tolist()
    what = "quantized " if quant else "LoRA " if lora_engine else ""
    log(f"{what}path check: max |logit diff| "
        f"{diff:.4g} (max |logit| "
        f"{scale:.4g}), argmax agrees per row {agree}, shape "
        f"{tuple(a.shape)}; the kernel forward replayed as a CUDA graph "
        f"bitwise equal to its eager run: {replay_equal}")
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite logits")
    if a.shape != (n_seq, cfg.vocab_size) or diff > 0.1 * scale:
        raise AssertionError("kernel and plain paths disagree")
    if not replay_equal:
        raise AssertionError("the graph replay of the kernel forward "
                             "differs from its eager run")


def _sdpa_library(q, k, v, causal):
    """The library's attention on the same (B, S, H, D) inputs, timed as
    a yardstick (the port never calls it): (fwd ms, backward ms, fwd+bwd
    ms)."""
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    kw = dict(is_causal=causal, enable_gqa=True)
    out = sdpa(qh, kh, vh, **kw)
    do = torch.randn_like(out)
    fwd = time_ms(lambda: sdpa(qh, kh, vh, **kw), iters=10)
    bwd = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), do,
                                              retain_graph=True), iters=10)

    def both():
        o = sdpa(qh, kh, vh, **kw)
        torch.autograd.grad(o, (qh, kh, vh), do)
    return fwd, bwd, time_ms(both, iters=10)


def _event_spans(fn, spans):
    """``fn`` with CUDA events recorded around each call, appended to
    ``spans``: the device time of the call's work on the stream."""
    import torch

    def run(*a, **k):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(*a, **k)
        e1.record()
        spans.append((e0, e1))
        return out
    return run


def _pairs(b, h, sq, sk, causal, window):
    """(q head, key) pairs the mask keeps: the work of one matmul row."""
    off = sk - sq
    n = 0
    for i in range(sq):
        hi = min(sk - 1, i + off) if causal else sk - 1
        lo = max(0, i + off - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return b * h * n


# (label, B, Sq, Sk, H, HK, D, causal, window, dtype, timed)
FLASH_CASES = [
    ("slice_8b", 2, 2048, 2048, 32, 8, 128, True, None, "bfloat16", True),
    ("bench", 8, 2048, 2048, 16, 8, 64, True, None, "bfloat16", True),
    # GPT-2 training (`train_gpt2`): 12 heads of 64, causal, no GQA
    ("gpt2", 8, 1024, 1024, 12, 12, 64, True, None, "bfloat16", True),
    ("tail_1000", 1, 1000, 1000, 8, 2, 128, True, None, "bfloat16", False),
    ("sq300_sk1000", 1, 300, 1000, 8, 2, 128, True, None, "bfloat16", False),
    ("sq600_sk200", 1, 600, 200, 8, 2, 64, True, None, "bfloat16", False),
    ("window_256", 1, 1000, 1000, 8, 2, 128, True, 256, "bfloat16", False),
    ("noncausal", 2, 300, 500, 8, 8, 64, False, None, "bfloat16", False),
    ("f32", 1, 300, 300, 8, 2, 64, True, None, "float32", False),
    ("d32", 2, 1000, 1000, 4, 2, 32, True, None, "bfloat16", False),
    ("gqa7_a14b", 1, 4096, 4096, 28, 4, 128, True, None, "bfloat16",
     True),
    # float16 and the head dims 72 (DiT-XL/2: 1152 / 16, 256 tokens,
    # non-causal), 80, 96, 160, 192 and 256 (the reference's largest),
    # all through the kernels; 8, 40, 112 and 136 each at the next tile
    # width
    ("slice_8b_f16", 2, 2048, 2048, 32, 8, 128, True, None, "float16",
     True),
    ("dit_xl2_d72", 32, 256, 256, 16, 16, 72, False, None, "bfloat16",
     True),
    ("d80", 2, 2048, 2048, 32, 8, 80, True, None, "bfloat16", True),
    ("d96", 2, 2048, 2048, 32, 8, 96, True, None, "bfloat16", True),
    ("d160", 2, 2048, 2048, 32, 8, 160, True, None, "bfloat16", True),
    ("d192", 2, 2048, 2048, 32, 8, 192, True, None, "bfloat16", True),
    ("d256", 2, 2048, 2048, 32, 8, 256, True, None, "bfloat16", True),
    ("d256_f16", 1, 1000, 1000, 8, 2, 256, True, None, "float16", False),
    ("d8", 1, 1000, 1000, 8, 2, 8, True, None, "bfloat16", False),
    ("d40", 1, 1000, 1000, 8, 2, 40, True, None, "bfloat16", False),
    ("d112", 1, 1000, 1000, 8, 2, 112, True, None, "bfloat16", False),
    ("d136", 1, 1000, 1000, 8, 2, 136, True, None, "bfloat16", False),
    # head dims off 8 through the kernels, and past 256 through
    # `attention_xla` (the reference's `_attention_xla` branch)
    ("d100", 1, 1000, 1000, 8, 2, 100, True, None, "bfloat16", False),
    ("d36_f16", 1, 1000, 1000, 8, 2, 36, True, None, "float16", False),
    ("d264_f32", 1, 300, 300, 8, 2, 264, True, None, "float32", False)]


def _skip_tile(live_fn):
    """A planted fault for the plain versions' mask: every q row also
    loses the `FLASH_TILE_K`-key tile that holds its last live key."""
    import torch

    def live(sq, sk, causal, window, device):
        m = live_fn(sq, sk, causal, window, device)
        j = torch.arange(sk, device=device)
        last = torch.where(m, j, -1).amax(-1)
        return m & (j[None, :] // FLASH_TILE_K !=
                    (last // FLASH_TILE_K)[:, None])
    return live


def _flash_faults(fa, q, k, v, do, scale, causal, window):
    """The plain versions' (o, dq, dk, dv) under the planted faults:
    ``skip_tile`` (`_skip_tile`) and, where H > HK, ``wrong_gqa``: q head
    h reads KV head h % HK (its q and dO moved to the slot of a head of
    that group, its outputs read back from there)."""
    import torch
    from unittest import mock

    def plain(qq, dd):
        o, lse = fa.flash_attention_ref(qq, k, v, causal, scale, window)
        return (o, *fa.flash_attention_bwd_ref(qq, k, v, o, lse, dd, causal,
                                               scale, window))
    with mock.patch.object(fa, "_live", _skip_tile(fa._live)):
        faults = {"skip_tile": plain(q, do)}
    h, hk = q.shape[2], k.shape[2]
    if h > hk:
        g = h // hk
        pos = torch.tensor([(i % hk) * g + i // hk for i in range(h)],
                           device=q.device)
        qp, dp = torch.empty_like(q), torch.empty_like(do)
        qp[:, :, pos], dp[:, :, pos] = q, do
        o, dq, dk, dv = plain(qp, dp)
        faults["wrong_gqa"] = (o[:, :, pos], dq[:, :, pos], dk, dv)
    return faults


def _flash_xla_case(fa, label, q, k, v, do, causal, window):
    """A head dim past the kernels': `flash_attention_values` takes
    `attention_xla` (counted, no kernel launched), held forward and
    backward to the plain flash versions at the dtype's limits."""
    import torch
    from paddle_tpu_torch.ops import launch_counts
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(launch_counts)
    out = fa.flash_attention_values(*leaves, causal=causal,
                                    window_size=window)
    out.backward(do)
    torch.cuda.synchronize()
    counted = {n: launch_counts[n] - before[n] for n in before
               if launch_counts[n] != before[n]}
    ro, lse = fa.flash_attention_ref(q, k, v, causal, None, window)
    want = (ro, *fa.flash_attention_bwd_ref(q, k, v, ro, lse, do, causal,
                                            None, window))
    got = (out.detach(), *(t.grad for t in leaves))
    errs = {n: fa.kernel_errors(a, r)
            for n, a, r in zip(("o", "dq", "dk", "dv"), got, want)}
    lim = fa.KERNEL_LIMITS[q.dtype]
    rec = dict(case=label, dtype=str(q.dtype)[6:], D=q.shape[-1],
               route="attention_xla", launches=counted, limits=lim,
               rel_row_errors=errs)
    log("xla_case " + json.dumps(rec))
    if counted != {"flash_attention_xla": 1}:
        raise AssertionError(f"head dim {q.shape[-1]} did not take "
                             f"attention_xla alone: {counted}")
    if not all(e[0] <= lim["rel"] and e[1] <= lim["row"]
               for e in errs.values()):
        raise AssertionError(f"attention_xla disagrees on {label}: {errs}")


def _hgmma_counts(lib):
    """{kernel function: HGMMA instructions} in the SASS of a built
    library, by ``cuobjdump -sass`` (the CUDA toolkit's, else the copy in
    Triton's package)."""
    import shutil
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        import triton
        tool = os.path.join(os.path.dirname(triton.__file__), "backends",
                            "nvidia", "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=600).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


# the wgmma kernels: (library, kernel function) whose SASS must hold HGMMA
SM90_KERNELS = (("flash_fwd_sm90", "flash_fwd_sm90"),
                ("flash_bwd_sm90", "flash_dq_sm90"),
                ("flash_bwd_sm90", "flash_dkv_sm90"),
                ("grouped_matmul", "gmm_wgmma_kernel"),
                ("dequant_matmul", "dequant_wgmma_kernel"),
                ("flash_varlen_sm90", "varlen_fwd_sm90"),
                ("flash_varlen_sm90", "varlen_dq_sm90"),
                ("flash_varlen_sm90", "varlen_dkv_sm90"))


def sass_phase():
    """HGMMA instructions in the SASS of every wgmma kernel function (each
    template instance); a function without any fails the run."""
    from paddle_tpu_torch.ops import _build
    libs = _build.build(sorted({lib for lib, _ in SM90_KERNELS}))
    sass = {}
    for lib, name in SM90_KERNELS:
        counts = _hgmma_counts(libs[lib])
        fns = {n: c for n, c in counts.items() if name in n}
        sass.update(fns)
        if not fns or not all(fns.values()):
            raise AssertionError(f"{name}: no HGMMA in {fns}")
    log("sass_hgmma " + json.dumps(sass))


def flash_phase(results):
    """The three flash attention kernels against their plain versions:
    timed at the training shapes, checked on the edge cases; the limits
    are shown to catch the planted faults of `_flash_faults`. Where the
    design is wgmma (bf16 and f16 at head dims 64 and 128, forward and
    backward), the mma.sync design it replaced is held to the same limits
    beside it and, at the timed shapes, timed in turns with it (previous,
    new, new, previous): the forward beside SDPA's forward, and the wgmma
    forward + backward as one pair (``fwd_bwd_ms``) beside SDPA's; the
    backward with `delta` alone, delta + dQ + dK/dV and SDPA's backward.
    Each record names its ``design``; the backward reads the lse of the
    path's forward (the wgmma one where it runs)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    sass_phase()
    gen = torch.Generator(device="cuda").manual_seed(8)
    for (label, b, sq, sk, h, hk, d, causal, window, name,
         timed) in FLASH_CASES:
        dt = getattr(torch, name)
        lim = fa.KERNEL_LIMITS[dt]
        f = lambda *shape: torch.randn(*shape, device="cuda",
                                       generator=gen).to(dt)
        q, k, v, do = f(b, sq, h, d), f(b, sk, hk, d), f(b, sk, hk, d), \
            f(b, sq, h, d)
        scale = d ** -0.5
        if not fa.takes_head_dim(d):
            _flash_xla_case(fa, label, q, k, v, do, causal, window)
            continue
        # the path's design (forward and backward alike) and, where it is
        # wgmma, the mma.sync one it replaced
        design = fa.sm90_design(dt, d)
        designs = [design] + (["mma.sync"] if design == "wgmma" else [])
        fwds = {des: fa._flash_fwd(q, k, v, scale, causal, window,
                                   _design=des) for des in designs}
        fwd_again = fa._flash_fwd(q, k, v, scale, causal, window,
                                  _design=design)
        o, lse = fwds[design]
        delta = fa._delta(o, do)
        # each design as `_FlashAttentionFn` runs it (the wgmma dQ kernel
        # forms delta itself), and the path's design once more
        grads = {des: fa._flash_bwd(q, k, v, o, lse, do, scale, causal,
                                    window, _design=des) for des in designs}
        again = fa._flash_bwd(q, k, v, o, lse, do, scale, causal, window,
                              _design=design)
        ro, rlse = fa.flash_attention_ref(q, k, v, causal, scale, window)
        want = (ro, *fa.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                                scale, window))
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, c) for a, c in zip(grads[design],
                                                        again))
        fwd_bitwise = all(torch.equal(a, c) for a, c in zip(fwds[design],
                                                            fwd_again))
        names = ("o", "dq", "dk", "dv")
        errs = {des: {n: fa.kernel_errors(a, r) for n, a, r in
                      zip(names[1:], grads[des], want[1:])}
                for des in designs}
        abs_err = {des: {n: (a.float() - r.float()).abs().max().item()
                         for n, a, r in zip(names[1:], grads[des], want[1:])}
                   for des in designs}
        ferrs = {des: fa.kernel_errors(fo, ro) for des, (fo, _) in
                 fwds.items()}
        fabs = {des: (fo.float() - ro.float()).abs().max().item()
                for des, (fo, _) in fwds.items()}
        lse_errs = {des: (fl - rlse).abs().max().item()
                    for des, (_, fl) in fwds.items()}
        faults = {fault: {n: fa.kernel_errors(a, r)
                          for n, a, r in zip(names, outs, want)}
                  for fault, outs in _flash_faults(
                      fa, q, k, v, do, scale, causal, window).items()}

        def passes(e):
            return e[0] <= lim["rel"] and e[1] <= lim["row"]
        ok = all(passes(e) for de in errs.values() for e in de.values()) \
            and all(passes(e) for e in ferrs.values()) \
            and max(lse_errs.values()) <= 1e-3 and bitwise and fwd_bitwise
        caught = not any(passes(e) for fe in faults.values()
                         for e in fe.values())
        if sq > sk and causal:
            # rows 0..Sq-Sk-1 see no key: exact zeros, zero gradient
            dead = sq - sk
            ok = ok and not any(fo[:, :dead].any() for fo, _ in
                                fwds.values()) and not any(
                g[0][:, :dead].any() for g in grads.values())
        rec_base = dict(case=label, dtype=name, B=b, Sq=sq, Sk=sk, H=h,
                        HK=hk, D=d, causal=causal, window=window,
                        limits=lim, planted_faults=faults)
        n_pairs = _pairs(b, h, sq, sk, causal, window)
        isz = q.element_size()
        qo_bytes = b * sq * h * d * isz
        kv_bytes = b * sk * hk * d * isz
        rows = 4 * b * h * sq
        work = {
            "flash_attention_fwd": dict(
                nbytes=qo_bytes * 2 + kv_bytes * 2 + rows,
                ops=4 * d * n_pairs),
            "flash_attention_bwd_dq": dict(
                nbytes=qo_bytes * 3 + kv_bytes * 2 + 2 * rows,
                ops=6 * d * n_pairs),
            "flash_attention_bwd_dkv": dict(
                nbytes=qo_bytes * 2 + kv_bytes * 4 + 2 * rows,
                ops=8 * d * n_pairs)}
        recs = [("flash_attention_fwd", des, dict(
            max_abs_err=fabs[des], rel_row_errors={"o": ferrs[des]},
            lse_max_abs_err=lse_errs[des],
            bitwise_repeat=fwd_bitwise if des == design else None))
            for des in designs]
        for des in designs:
            e, a = errs[des], abs_err[des]
            recs.append(("flash_attention_bwd_dq", des, dict(
                max_abs_err=a["dq"], rel_row_errors={"dq": e["dq"]})))
            recs.append(("flash_attention_bwd_dkv", des, dict(
                max_abs_err=max(a["dk"], a["dv"]),
                rel_row_errors={"dk": e["dk"], "dv": e["dv"]})))
        times, extra, fruns = {}, {}, {}
        if timed:
            # in turns: the previous design, the new, the new, the
            # previous (one design alone where there is no other)
            for des in designs[::-1] + designs:
                fruns.setdefault(des, []).append(time_ms(
                    lambda: fa._flash_fwd(q, k, v, scale, causal, window,
                                          _design=des)))
            for des, r in fruns.items():
                times[("flash_attention_fwd", des)] = statistics.median(r)

            def fwd_bwd():
                fo, fl = fa._flash_fwd(q, k, v, scale, causal, window)
                fa._flash_bwd(q, k, v, fo, fl, do, scale, causal, window)
            fwd_bwd_ms = time_ms(fwd_bwd)
            runs = {}
            for des in designs[::-1] + designs:
                r = runs.setdefault(des, {"dq": [], "dkv": [], "bwd": []})
                r["dq"].append(time_ms(lambda: fa._flash_bwd_dq(
                    q, k, v, do, lse, delta, scale, causal, window,
                    _design=des)))
                r["dkv"].append(time_ms(lambda: fa._flash_bwd_dkv(
                    q, k, v, do, lse, delta, scale, causal, window,
                    _design=des)))
                r["bwd"].append(time_ms(lambda: fa._flash_bwd(
                    q, k, v, o, lse, do, scale, causal, window,
                    _design=des)))
            delta_ms = time_ms(lambda: fa._delta(o, do))
            for des, r in runs.items():
                times[("flash_attention_bwd_dq", des)] = \
                    statistics.median(r["dq"])
                times[("flash_attention_bwd_dkv", des)] = \
                    statistics.median(r["dkv"])
                extra[des] = dict(runs=r, delta_ms=delta_ms,
                                  whole_bwd_ms=statistics.median(r["bwd"]))
            plain_fwd = time_ms(lambda: fa.flash_attention_ref(
                q, k, v, causal, scale, window), iters=3, warmup=1)
            plain_bwd = time_ms(lambda: fa.flash_attention_bwd_ref(
                q, k, v, o, lse, do, causal, scale, window), iters=3,
                warmup=1)
            lib_fwd, lib_bwd, lib_both = _sdpa_library(q, k, v, causal)
        del ro, rlse, want
        for kernel, des, r in recs:
            b_ms, b_by = bound(work[kernel]["nbytes"], work[kernel]["ops"],
                               name)
            fwd = kernel == "flash_attention_fwd"
            rec = dict(kernel=kernel, design=des,
                       path_design=des == design,
                       **rec_base, **r, bound_ms=b_ms, bound_by=b_by,
                       ms=times.get((kernel, des)), plain_ms=None,
                       library_ms=None)
            if not fwd:
                rec["bitwise_repeat"] = bitwise if des == design else None
            if timed:
                rec.update(
                    plain_ms=plain_fwd if fwd else plain_bwd,
                    library_ms=lib_fwd if fwd else lib_bwd,
                    fwd_bwd_ms=fwd_bwd_ms,
                    fwd_bwd_design=design,
                    library_fwd_bwd_ms=lib_both,
                    library_note="scaled_dot_product_attention(is_causal, "
                    "enable_gqa=True)",
                    note=None if fwd else "plain_ms and library_ms are "
                    "the whole backward (dq, dk and dv together); "
                    "whole_bwd_ms is delta + dQ + dK/dV of this design")
                if fwd:
                    rec["ms_runs"] = fruns[des]
                else:
                    ex = extra[des]
                    part = "dq" if kernel.endswith("_dq") else "dkv"
                    rec.update(ms_runs=ex["runs"][part],
                               delta_ms=ex["delta_ms"],
                               whole_bwd_ms=ex["whole_bwd_ms"],
                               whole_bwd_runs=ex["runs"]["bwd"])
            log("kernel " + json.dumps(rec))
            results.append(rec)
        if not ok:
            raise AssertionError(f"flash attention kernels disagree on "
                                 f"{label}: {ferrs}, {errs}, lse "
                                 f"{lse_errs}, bitwise repeat {bitwise}, "
                                 f"forward {fwd_bitwise}")
        if not caught:
            raise AssertionError(f"the flash limits {lim} miss a planted "
                                 f"fault on {label}: {faults}")
        del q, k, v, do, o, lse, delta, grads, again, fwds, fwd_again
        torch.cuda.empty_cache()


# the norm backwards on the main paths (label, rows, width, dtype): the
# RMSNorm backward of train_8b_width, train_recipe and the A14B-width MoE
# cut, beside f32 and a ragged row count; the LayerNorm backward of BERT-
# base's batch and at the A14B width
RMS_BWD_SHAPES = [("train_8b_width", 4096, 4096, "bfloat16"),
                  ("train_recipe", 16384, 1024, "bfloat16"),
                  ("train_moe_a14b_width", 4096, 3584, "bfloat16"),
                  ("f32", 4096, 4096, "float32"),
                  ("ragged", 3001, 4096, "bfloat16")]
# (label, rows, width, dtype, affine): DiT's LayerNorms have no affine
# (constant ones / zeros, no dw / db sums)
LN_BWD_SHAPES = [("train_bert_base", 16384, 768, "float32", True),
                 ("a14b_width", 4096, 3584, "bfloat16", True),
                 ("train_gpt2", 8192, 768, "bfloat16", True),
                 ("train_dit_xl2", 8192, 1152, "bfloat16", False)]
# the forwards timed by `ln_phase`: (rows, width, dtype, affine)
LN_FWD_SHAPES = [(16384, 768, "float32", True),
                 (4096, 3584, "bfloat16", True),
                 (8192, 768, "bfloat16", True),
                 (8192, 1152, "bfloat16", False)]
# mangled-name codes of the kernels' element types (ptxas -v names them so)
_TYPE_CODES = {"float32": "f", "bfloat16": "13__nv_bfloat16",
               "float16": "6__half"}


def ptxas_usage(lib):
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from the ``-Xptxas -v`` lines of a source's last build."""
    import re
    from paddle_tpu_torch.ops import _build
    out, fn = {}, None
    for line in _build.build_log(lib).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = [None, None, None]
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def bwd_instance_usage(kind, name, cls):
    """The ptxas usage of the register-row backward instance that runs
    class ``cls`` of dtype ``name``: (registers, spill stores, spill
    loads); AssertionError if the build log has no such instance."""
    lib = "rms_norm" if kind == "rms" else "layer_norm"
    wpr, nv = cls
    key = f"{lib}_bwd_rowsI{_TYPE_CODES[name]}Li{wpr}ELi{nv}EE"
    hits = {k: v for k, v in ptxas_usage(lib).items() if key in k}
    if len(hits) != 1:
        raise AssertionError(f"ptxas usage of {key}: {sorted(hits)}")
    return next(iter(hits.values()))


def kernel_split_us(call, n=20):
    """Device microseconds a call of each kernel ``call`` launches, by
    `torch.profiler` over ``n`` calls (the row kernel and the column sum
    of a norm backward, timed apart)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.tools.profile_decode import _kernel_times
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for key, (count, us) in _kernel_times(prof).items():
        m = re.search(r"(\w+)\s*[<(]",
                      key.replace("(anonymous namespace)::", ""))
        short = m.group(1) if m else key[:60]
        c, u = out.get(short, (0, 0.0))
        out[short] = (c + count, u + us)
    return {k: dict(launches=c / n, us=u / n) for k, (c, u) in out.items()}


def norm_bwd_case(kind, label, n, h, name, gen, results, affine=True):
    """One norm backward (``kind`` "rms" or "ln") at (n, h) of ``name``:
    each design (the register-row one where a class holds the row, and
    the rowblock one) against torch autograd of the plain version (dx
    and dw of RMSNorm at TOL / rtol and 1e-3 of the largest |dw|,
    LayerNorm's dx, dw, db within `nk.LN_LIMITS`), dw / db bitwise on a
    repeat, then timed in turns with the library's one backward call
    (`aten._fused_rms_norm_backward`, `aten.native_layer_norm_backward`)
    and a yardstick that moves the same bytes (``x + g``: x and g read
    once, one tensor of x's shape written) by `timed_in_turns`:
    device_ms (graphs, inputs past the L2), host_us, ms; one call's
    device time split into its kernels (`kernel_split_us`) and the
    registers instance's ptxas registers and spills. LayerNorm also
    holds a planted fault (dx without its mean(w g) term) outside the
    limits. Without ``affine`` (LayerNorm only) w and b are constant ones
    and zeros, only dx is asked for and held (the kernel writes no dw / db
    partials) and the library call takes no weight. Returns the records,
    the path design's first."""
    import torch
    from paddle_tpu_torch.ops import kernel_errors
    from paddle_tpu_torch.ops import norm_kernels as nk
    dt = getattr(torch, name)
    isz = torch.empty((), dtype=dt).element_size()
    eps = 1e-5 if kind == "rms" else 1e-12
    w = (1 + 0.1 * torch.randn(h, device="cuda", generator=gen)).to(dt)
    b = (0.1 * torch.randn(h, device="cuda", generator=gen)).to(dt)
    # the library's weight and bias: none without an affine
    lw, lb = w, b
    if not affine:
        w, b = torch.ones_like(w), torch.zeros_like(b)
        lw = lb = None
    aten = torch.ops.aten
    sets = []
    for _ in range(rotation_sets(3 * n * h * isz)):
        x = (torch.randn(n, h, device="cuda", generator=gen)
             + (0.5 if kind == "ln" else 0.0)).to(dt)
        g = torch.randn(n, h, device="cuda", generator=gen).to(dt)
        if kind == "rms":
            stats = (nk._rms_fwd(x, w, eps)[1],)
            lib = aten._fused_rms_norm(x, [h], w, eps)[1:]
        else:
            stats = nk._ln_fwd(x, w, b, eps)[1:]
            lib = aten.native_layer_norm(x, [h], lw, lb, eps)[1:]
        sets.append((x, g, stats, lib))
    x, g, stats, _ = sets[0]
    leaves = [t.clone().requires_grad_() for t in (
        (x, w) if kind == "rms" else (x, w, b) if affine else (x,))]
    out = nk.rms_norm_ref(*leaves, eps) if kind == "rms" else \
        nk.layer_norm_ref(*leaves, eps) if affine else \
        nk.layer_norm_ref(leaves[0], w, b, eps)
    refs = torch.autograd.grad(out, leaves, g, retain_graph=True)
    path = nk.norm_bwd_design(dt, h)
    cls = nk.bwd_row_class(dt, h)
    bwd = nk._rms_bwd if kind == "rms" else nk._ln_bwd
    designs = ("registers", "rowblock") if cls is not None else \
        ("rowblock",)
    kw = {} if affine else dict(affine=False)
    named = {d: (lambda st, d=d: bwd(st[0], w, *st[2], st[1], _design=d,
                                     **kw))
             for d in designs}
    if kind == "rms":
        named["library"] = lambda st: aten._fused_rms_norm_backward(
            st[1], st[0], [h], st[3][0], w, [True, True])
    else:
        named["library"] = lambda st: aten.native_layer_norm_backward(
            st[1], st[0], [h], st[3][0], st[3][1], lw, lb,
            [True, affine, affine])
    tol = TOL[name]
    lim = nk.LN_LIMITS[dt]
    within = lambda e: e[0] <= lim["rel"] and e[1] <= lim["row"]
    checks = {}
    for d in designs:
        got = [t for t in named[d](sets[0]) if t is not None]
        again = [t for t in named[d](sets[0]) if t is not None]
        torch.cuda.synchronize()
        if len(got) != len(refs):
            raise AssertionError(f"{kind} backward at {label}: "
                                 f"{len(got)} outputs, want {len(refs)}")
        errs = {k: kernel_errors(a.reshape(-1, h), r.reshape(-1, h))
                for k, a, r in zip(("dx", "dw", "db"), got, refs)}
        if kind == "rms":
            top = refs[1].float().abs().max().item()
            ok = torch.allclose(got[0].float(), refs[0].float(), **tol) \
                and torch.allclose(got[1].float(), refs[1].float(),
                                   rtol=tol["rtol"], atol=1e-3 * top)
        else:
            ok = all(within(e) for e in errs.values())
        checks[d] = dict(
            ok=bool(ok), rel_row_errors=errs,
            max_abs_err=max((a.float() - r.float()).abs().max().item()
                            for a, r in zip(got, refs)),
            bitwise_repeat=all(torch.equal(a, c) for a, c in zip(got,
                                                                 again)))
    fault_err = None
    if kind == "ln":
        xf = x.float()
        xhat = (xf - stats[0][:, None]) * stats[1][:, None]
        wg = g.float() * w.float()
        fault = (stats[1][:, None] * (wg - xhat * (wg * xhat).mean(
            -1, keepdim=True))).to(dt)
        fault_err = kernel_errors(fault, refs[0])
        del xf, xhat, wg, fault
    named["same_bytes"] = lambda st: torch.add(st[0], st[1])
    times = timed_in_turns(named, sets)
    plain = time_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                retain_graph=True))
    lib_autograd = time_ms(lambda: torch.autograd.grad(
        (torch.nn.functional.rms_norm(leaves[0], (h,), leaves[1], eps)
         if kind == "rms" else torch.nn.functional.layer_norm(
             leaves[0], (h,), *(leaves[1:] if affine else (None, None)),
             eps)),
        leaves, g))
    if kind == "rms":
        nbytes, ops = 3 * n * h * isz + 2 * h * isz + 4 * n, 10 * n * h
    elif affine:
        nbytes, ops = 3 * n * h * isz + 4 * h * isz + 8 * n, 12 * n * h
    else:
        # x and g read, dx written, the statistics and the constant w read
        nbytes, ops = 3 * n * h * isz + h * isz + 8 * n, 10 * n * h
    b_ms, b_by = bound(nbytes, ops, name)
    lt = times["library"]
    kname = "rms_norm_bwd" if kind == "rms" else "layer_norm_bwd"
    recs = []
    for d in sorted(designs, key=lambda d: d != path):
        t = times[d]
        reg = d == "registers"
        usage = bwd_instance_usage(kind, name, cls) if reg else None
        rec = dict(kernel=kname, case=f"rows={n}_h={h}"
                   + ("" if affine else "_no_affine"), shape_of=label,
                   N=n, H=h, dtype=name, affine=affine, design=d,
                   path_design=d == path,
                   row_class=cls if reg else None,
                   **checks[d],
                   limits=tol if kind == "rms" else lim, ms=t["ms"],
                   device_ms=t["device_ms"],
                   device_ms_turns=t["device_ms_turns"],
                   host_us=t["host_us"], plain_ms=plain, bound_ms=b_ms,
                   bound_by=b_by, bound_fraction=b_ms / t["device_ms"],
                   library_ms=lt["ms"], library_device_ms=lt["device_ms"],
                   library_host_us=lt["host_us"],
                   library_bound_fraction=b_ms / lt["device_ms"],
                   library_note=("aten._fused_rms_norm_backward"
                                 if kind == "rms" else
                                 "aten.native_layer_norm_backward")
                   + " (one call, the F autograd backward's kernel)",
                   library_autograd_ms=lib_autograd,
                   same_bytes_device_ms=times["same_bytes"]["device_ms"],
                   kernel_split_us=kernel_split_us(
                       lambda: named[d](sets[0])),
                   ptxas_registers_spills=usage,
                   rotation_sets=len(sets))
        if kind == "ln":
            rec["planted_fault_dx_without_mean_wg"] = fault_err
        log("kernel " + json.dumps(rec))
        results.append(rec)
        recs.append(rec)
        if not (rec["ok"] and rec["bitwise_repeat"]):
            raise AssertionError(f"{kname} disagrees: {rec}")
        if usage is not None and (usage[1] or usage[2]):
            raise AssertionError(f"{kname}: the registers instance "
                                 f"spills: {usage}")
    if fault_err is not None and within(fault_err):
        raise AssertionError(f"the LayerNorm limits miss a planted fault: "
                             f"{fault_err}")
    del sets, x, g, leaves, out, refs
    torch.cuda.empty_cache()
    return recs


def rms_bwd_phase(results):
    """The RMSNorm backward's designs at `RMS_BWD_SHAPES` (`norm_bwd_case`),
    the register-row design on the path at every main-path shape."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(9)
    for label, n, h, name in RMS_BWD_SHAPES:
        recs = norm_bwd_case("rms", label, n, h, name, gen, results)
        if label.startswith("train") and recs[0]["design"] != "registers":
            raise AssertionError(f"the RMSNorm backward at {label} does "
                                 f"not take the registers design")


def _tiny_train(dev, ids, accumulate_steps=1, steps=3):
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             seed=3).to(dev)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    step = TrainStep(model, opt, loss_fn=lambda m, x, y: m(x, labels=y)[0],
                     accumulate_steps=accumulate_steps)
    t = torch.from_numpy(ids).to(dev)
    losses = [float(step(t[:, :-1], t[:, 1:])) for _ in range(steps)]
    return losses, {n: p.detach().float().cpu()
                    for n, p in model.named_parameters()}


def _tiny_grads(dev, ids):
    """The tiny Llama's loss and gradients on ``dev`` at the weights the
    first `TrainStep` sees (`_tiny_train`'s model and batch): the first
    step before the optimizer."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu",
                             seed=3).to(dev)
    t = torch.from_numpy(ids).to(dev)
    loss = model(t[:, :-1], labels=t[:, 1:])[0]
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().float().cpu()
                         for n, p in model.named_parameters()}


def _rel(a, b):
    """Largest ||a - b|| / ||b|| over the tensors of ``b``, and max
    |a - b|."""
    return (max(((a[n] - p).norm() / p.norm()).item()
                for n, p in b.items()),
            max((a[n] - p).abs().max().item() for n, p in b.items()))


def tiny_train_parity():
    """A tiny f32 Llama trained three AdamW `TrainStep`s on the card
    (kernels) and on the CPU (plain versions) from the same weights: the
    losses within their budget, and the first step's gradients card
    against CPU within theirs, with a planted wrong gradient on one
    parameter that must break it; on the card, ``accumulate_steps=2``
    against 1, losses and parameters."""
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    ids = np.random.default_rng(5).integers(0, 512, (4, 65))
    reset_launch_counts()
    card, cparams = _tiny_train("cuda", ids)
    counts = dict(launch_counts)
    cpu, _ = _tiny_train("cpu", ids)
    acc, aparams = _tiny_train("cuda", ids, accumulate_steps=2)
    loss_c, grads_c = _tiny_grads("cuda", ids)
    loss_p, grads_p = _tiny_grads("cpu", ids)
    planted = dict(grads_c)
    planted[TINY_TRAIN_PLANTED_GRAD] = planted[TINY_TRAIN_PLANTED_GRAD] \
        * 1.01
    dl = max(abs(a - b) for a, b in zip(card + [loss_c], cpu + [loss_p]))
    dg, dg_max = _rel(grads_c, grads_p)
    dg_planted, _ = _rel(planted, grads_p)
    dl_acc = max(abs(a - b) for a, b in zip(acc, card))
    dp_acc, dp_acc_max = _rel(aparams, cparams)
    log(f"tiny train parity: losses card {card} cpu {cpu}; first step "
        f"loss card {loss_c} cpu {loss_p}; max |loss diff| {dl:.3g} "
        f"(budget {TINY_TRAIN_LOSS_BUDGET}); first-step gradients: "
        f"relative diff {dg:.3g} (budget {TINY_TRAIN_GRAD_BUDGET}), max "
        f"|diff| {dg_max:.3g}; planted ({TINY_TRAIN_PLANTED_GRAD} x 1.01) "
        f"{dg_planted:.3g}; accumulate_steps=2 vs 1 on the card: loss "
        f"{dl_acc:.3g}, params relative {dp_acc:.3g} (budget "
        f"{TINY_TRAIN_PARAM_BUDGET}), max |diff| {dp_acc_max:.3g}; card "
        f"launches {counts}")
    # 2 layers x 3 steps; 5 norms per step
    if counts["flash_attention_fwd"] != 6 or counts["rms_norm_bwd"] != 15:
        raise AssertionError("tiny training did not run the kernels")
    if dg_planted <= TINY_TRAIN_GRAD_BUDGET:
        raise AssertionError("tiny train parity: a wrong gradient passes "
                             "the gradient check")
    if max(dl, dl_acc) > TINY_TRAIN_LOSS_BUDGET \
            or dg > TINY_TRAIN_GRAD_BUDGET \
            or dp_acc > TINY_TRAIN_PARAM_BUDGET or card[-1] >= card[0]:
        raise AssertionError("tiny Llama training: card and CPU disagree")


def _train_flops(cfg, tokens, seq, embedding=True):
    """bench.py:1995-1999: 6ND plus the attention term; with
    ``embedding=False`` N leaves out the input embedding table, whose
    lookup is no matmul (an untied table: the head's stays)."""
    n = cfg.num_params()
    if not embedding and not cfg.tie_word_embeddings:
        n -= cfg.vocab_size * cfg.hidden_size
    return 6.0 * n * tokens + \
        12 * cfg.num_hidden_layers * cfg.hidden_size * seq * tokens


def _mfu(cfg, tokens, seq, step_s):
    """(MFU by the bench.py formula, MFU without the input embedding)
    over the card's bf16 peak: the second is the share of the card the
    step's matmuls use."""
    return tuple(_train_flops(cfg, tokens, seq, e) / step_s / PEAK_BF16
                 for e in (True, False))


def train_8b_width():
    """5 AdamW steps of Llama-3-8B at full width, cut to
    `TRAIN_8B_LAYERS` decoder layers, on one seeded batch; returns the
    launch counts of the 5 steps."""
    import torch
    from unittest import mock
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.recipes.llama_pretrain import (
        TRAIN_8B_LAYERS, TRAIN_8B_SHAPE, train_8b_config)
    full_params = LlamaConfig.llama3_8b().num_params()
    cfg = train_8b_config()
    L, (b, s) = TRAIN_8B_LAYERS, TRAIN_8B_SHAPE
    log(f"train_8b_width: llama3_8b at full width cut to {L} of 32 decoder "
        f"layers: AdamW with multi_precision holds 16 bytes a parameter "
        f"(bf16 weight and grad, f32 master, m and v), "
        f"{16 * full_params / 1e9:.0f} GB at full depth "
        f"({full_params / 1e9:.2f}B parameters) against the card's 80 GB; "
        f"{cfg.num_params() / 1e9:.2f}B parameters at {L} layers")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1))).cuda()
    x, y = ids[:, :-1], ids[:, 1:]

    # kernels against plain versions, one forward and backward each; the
    # plain versions under a planted fault show the budgets catch it
    named = ("model.embed_tokens.weight",
             "model.layers.0.input_layernorm.weight",
             "model.layers.0.self_attn.q_proj.weight",
             "model.layers.0.self_attn.k_proj.weight",
             "model.layers.3.self_attn.v_proj.weight",
             "model.layers.3.mlp.down_proj.weight", "model.norm.weight",
             "lm_head.weight")
    params = dict(model.named_parameters())

    def fwd_bwd(use_kernel):
        loss, _ = model(x, labels=y, use_kernel=use_kernel)
        loss.backward()
        out = (float(loss.detach()), {n: params[n].grad.float()
                                      for n in named})
        for p in model.parameters():
            p.grad = None
        del loss
        torch.cuda.empty_cache()
        return out

    lp, gp = fwd_bwd(False)

    def against_plain(run):
        loss, grads = run
        return abs(loss - lp) / abs(lp), {
            n: ((grads[n] - gp[n]).norm() / gp[n].norm()).item()
            for n in named}
    kernel_run = fwd_bwd(True)
    lk = kernel_run[0]
    loss_rel, grad_rel = against_plain(kernel_run)
    del kernel_run
    with mock.patch.object(fa, "_live", _skip_tile(fa._live)):
        fault_loss, fault_grad = against_plain(fwd_bwd(False))
    del gp
    torch.cuda.empty_cache()
    log(f"train_8b_width path check: loss kernels {lk:.6f} plain {lp:.6f} "
        f"(relative diff {loss_rel:.3g}, budget {TRAIN_LOSS_REL_BUDGET}); "
        f"relative grad-norm differences {json.dumps(grad_rel)} (budget "
        f"{TRAIN_GRAD_REL_BUDGET}); planted fault (every row skips the "
        f"K tile of its last key, plain versions): loss {fault_loss:.3g}, "
        f"grads {json.dumps(fault_grad)}")
    if not (np.isfinite(lk) and loss_rel <= TRAIN_LOSS_REL_BUDGET
            and max(grad_rel.values()) <= TRAIN_GRAD_REL_BUDGET):
        raise AssertionError("8B-width training: kernels and plain "
                             "versions disagree")
    if max(fault_grad.values()) <= TRAIN_GRAD_REL_BUDGET:
        raise AssertionError("8B-width training: the gradient budget "
                             "misses the planted fault")

    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, opt, loss_fn=lambda m, a, c: m(a, labels=c)[0])
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))   # waits for the step
        times.append(time.perf_counter() - t0)
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: 0 for k in counts}
    want.update(flash_attention_fwd=L * TRAIN_STEPS,
                flash_attention_bwd_dq=L * TRAIN_STEPS,
                flash_attention_bwd_dkv=L * TRAIN_STEPS,
                rms_norm=(2 * L + 1) * TRAIN_STEPS,
                rms_norm_bwd=(2 * L + 1) * TRAIN_STEPS)
    log(f"launches (training) {counts} expected {want} over {TRAIN_STEPS} "
        f"steps")
    if counts != want:
        raise AssertionError("training launch counts do not match the "
                             "steps")
    # one more step with CUDA events around each flash forward and each
    # flash backward (delta, dQ and dK/dV): their device time within a
    # step
    spans, fspans = [], []
    with mock.patch.object(fa, "_flash_bwd",
                           _event_spans(fa._flash_bwd, spans)), \
            mock.patch.object(fa, "_flash_fwd",
                              _event_spans(fa._flash_fwd, fspans)):
        float(step(x, y))
    torch.cuda.synchronize()
    flash_bwd_ms = sum(a.elapsed_time(c) for a, c in spans)
    flash_fwd_ms = sum(a.elapsed_time(c) for a, c in fspans)
    step_s = statistics.median(times[1:])
    tokens = b * s
    stats = dict(layers=L, batch=b, seq=s, params=cfg.num_params(),
                 losses=losses, step_ms=1e3 * step_s,
                 first_step_ms=1e3 * times[0],
                 tokens_per_s=tokens / step_s,
                 mfu=_mfu(cfg, tokens, s, step_s)[0],
                 mfu_without_embedding=_mfu(cfg, tokens, s, step_s)[1],
                 peak_mem_gib=peak, build_s=build_s,
                 flash_fwd_ms_per_step=flash_fwd_ms,
                 flash_bwd_ms_per_step=flash_bwd_ms,
                 flash_bwd_calls_timed=len(spans),
                 flash_design=fa.sm90_design(torch.bfloat16, cfg.head_dim),
                 launches_per_step={k: v // TRAIN_STEPS
                                    for k, v in counts.items() if v},
                 path_check=dict(loss_rel_diff=loss_rel,
                                 grad_rel_diff=grad_rel,
                                 planted_fault_loss_rel_diff=fault_loss,
                                 planted_fault_grad_rel_diff=fault_grad))
    log("train_8b_width " + json.dumps(stats))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"8B-width training loss did not fall: "
                             f"{losses}")
    del step, opt, model
    torch.cuda.empty_cache()
    return counts


def train_recipe():
    """The ported pretraining recipe in-process at the bench shape."""
    import torch
    from unittest import mock
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.recipes import llama_pretrain
    b, s = 8, 2048
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    # CUDA events around each flash forward and each flash backward
    # (delta, dQ and dK/dV)
    spans, fspans = [], []
    with mock.patch.object(fa, "_flash_bwd",
                           _event_spans(fa._flash_bwd, spans)), \
            mock.patch.object(fa, "_flash_fwd",
                              _event_spans(fa._flash_fwd, fspans)):
        r = llama_pretrain.main(["--size", "bench", "--bf16",
                                 "--batch-size", str(b), "--seq-len",
                                 str(s), "--steps", str(TRAIN_STEPS),
                                 "--log-every", "1"])
    torch.cuda.synchronize()
    cfg = llama_pretrain.bench_config()
    L = cfg.num_hidden_layers
    per_step = [sum(a.elapsed_time(c) for a, c in spans[i:i + L])
                for i in range(0, len(spans), L)]
    fwd_per_step = [sum(a.elapsed_time(c) for a, c in fspans[i:i + L])
                    for i in range(0, len(fspans), L)]
    step_s = statistics.median(r.step_seconds[1:])
    counts = {k: v for k, v in launch_counts.items() if v}
    stats = dict(size="bench", batch=b, seq=s, params=cfg.num_params(),
                 final_loss=r.final_loss, step_ms=1e3 * step_s,
                 first_step_ms=1e3 * r.step_seconds[0],
                 tokens_per_s=b * s / step_s,
                 mfu=_mfu(cfg, b * s, s, step_s)[0],
                 mfu_without_embedding=_mfu(cfg, b * s, s, step_s)[1],
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 flash_fwd_ms_per_step=statistics.median(fwd_per_step[1:]),
                 flash_fwd_ms_steps=fwd_per_step,
                 flash_bwd_ms_per_step=statistics.median(per_step[1:]),
                 flash_bwd_ms_steps=per_step,
                 flash_design=fa.sm90_design(torch.bfloat16, cfg.head_dim),
                 launches=counts)
    log("train_recipe " + json.dumps(stats))
    torch.cuda.empty_cache()
    if not np.isfinite(r.final_loss) or \
            counts.get("flash_attention_fwd") != L * TRAIN_STEPS:
        raise AssertionError("the recipe did not train through the kernels")
    return stats


RECOMPUTE_STEPS = 3


def _recompute_launches(L, steps, recompute):
    """Exact launches of `steps` training steps of an L-layer Llama:
    under recompute each layer's flash forward and its two RMSNorm
    forwards run again in the backward; the final norm stays outside."""
    return dict(flash_attention_fwd=(2 if recompute else 1) * L * steps,
                flash_attention_bwd_dq=L * steps,
                flash_attention_bwd_dkv=L * steps,
                rms_norm=((4 if recompute else 2) * L + 1) * steps,
                rms_norm_bwd=(2 * L + 1) * steps)


def _token_file(root):
    """The repository's README.md and docs/*.md as one text file,
    encoded with `ByteTokenizer` by `encode_file` into ``tokens.bin``:
    (text path, bin path, token count)."""
    import glob
    from paddle_tpu_torch.text import encode_file
    txt = os.path.join(root, "corpus.txt")
    with open(txt, "w", encoding="utf-8") as out:
        for src in [os.path.join(HERE, "README.md")] + sorted(
                glob.glob(os.path.join(HERE, "docs", "*.md"))):
            with open(src, encoding="utf-8") as f:
                out.write(f.read())
    path = os.path.join(root, "tokens.bin")
    return txt, path, encode_file(txt, path)


def train_8b_recompute(recipe_stats):
    """5h: activation recompute at the 8B width, the recipe with
    ``--recompute --data``, the data loader's workers and BPE; returns
    the recompute run's launch counts."""
    import tempfile
    import torch
    from unittest import mock
    from paddle_tpu_torch.io import DataLoader
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.recipes import llama_pretrain
    from paddle_tpu_torch.recipes.llama_pretrain import (
        TRAIN_8B_LAYERS, TRAIN_8B_SHAPE, train_8b_config)
    from paddle_tpu_torch.text import (BPETokenizer, FileTokens,
                                       LMBlockDataset)
    t_phase = time.perf_counter()
    cfg = train_8b_config()
    cfg.recompute = True
    L, (b, s) = TRAIN_8B_LAYERS, TRAIN_8B_SHAPE
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1))).cuda()
    x, y = ids[:, :-1], ids[:, 1:]
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    init = [p.detach().clone() for p in params]

    # one forward and backward a policy from the same weights: loss,
    # every gradient and the peak above the weights
    def fwd_bwd(recompute, policy="full"):
        model.config.recompute = recompute
        model.config.recompute_policy = policy
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = model(x, labels=y)
        loss.backward()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        grads = [p.grad for p in params]
        for p in params:
            p.grad = None
        return loss.detach(), grads, peak
    l_off, g_off, peak_off = fwd_bwd(False)
    policy_peaks = {"off": peak_off}
    policy_equal = {}
    for policy in ("full", "dots_with_no_batch_dims"):
        loss, grads, policy_peaks[policy] = fwd_bwd(True, policy)
        policy_equal[policy] = bool(torch.equal(loss, l_off)) and all(
            torch.equal(a, c) for a, c in zip(grads, g_off))
        del grads

    # the planted fault: the skipped K tile in the flash forward of the
    # backward's recompute only (the first L calls are the forward's)
    calls = [0]
    real_fwd = fa._flash_fwd

    def faulty_fwd(q, k, v, scale, causal, window, _design=None):
        calls[0] += 1
        if calls[0] <= L:
            return real_fwd(q, k, v, scale, causal, window, _design)
        with mock.patch.object(fa, "_live", _skip_tile(fa._live)):
            return fa.flash_attention_ref(q, k, v, causal, scale, window)
    with mock.patch.object(fa, "_flash_fwd", faulty_fwd):
        f_loss, f_grads, _ = fwd_bwd(True)
    fault_differs = [n for n, a, c in zip(names, f_grads, g_off)
                     if not torch.equal(a, c)]
    fault_rel = max(((a.float() - c.float()).norm() / c.float().norm())
                    .item() for a, c in zip(f_grads, g_off)
                    if c.float().norm() > 0)
    del f_grads, g_off
    log(f"train_8b_recompute path check: one forward and backward a "
        f"policy from the same weights, loss and all {len(params)} "
        f"gradients bitwise equal to the run without recompute "
        f"{json.dumps(policy_equal)}; peak above the weights (GiB) "
        f"{json.dumps(policy_peaks)}; planted fault (the recompute's "
        f"flash forward skips the K tile of each row's last key): "
        f"forward loss equal {bool(torch.equal(f_loss, l_off))}, "
        f"{len(fault_differs)} of {len(params)} gradients differ, largest "
        f"relative difference {fault_rel:.3g} (5e's budget "
        f"{TRAIN_GRAD_REL_BUDGET})")
    if calls[0] != 2 * L:
        raise AssertionError(f"recompute: {calls[0]} flash forwards in one "
                             f"forward and backward, expected {2 * L}")
    if not fault_differs or fault_rel <= TRAIN_GRAD_REL_BUDGET:
        raise AssertionError("recompute: the planted fault in the "
                             "recompute does not break the comparison")

    # 3 AdamW steps without and with recompute from the same weights
    runs = {}
    for recompute in (False, True):
        with torch.no_grad():
            for p, w in zip(params, init):
                p.copy_(w)
        model.config.recompute = recompute
        model.config.recompute_policy = "full"
        opt = AdamW(learning_rate=3e-4, parameters=params,
                    weight_decay=0.01, multi_precision=True)
        # the peak up to each AdamW update (forward and backward, the
        # optimizer's state held from step 2 on) and over whole steps
        peaks = {"fwd_bwd": 0, "step": 0}
        adam_step = opt.step

        def step_with_peaks(*a, **k):
            peaks["fwd_bwd"] = max(peaks["fwd_bwd"],
                                   torch.cuda.max_memory_allocated())
            out = adam_step(*a, **k)
            peaks["step"] = max(peaks["step"],
                                torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            return out
        opt.step = step_with_peaks
        step = TrainStep(model, opt,
                         loss_fn=lambda m, a, c: m(a, labels=c)[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        losses, times = [], []
        for _ in range(RECOMPUTE_STEPS):
            t0 = time.perf_counter()
            losses.append(step(x, y))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        counts = dict(launch_counts)
        want = {k: 0 for k in counts}
        want.update(_recompute_launches(L, RECOMPUTE_STEPS, recompute))
        # the parameters kept on the host: a copy on the card would
        # count in the next run's peak
        runs[recompute] = dict(
            losses=torch.stack(losses).cpu(), counts=counts, want=want,
            params=[p.detach().cpu() for p in params],
            peak=peaks["step"] / 2 ** 30,
            peak_fwd_bwd=peaks["fwd_bwd"] / 2 ** 30,
            step_ms=1e3 * statistics.median(times[1:]))
        del opt.step                  # the wrapper's cycle back to opt
        del step, opt, step_with_peaks, adam_step
        torch.cuda.empty_cache()
    off, on = runs[False], runs[True]
    bitwise = bool(torch.equal(on["losses"], off["losses"])) and all(
        torch.equal(a, c) for a, c in zip(on["params"], off["params"]))
    first_diff = None
    if not bitwise:
        loss_rel = ((on["losses"] - off["losses"]).abs().max()
                    / off["losses"].abs().max()).item()
        for n, a, c in zip(names, on["params"], off["params"]):
            if not torch.equal(a, c):
                first_diff = dict(
                    name=n, rel=((a.float() - c.float()).norm()
                                 / c.float().norm()).item(),
                    max_abs=(a.float() - c.float()).abs().max().item(),
                    loss_rel=loss_rel)
                break
    del init, runs
    model.config.recompute = False
    del model, params, fwd_bwd
    gc.collect()
    torch.cuda.empty_cache()
    per_step = {k: v // RECOMPUTE_STEPS for k, v in on["counts"].items()
                if v}
    stats = dict(layers=L, batch=b, seq=s, steps=RECOMPUTE_STEPS,
                 losses_off=off["losses"].tolist(),
                 losses_recompute=on["losses"].tolist(),
                 bitwise_equal=bitwise, first_difference=first_diff,
                 step_ms_off=off["step_ms"], step_ms_recompute=on["step_ms"],
                 peak_mem_gib_off=off["peak"],
                 peak_mem_gib_recompute=on["peak"],
                 peak_fwd_bwd_gib_off=off["peak_fwd_bwd"],
                 peak_fwd_bwd_gib_recompute=on["peak_fwd_bwd"],
                 fwd_bwd_peak_above_weights_gib=policy_peaks,
                 policies_bitwise=policy_equal,
                 launches_per_step_recompute=per_step,
                 launches_per_step_off={
                     k: v // RECOMPUTE_STEPS
                     for k, v in off["counts"].items() if v},
                 rope_launches_per_step=per_step.get("rope", 0))
    log("train_8b_recompute " + json.dumps(stats))
    for run in (off, on):
        if run["counts"] != run["want"]:
            raise AssertionError(f"recompute launches {run['counts']} "
                                 f"expected {run['want']}")
    if not bitwise and not (first_diff["loss_rel"] <= TRAIN_LOSS_REL_BUDGET
                            and first_diff["rel"] <= TRAIN_GRAD_REL_BUDGET):
        raise AssertionError("recompute: the steps disagree past 5e's "
                             "budgets")
    if not all(policy_equal.values()):
        raise AssertionError(f"recompute: a policy's loss or gradients "
                             f"differ {policy_equal}")
    # the whole step's peak is AdamW's (its f32 temporaries over the
    # 525M-row tables outgrow the activations), the same in both runs
    if not (on["peak_fwd_bwd"] < off["peak_fwd_bwd"]
            and on["peak"] <= off["peak"]
            and policy_peaks["full"] < policy_peaks["off"]):
        raise AssertionError("recompute: the peak memory is not lower")

    with tempfile.TemporaryDirectory(prefix="pdt_recompute_") as root:
        txt, path, n_tokens = _token_file(root)
        # the recipe with --recompute --data on the bench model
        held = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        rb = 8
        r = llama_pretrain.main(["--size", "bench", "--bf16", "--recompute",
                                 "--data", path, "--batch-size", str(rb),
                                 "--seq-len", str(s), "--steps",
                                 str(TRAIN_STEPS), "--log-every", "1"])
        rcfg = llama_pretrain.bench_config()
        step_s = statistics.median(r.step_seconds[1:])
        recipe = dict(tokens_in_file=n_tokens, final_loss=r.final_loss,
                      step_ms=1e3 * step_s, tokens_per_s=rb * s / step_s,
                      mfu=_mfu(rcfg, rb * s, s, step_s)[0],
                      peak_mem_gib=torch.cuda.max_memory_allocated()
                      / 2 ** 30, held_before_gib=held,
                      recipe_5f=dict(step_ms=recipe_stats["step_ms"],
                                     tokens_per_s=recipe_stats[
                                         "tokens_per_s"],
                                     mfu=recipe_stats["mfu"],
                                     peak_mem_gib=recipe_stats[
                                         "peak_mem_gib"]),
                      mfu_counts="the model's flops (6ND + attention), "
                                 "not the recomputed forward")
        torch.cuda.empty_cache()
        if not np.isfinite(r.final_loss):
            raise AssertionError("the recipe with --recompute --data did "
                                 "not train")

        # the loader: 4 shared-memory workers forked from this process
        # (which holds a CUDA context) against the inline loader
        # (the first batch's wait, which holds the fork, apart from the
        # rate of the others)
        ds = LMBlockDataset(FileTokens(path), s)
        first, rates, got = {}, {}, {}
        for workers in (0, 4, 4, 0):
            t0 = time.perf_counter()
            it = iter(DataLoader(ds, batch_size=rb, num_workers=workers))
            batches = [next(it)]
            t1 = time.perf_counter()
            batches += list(it)
            t2 = time.perf_counter()
            first.setdefault(workers, []).append(1e3 * (t1 - t0))
            rates.setdefault(workers, []).append(
                (len(batches) - 1) / (t2 - t1))
            got[workers] = batches
        same = len(got[0]) == len(got[4]) and all(
            all(torch.equal(a, c) for a, c in zip(p, q))
            for p, q in zip(got[0], got[4]))
        loader = dict(batches=len(got[0]), batch=rb, seq=s,
                      equal=same, first_batch_ms_inline=first[0],
                      first_batch_ms_4_workers=first[4],
                      batches_per_s_inline=rates[0],
                      batches_per_s_4_workers=rates[4])

        # BPE: trained at vocab 512 on ~64 KB of the text; the native
        # encode against the plain one
        with open(txt, encoding="utf-8") as f:
            text = f.read()
        corpus = text[:65536]
        t0 = time.perf_counter()
        bpe = BPETokenizer.train(corpus, vocab_size=512)
        train_s = time.perf_counter() - t0
        data = corpus.encode("utf-8")
        plain_data = data[:16384]
        t0 = time.perf_counter()
        native_ids = bpe.encode(data)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        plain_ids = bpe._encode_py(plain_data)
        plain_s = time.perf_counter() - t0
        bpe_equal = bool(np.array_equal(bpe.encode(plain_data), plain_ids))
        bpe_stats = dict(merges=len(bpe.merges), train_s=train_s,
                         corpus_bytes=len(data), ids=len(native_ids),
                         native_mb_per_s=len(data) / native_s / 1e6,
                         plain_bytes=len(plain_data),
                         plain_mb_per_s=len(plain_data) / plain_s / 1e6,
                         native_equals_plain=bpe_equal,
                         round_trip=bpe.decode(native_ids) == corpus)
    log("train_recipe_recompute_data " + json.dumps(recipe))
    log("data_loader " + json.dumps(loader))
    log("bpe " + json.dumps(bpe_stats))
    log(f"train_8b_recompute phase {time.perf_counter() - t_phase:.1f}s")
    if not (same and bpe_equal and bpe_stats["round_trip"]):
        raise AssertionError("the data pipeline disagrees with its inline "
                             "or plain version")
    return on["counts"]


RESUME_STEPS = 6
RESUME_AT = 3


def _resume_build(cfg, seed):
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.llama import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             seed=seed)
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, opt, loss_fn=lambda m, a, c: m(a, labels=c)[0])
    return model, opt, step


def _host_params(model):
    return {n: p.detach().to("cpu") for n, p in model.named_parameters()}


def _param_diff(a, b):
    """(every tensor bitwise equal, largest |a - b|) over named tensors."""
    same = all(a[n].equal(b[n]) for n in a)
    return same, max((a[n].float() - b[n].float()).abs().max().item()
                     for n in a)


def _uninterrupted(cfg, x, y):
    """`RESUME_STEPS` steps from seed 0: losses, host parameters and the
    launch counts."""
    import torch
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    model, opt, step = _resume_build(cfg, 0)
    reset_launch_counts()
    losses = [float(step(x, y)) for _ in range(RESUME_STEPS)]
    counts = dict(launch_counts)
    params = _host_params(model)
    del model, opt, step
    torch.cuda.empty_cache()
    return losses, params, counts


def _determinism_probe(cfg, b, s):
    """Each kernel of the path called twice on the same inputs at the
    8B slice's shapes: does it give the same bits?"""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import norm_kernels as nk
    gen = torch.Generator(device="cuda").manual_seed(9)
    H, HK, D = (cfg.num_attention_heads, cfg.num_key_value_heads,
                cfg.head_dim)
    q, k, v, do = (torch.randn(b, s, h, D, device="cuda", generator=gen)
                   .to(torch.bfloat16) for h in (H, HK, HK, H))
    x = torch.randn(b * s, cfg.hidden_size, device="cuda",
                    generator=gen).to(torch.bfloat16)
    w = torch.randn(cfg.hidden_size, device="cuda",
                    generator=gen).to(torch.bfloat16)
    g = torch.randn_like(x)

    def flash():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = fa.flash_attention_values(qq, kk, vv, causal=True)
        o.backward(do)
        return o, qq.grad, kk.grad, vv.grad

    def norm():
        xx, ww = x.detach().requires_grad_(), w.detach().requires_grad_()
        o = nk.rms_norm_values(xx, ww, cfg.rms_norm_eps)
        o.backward(g)
        return o, xx.grad, ww.grad

    f1, f2 = flash(), flash()
    n1, n2 = norm(), norm()
    return {"flash_attention_fwd": f1[0].equal(f2[0]),
            "flash_attention_bwd_dq": f1[1].equal(f2[1]),
            "flash_attention_bwd_dkv": f1[2].equal(f2[2])
            and f1[3].equal(f2[3]),
            "rms_norm": n1[0].equal(n2[0]),
            "rms_norm_bwd": n1[1].equal(n2[1]) and n1[2].equal(n2[2])}


def _card_checkpoint_drill():
    """The recipe's resume drill on a tiny Llama on the card, and
    `paddle_tpu_torch.save` / `load` of card tensors, bitwise."""
    import tempfile
    import torch
    import paddle_tpu_torch
    import paddle_tpu_torch.observability as telemetry
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.recipes.llama_pretrain import run_resume_drill
    telemetry.reset()
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cuda", seed=2)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    try:
        with tempfile.TemporaryDirectory(prefix="pdt_drill_") as d:
            run_resume_drill(model, opt, d)
    finally:
        telemetry.disable(clear_override=True)
    gen = torch.Generator(device="cuda").manual_seed(4)
    obj = {"bf16": torch.randn(64, 33, device="cuda",
                               generator=gen).to(torch.bfloat16),
           "f32": torch.randn(1000, device="cuda", generator=gen),
           "i64": torch.arange(-7, 9, device="cuda"),
           "nested": [torch.ones(3, device="cuda", dtype=torch.int8), 5]}
    with tempfile.TemporaryDirectory(prefix="pdt_io_") as d:
        path = os.path.join(d, "obj.pdparams")
        paddle_tpu_torch.save(obj, path)
        back = paddle_tpu_torch.load(path)
    same = all(back[k].is_cuda and back[k].equal(obj[k])
               for k in ("bf16", "f32", "i64")) and \
        back["nested"][0].equal(obj["nested"][0]) and back["nested"][1] == 5
    log(f"card checkpoint drill: resume drill held; save / load of card "
        f"tensors bitwise equal: {same}")
    if not same:
        raise AssertionError("paddle_tpu_torch.save / load of card tensors "
                             "is not bitwise")


def train_8b_resume():
    """`train_8b_config()` trained `RESUME_STEPS` steps straight through,
    twice, and once with a checkpoint after `RESUME_AT` and a resume into
    fresh objects (module docstring, 5e')."""
    import shutil
    import tempfile
    import torch
    import paddle_tpu_torch.observability as telemetry
    from paddle_tpu_torch.distributed.checkpoint import (
        flat_arrays, read_manifest, storage, verify_checkpoint)
    from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
    from paddle_tpu_torch.recipes.llama_pretrain import (
        TRAIN_8B_LAYERS, TRAIN_8B_SHAPE, train_8b_config)
    t_phase = time.perf_counter()
    cfg = train_8b_config()
    b, s = TRAIN_8B_SHAPE
    root = tempfile.mkdtemp(prefix="pdt_resume_")
    free = shutil.disk_usage(root).free
    # bf16 weights, f32 master, m and v: 14 bytes a parameter on disk
    need = 14 * cfg.num_params()
    log(f"train_8b_resume: temp directory {root}: {free / 1e9:.2f} GB free, "
        f"the checkpoint needs {need / 1e9:.2f} GB at {TRAIN_8B_LAYERS} "
        f"layers")
    if free < 1.05 * need:
        shutil.rmtree(root, ignore_errors=True)
        raise AssertionError("train_8b_resume: the disk cannot hold the "
                             "checkpoint")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1))).cuda()
    x, y = ids[:, :-1], ids[:, 1:]
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        la, pa, counts = _uninterrupted(cfg, x, y)
        lb, pb, _ = _uninterrupted(cfg, x, y)
        runs_s = time.perf_counter() - t0
        L = TRAIN_8B_LAYERS
        want = {k: 0 for k in counts}
        want.update({k: L * RESUME_STEPS for k in (
            "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")})
        want.update(rms_norm=(2 * L + 1) * RESUME_STEPS,
                    rms_norm_bwd=(2 * L + 1) * RESUME_STEPS)
        if counts != want:
            raise AssertionError(f"train_8b_resume: launches {counts}, "
                                 f"expected {want}")

        model, opt, step = _resume_build(cfg, 0)
        lc = [float(step(x, y)) for _ in range(RESUME_AT)]
        telemetry.enable()
        telemetry.clear_events()
        em = ElasticManager(root, save_interval_steps=1, keep_last=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        em.save(RESUME_AT - 1, model, opt)
        save_s = time.perf_counter() - t0
        groups_s = sum(e["dur_s"] for e in telemetry.events()
                       if e["name"] == "checkpoint.save")
        step_dir = os.path.join(root, f"step_{RESUME_AT - 1}")
        manifest = read_manifest(step_dir)
        nbytes = sum(e["nbytes"] for g in manifest["groups"].values()
                     for e in g.values())
        on_disk = sum(os.path.getsize(os.path.join(r, f))
                      for r, _, fs in os.walk(step_dir) for f in fs)
        t0 = time.perf_counter()
        res = verify_checkpoint(step_dir, rehash=True)
        verify_s = time.perf_counter() - t0
        if not res.ok:
            raise AssertionError(f"train_8b_resume: verify {res.errors}")
        del model, opt, step
        gc.collect()
        torch.cuda.empty_cache()
        free_mem = torch.cuda.mem_get_info()[0]

        model, opt, step = _resume_build(cfg, 1)
        torch.cuda.reset_peak_memory_stats()
        telemetry.clear_events()
        t0 = time.perf_counter()
        start = em.resume(model, opt)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        spans = telemetry.events()
        load_s = sum(e["dur_s"] for e in spans
                     if e["name"] == "checkpoint.load")
        resume_verify_s = sum(e["dur_s"] for e in spans
                              if e["name"] == "checkpoint.verify")
        telemetry.disable(clear_override=True)
        resume_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        got = {"model": storage.checksums(model.state_dict()),
               "opt": storage.checksums(flat_arrays(
                   opt.paddle_state_dict()))}
        digest_s = time.perf_counter() - t0
        loaded_equal = {g: got[g] == {k: e["checksum"] for k, e in
                                      manifest["groups"][g].items()}
                        for g in manifest["groups"]}
        lc += [float(step(x, y)) for _ in range(RESUME_STEPS - RESUME_AT)]
        pc = _host_params(model)
        del model, opt, step
        torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        yard_same, yard_diff = _param_diff(pb, pa)
        res_same, res_diff = _param_diff(pc, pa)
        det = _determinism_probe(cfg, b, s)
        stats = dict(
            layers=L, batch=b, seq=s, params=cfg.num_params(),
            host_cpus=os.cpu_count(), steps=RESUME_STEPS, resume_at=RESUME_AT, start=start,
            disk_free_gb=free / 1e9, checkpoint_bytes=nbytes,
            bytes_on_disk=on_disk,
            groups={g: sum(e["nbytes"] for e in v.values())
                    for g, v in manifest["groups"].items()},
            save_s=save_s, groups_written_s=groups_s,
            manifest_commit_gc_s=save_s - groups_s,
            save_gb_per_s=nbytes / groups_s / 1e9,
            verify_rehash_s=verify_s, verify_gb_per_s=nbytes / verify_s / 1e9,
            resume_s=resume_s, resume_verify_s=resume_verify_s,
            load_s=load_s, load_gb_per_s=nbytes / load_s / 1e9,
            loaded_digest_s=digest_s, loaded_state_equal=loaded_equal,
            card_free_gib_before_resume=free_mem / 2 ** 30,
            resume_peak_mem_gib=resume_peak, peak_mem_gib=peak,
            losses_uninterrupted=la, losses_yardstick=lb, losses_resumed=lc,
            yardstick_bitwise=yard_same and lb == la,
            yardstick_param_max_abs=yard_diff,
            resumed_bitwise=res_same and lc == la,
            resumed_param_max_abs=res_diff,
            kernels_bitwise_on_repeat=det,
            two_runs_s=runs_s, phase_s=time.perf_counter() - t_phase)
        log("train_8b_resume " + json.dumps(stats))
        if start != RESUME_AT or not all(loaded_equal.values()):
            raise AssertionError("train_8b_resume: the loaded state is not "
                                 "the saved state")
        if not all(np.isfinite(lc)):
            raise AssertionError("train_8b_resume: non-finite losses")
        if stats["yardstick_bitwise"] and not stats["resumed_bitwise"]:
            raise AssertionError("train_8b_resume: two straight runs agree "
                                 "bitwise, the resumed one does not")
    finally:
        telemetry.disable(clear_override=True)
        shutil.rmtree(root, ignore_errors=True)
    _card_checkpoint_drill()


# ---------------------------------------------------------------------------
# MoE (grouped matmul) and BERT (LayerNorm) training
# ---------------------------------------------------------------------------
# the mma.sync gmm kernel's K step (the wgmma one's is 64): the planted
# "skipped last K tile" drops the last GMM_TILE_K contraction terms; the
# m tile of both: the planted "tile->group map off by one" gives the rows
# of a group that share a tile with the group before it that group's
# matrix
GMM_TILE_K = 32
GMM_TILE_M = 128
# A14B-width MoE training, kernels against plain versions: bf16 rounded at
# other places through the layer, and a routed token whose top-8 holds a
# near tie may pick another expert on the two paths (the router reads
# activations rounded at other places), moving that expert's gradient
MOE_GRAD_REL_BUDGET = 5e-2
TINY_MOE_STEPS = 3


def _gmm_boundary_fault(plain, lhs, rhs, sizes, trans=False):
    """The plain grouped matmul (``plain``, `gmm_plain`) with its
    tile->group map off by one: the rows of a group that share an m tile
    with an earlier non-empty group take that group's matrix."""
    import torch
    sizes = [int(v) for v in torch.as_tensor(sizes).tolist()]
    out = plain(lhs, rhs, sizes, trans)
    start, prev = 0, None
    for e, s in enumerate(sizes):
        end = start + s
        if s and prev is not None and start % GMM_TILE_M:
            stop = min(end, (start // GMM_TILE_M + 1) * GMM_TILE_M)
            w = rhs[prev].float()
            out[start:stop] = (lhs[start:stop].float()
                               @ (w.T if trans else w)).to(out.dtype)
        if s:
            prev = e
        start = end
    return out


def _gmm_faults(gm, lhs, rhs, sizes, trans):
    """The plain grouped matmul, and its outputs under the two planted
    faults: the last `GMM_TILE_K` contraction terms skipped, and the
    tile->group map off by one (`_gmm_boundary_fault`)."""
    k = lhs.shape[1]
    skip = gm.gmm_plain(
        lhs[:, :k - GMM_TILE_K].contiguous(),
        (rhs[:, :, :k - GMM_TILE_K] if trans
         else rhs[:, :k - GMM_TILE_K]).contiguous(), sizes, trans)
    return gm.gmm_plain(lhs, rhs, sizes, trans), {
        "skip_last_k_tile": skip,
        "tile_group_off_by_one": _gmm_boundary_fault(gm.gmm_plain, lhs, rhs,
                                                     sizes, trans)}


def _gmm_library(lhs, rhs, sizes, trans):
    """One PyTorch call for the same grouped product where this torch has
    it (`torch._grouped_mm`): (ms, its output, note), or (None, None,
    why not); timed as a yardstick the port never calls."""
    import torch
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, None, "this torch has no torch._grouped_mm"
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    b = rhs.transpose(1, 2) if trans else rhs
    try:
        out = fn(lhs, b, offs=offs)
        torch.cuda.synchronize()
    except Exception as e:     # the yardstick only: its refusal is printed
        return None, None, f"torch._grouped_mm refused: {e}"[:300]
    return time_ms(lambda: fn(lhs, b, offs=offs)), out, \
        "torch._grouped_mm(lhs, rhs, offs=cumsum(group_sizes))"


def _mm_loop(lhs, rhs, sizes, trans):
    """The per-expert `torch.mm` loop in the inputs' dtype (cuBLAS), a
    second yardstick."""
    import torch
    out = torch.empty(lhs.shape[0], rhs.shape[1] if trans else rhs.shape[2],
                      dtype=lhs.dtype, device=lhs.device)
    start = 0
    for e, s in enumerate(sizes):
        if s:
            torch.mm(lhs[start:start + s], rhs[e].T if trans else rhs[e],
                     out=out[start:start + s])
        start += s
    return out


def gmm_phase(results, routed_sizes):
    """The grouped-matmul kernels against their plain version at the A14B
    expert shapes: gate/up and down, forward and transposed (the
    backward's d(lhs)), on the routed group sizes of the a14b run's first
    step, and gate/up on a skewed routing (half the rows to one expert,
    most experts empty). Both designs of these shapes (wgmma, the path's,
    and the mma.sync one it replaced) are held to scale-free limits, shown
    to catch two planted faults of the plain version, the wgmma one also
    bitwise on repeat, and timed in turns (mma.sync, wgmma, wgmma,
    mma.sync) beside ``torch._grouped_mm`` and a per-expert `torch.mm`
    loop. More cases, checked on their path's design(s): N off the
    multiples of 8 (the mma.sync route, by `gm.gmm_design`), M off the
    128-row tile with a group of one row, and K off the 64-wide k step
    (the wgmma kernel's last step reads TMA's zero fill past K) with rhs
    read either way."""
    import torch
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.ops import kernel_errors
    from paddle_tpu_torch.recipes.moe_train import train_a14b_config
    cfg = train_a14b_config()
    h, i, e = cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts
    m = int(sum(routed_sizes))
    # half the rows and 37 more to expert 0; 16 experts share the rest
    # (1021 or 1032 rows: boundaries inside m tiles); 47 experts empty
    skew = [0] * e
    skew[0] = m // 2 + 37
    rest = m - skew[0]
    for j in range(3, e, 4):
        skew[j] = rest // 16
    skew[3] += rest - sum(skew[1:])
    # M off the 128-row tile: 4001 rows, a 1-row group straddling a tile
    # boundary, rows past the last group
    tail = [127, 1, 0, 1500, 1, 2000, 0, 300] + [0] * (e - 8)
    gen = torch.Generator(device="cuda").manual_seed(12)
    dt = torch.bfloat16
    # (label, M, K, N, trans, sizes, timed): K the contraction, N the
    # output width
    cases = [("a14b_gate_up", m, h, i, False, routed_sizes, True),
             ("a14b_down", m, i, h, False, routed_sizes, True),
             ("a14b_gate_up_dlhs", m, i, h, True, routed_sizes, True),
             ("a14b_down_dlhs", m, h, i, True, routed_sizes, True),
             ("skewed_gate_up", m, h, i, False, skew, True),
             ("n_off_8", 4001, h, i - 4, False, tail, False),
             ("m_tail_one_row", 4001, h, i, True, tail, False),
             ("k_off_64", 4001, h + 40, i, False, tail, False),
             ("k_off_64_dlhs", 4001, h + 40, i, True, tail, False)]
    lim = gm.GMM_LIMITS[dt]
    for label, mm, k, n, trans, sizes, timed in cases:
        lhs = torch.randn(mm, k, device="cuda", generator=gen).to(dt)
        # the trans cases read rhs (E, N, K): the layer's (E, H, I) weight
        # seen from d(lhs)
        shape = (e, n, k) if trans else (e, k, n)
        rhs = (0.02 * torch.randn(*shape, device="cuda",
                                  generator=gen)).to(dt)
        gs = torch.tensor(sizes, device="cuda", dtype=torch.int32)
        design = gm.gmm_design(dt, k, n)
        designs = [design] + (["mma.sync"] if design == "wgmma" else [])
        outs = {des: gm.gmm(lhs, rhs, gs, trans, _design=des)
                for des in designs}
        again = gm.gmm(lhs, rhs, gs, trans, _design=design)
        ref, faults = _gmm_faults(gm, lhs, rhs, gs, trans)
        torch.cuda.synchronize()
        errs = {des: kernel_errors(out, ref) for des, out in outs.items()}
        fault_err = {f: kernel_errors(v, ref) for f, v in faults.items()}
        end = min(mm, sum(sizes))
        bitwise = torch.equal(outs[design], again)
        ok = all(r <= lim["rel"] and w <= lim["row"]
                 and bool(torch.isfinite(out).all())
                 and not out[end:].any()
                 for (r, w), out in zip(errs.values(), outs.values())) \
            and bitwise
        caught = all(r > lim["rel"] or w > lim["row"]
                     for r, w in fault_err.values())
        del faults, again
        runs = {}
        for des in (designs[::-1] + designs if timed else designs):
            runs.setdefault(des, []).append(time_ms(
                lambda: gm.gmm(lhs, rhs, gs, trans, _design=des)))
        lib_ms = lib_out = lib_rel = loop_ms = plain = None
        lib_note = None
        if timed:
            plain = time_ms(lambda: gm.gmm_plain(lhs, rhs, gs, trans),
                            iters=3, warmup=1)
            lib_ms, lib_out, lib_note = _gmm_library(lhs, rhs, gs, trans)
            lib_rel = None if lib_out is None else kernel_errors(lib_out,
                                                                 ref)
            loop_ms = time_ms(lambda: _mm_loop(lhs, rhs, sizes, trans),
                              iters=10)
        # an empty group's matrix is never read
        nbytes = 2 * (mm * k + sum(1 for s in sizes if s) * k * n + mm * n)
        b_ms, b_by = bound(nbytes, 2 * end * k * n, "bfloat16")
        for des in designs:
            ms = statistics.median(runs[des])
            rec = dict(kernel="grouped_matmul", case=label, design=des,
                       path_design=des == design, dtype="bfloat16", M=mm,
                       K=k, N=n, E=e, trans=trans,
                       nonempty_groups=sum(1 for s in sizes if s),
                       largest_group=max(sizes),
                       max_abs_err=(outs[des].float() - ref.float()).abs()
                       .max().item(), rel_row_errors=list(errs[des]),
                       limits=lim, planted_faults=fault_err,
                       bitwise_repeat=bitwise if des == design else None,
                       ms=ms, ms_runs=runs[des], plain_ms=plain,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                       library_note=lib_note, library_rel_row_errors=lib_rel,
                       mm_loop_ms=loop_ms, tflops=2 * end * k * n / ms / 1e9)
            log("kernel " + json.dumps(rec))
            results.append(rec)
        if not ok:
            raise AssertionError(f"grouped matmul kernels disagree on "
                                 f"{label}: {errs}, bitwise {bitwise}")
        if not caught:
            raise AssertionError(f"the grouped matmul limits miss a planted "
                                 f"fault: {fault_err}")
        if label == "n_off_8" and design != "mma.sync":
            raise AssertionError(f"N {n} took the {design} design")
        del lhs, rhs, outs, ref, lib_out
        torch.cuda.empty_cache()


def ln_phase(results):
    """The LayerNorm kernels against their plain versions at the BERT-base
    smoke batch (16384, 768) f32 and at (4096, 3584) bf16, beside
    `torch.nn.functional.layer_norm`. The forward's two designs
    (`nk.norm_design`) each within the limits, bitwise on repeat, mean
    and rstd within f32 rounding of each other, and a planted fault (the
    mean left out) outside the limits, timed in turns as in `rms_phase`
    (ms, device_ms, host_us). Then the backward's designs at
    `LN_BWD_SHAPES` (`norm_bwd_case`: a planted fault, the backward
    without the mean(w·g) term, must break the limits), the register-row
    design on the path at both."""
    import torch
    from paddle_tpu_torch.ops import kernel_errors
    from paddle_tpu_torch.ops import norm_kernels as nk
    gen = torch.Generator(device="cuda").manual_seed(13)
    eps = 1e-12
    lib = torch.nn.functional.layer_norm
    for n, h, name, affine in LN_FWD_SHAPES:
        dt = getattr(torch, name)
        lim = nk.LN_LIMITS[dt]
        isz = torch.empty((), dtype=dt).element_size()
        sets = [(torch.randn(n, h, device="cuda", generator=gen) + 0.5)
                .to(dt) for _ in range(rotation_sets(2 * n * h * isz))]
        x = sets[0]
        w = (1 + 0.1 * torch.randn(h, device="cuda", generator=gen)).to(dt)
        b = (0.1 * torch.randn(h, device="cuda", generator=gen)).to(dt)
        # without an affine: the constants `F.layer_norm` hands the
        # kernel, and the library call without weight and bias
        lw, lb = w, b
        if not affine:
            w, b = torch.ones_like(w), torch.zeros_like(b)
            lw = lb = None
        path = nk.norm_design(dt, h)
        designs = ("strided", "registers") if path == "registers" \
            else ("strided",)
        ref = nk.layer_norm_ref(x, w, b, eps)
        xf = x.float()
        # the planted forward fault: the mean left out
        fwd_fault = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True)
                                      + eps) * w.float() + b.float()).to(dt)
        fwd = {}
        for d in designs:
            y, mean, rstd = nk._ln_fwd(x, w, b, eps, _design=d)
            y2, mean2, rstd2 = nk._ln_fwd(x, w, b, eps, _design=d)
            torch.cuda.synchronize()
            fwd[d] = dict(
                y=y, mean=mean, rstd=rstd,
                y_errors=kernel_errors(y, ref),
                max_abs_err=(y.float() - ref.float()).abs().max().item(),
                bitwise_repeat=bool(torch.equal(y, y2) and torch.equal(
                    mean, mean2) and torch.equal(rstd, rstd2)),
                planted_fault_mean_left_out=kernel_errors(y, fwd_fault))
            del y2, mean2, rstd2
        stats_apart = None
        if len(designs) == 2:
            r, s_ = fwd["registers"], fwd["strided"]
            stats_apart = dict(
                mean=float(((r["mean"] - s_["mean"]).abs()
                            / xf.abs().mean(-1)).max()),
                rstd=float(((r["rstd"] - s_["rstd"]).abs()
                            / s_["rstd"]).max()))
        within = lambda e: e[0] <= lim["rel"] and e[1] <= lim["row"]
        ok = all(within(f["y_errors"]) and f["bitwise_repeat"]
                 for f in fwd.values())
        caught = not any(within(f["planted_fault_mean_left_out"])
                         for f in fwd.values())
        stats_ok = stats_apart is None or max(stats_apart.values()) <= \
            2 ** -18
        named = {d: (lambda xs, d=d: nk._ln_fwd(xs, w, b, eps, _design=d,
                                                 stats=False))
                 for d in designs}
        named["library"] = lambda xs: lib(xs, (h,), lw, lb, eps)
        named["entry"] = lambda xs: nk.layer_norm_values(xs, w, b, eps,
                                                         use_kernel=True)
        named["copy"] = lambda xs: xs.clone()
        times = timed_in_turns(named, sets)
        plain_fwd = time_ms(lambda: nk.layer_norm_ref(x, w, b, eps))
        # the timed forwards store no statistics
        fwd_b = bound(2 * n * h * isz + 2 * h * isz, 7 * n * h, name)
        base = dict(case=f"rows={n}" + ("" if affine else "_no_affine"),
                    dtype=name, N=n, H=h, affine=affine, limits=lim)
        lt = times["library"]
        for d in designs:
            f, t = fwd[d], times[d]
            rec = dict(kernel="layer_norm", **base, design=d,
                       path_design=d == path,
                       row_class=nk.row_class(dt, h)
                       if d == "registers" else None,
                       rel_row_errors={"y": f["y_errors"]},
                       max_abs_err=f["max_abs_err"],
                       bitwise_repeat=f["bitwise_repeat"],
                       planted_fault_mean_left_out=f[
                           "planted_fault_mean_left_out"],
                       stats_apart=stats_apart, ms=t["ms"],
                       device_ms=t["device_ms"], host_us=t["host_us"],
                       plain_ms=plain_fwd, bound_ms=fwd_b[0],
                       bound_by=fwd_b[1],
                       bound_fraction=fwd_b[0] / t["device_ms"],
                       library_ms=lt["ms"],
                       library_device_ms=lt["device_ms"],
                       library_host_us=lt["host_us"],
                       library_bound_fraction=fwd_b[0] / lt["device_ms"],
                       library_note="torch.nn.functional.layer_norm",
                       entry_ms=times["entry"]["ms"],
                       entry_host_us=times["entry"]["host_us"],
                       copy_device_ms=times["copy"]["device_ms"],
                       rotation_sets=len(sets))
            log("kernel " + json.dumps(rec))
            results.append(rec)
        if not (ok and stats_ok):
            raise AssertionError(f"LayerNorm kernels disagree: "
                                 f"{[f['y_errors'] for f in fwd.values()]},"
                                 f" stats apart {stats_apart}")
        if not caught:
            raise AssertionError("the LayerNorm limits miss the planted "
                                 "forward fault")
        del sets, x, ref, fwd, xf, fwd_fault
        torch.cuda.empty_cache()
    for label, n, h, name, affine in LN_BWD_SHAPES:
        recs = norm_bwd_case("ln", label, n, h, name, gen, results, affine)
        if recs[0]["design"] != "registers":
            raise AssertionError(f"the LayerNorm backward at {label} does "
                                 f"not take the registers design")


def _lm_loss(m, a, b):
    return m(a, labels=b)[0]


def _tiny_run(dev, build, batch, steps=TINY_MOE_STEPS, loss_fn=_lm_loss):
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    model = build().to(dev)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01)
    step = TrainStep(model, opt, loss_fn=loss_fn)
    args = [torch.as_tensor(t).to(dev) for t in batch]
    losses = [float(step(*args)) for _ in range(steps)]
    return losses, {n: p.detach().float().cpu()
                    for n, p in model.named_parameters()}


def _card_vs_cpu(label, build, batch, want_counts, loss_fn=_lm_loss):
    """Three AdamW steps of a tiny f32 model on the card (kernels) and on
    the CPU (plain versions) from the same weights and ``batch`` (the
    arguments of ``loss_fn(model, *batch)``, by default a causal LM's
    (inputs, labels)): losses and final parameters within the
    tiny-training budgets."""
    import torch
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    reset_launch_counts()
    card, cparams = _tiny_run("cuda", build, batch, loss_fn=loss_fn)
    counts = {k: v for k, v in launch_counts.items() if v}
    cpu, pparams = _tiny_run("cpu", build, batch, loss_fn=loss_fn)
    dl = max(abs(a - b) for a, b in zip(card, cpu))
    # a key bias's true gradient is zero (softmax ignores q.b_k, the same
    # for every key), so Adam's step there follows rounding noise: left
    # out, alone (`k_proj.bias`) or as the middle third of a fused
    # `qkv.bias` (GPT, DiT)
    def no_key_bias(n, t):
        if n.endswith("qkv.bias"):
            third = t.shape[0] // 3
            return torch.cat([t[:third], t[2 * third:]])
        return t
    dp = max(((no_key_bias(n, cparams[n]) - no_key_bias(n, p)).norm()
              / no_key_bias(n, p).norm().clamp_min(1e-12)).item()
             for n, p in pparams.items() if not n.endswith("k_proj.bias"))
    log(f"{label}: losses card {card} cpu {cpu}; max |loss diff| {dl:.3g} "
        f"(budget {TINY_TRAIN_LOSS_BUDGET}); parameters after "
        f"{TINY_MOE_STEPS} steps relative diff {dp:.3g} (budget "
        f"{TINY_TRAIN_PARAM_BUDGET}); card launches {counts}")
    if any(counts.get(k, 0) != v for k, v in want_counts.items()):
        raise AssertionError(f"{label} did not run the kernels: {counts} "
                             f"against {want_counts}")
    if dl > TINY_TRAIN_LOSS_BUDGET or dp > TINY_TRAIN_PARAM_BUDGET or \
            card[-1] >= card[0]:
        raise AssertionError(f"{label}: card and CPU disagree")


def tiny_moe_train_parity():
    """The tiny f32 MoE (head dim 16), dropless (the grouped-matmul
    kernel) and capacity (einsums), card against CPU."""
    from paddle_tpu_torch.models.moe import MoEConfig, MoEForCausalLM
    ids = np.random.default_rng(6).integers(0, 512, (2, 65))
    for dropless in (True, False):
        cfg = MoEConfig.tiny()
        cfg.dropless = dropless
        L = cfg.num_hidden_layers
        # per step: 3 forward + 3 d(lhs) grouped matmuls a layer
        want = {"grouped_matmul": 6 * L * TINY_MOE_STEPS * dropless,
                "flash_attention_fwd": L * TINY_MOE_STEPS,
                "rms_norm_bwd": (2 * L + 1) * TINY_MOE_STEPS}
        mode = "dropless" if dropless else "capacity"
        _card_vs_cpu(f"tiny moe train parity ({mode})",
                     lambda: MoEForCausalLM(cfg, device="cpu", seed=4),
                     (ids[:, :-1], ids[:, 1:]), want)


def tiny_bert_train_parity():
    """The tiny f32 BERT at dropout 0 (LayerNorm kernels; attention by
    flash), card against CPU."""
    import torch
    from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
    cfg = BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    rng = np.random.default_rng(7)
    x = rng.integers(0, 261, (2, 64))
    y = np.where(rng.random((2, 64)) < 0.15, x, -100)
    L = cfg.num_hidden_layers
    n_ln = (2 * L + 2) * TINY_MOE_STEPS
    _card_vs_cpu("tiny bert train parity (dropout 0)",
                 lambda: BertForMaskedLM(cfg, device="cpu", seed=5),
                 (torch.from_numpy(x), torch.from_numpy(y)),
                 {"layer_norm": n_ln, "layer_norm_bwd": n_ln,
                  "flash_attention_fwd": L * TINY_MOE_STEPS})


def _moe_flops(cfg, tokens, seq):
    """6 · active parameters · tokens plus the attention term
    12 · L · h · S · tokens: the bench.py formula over the parameters a
    token multiplies by (top-k routed experts, shared expert, attention,
    router, lm_head)."""
    return 6.0 * cfg.active_params() * tokens + \
        12 * cfg.num_hidden_layers * cfg.hidden_size * seq * tokens


def train_moe_a14b_width():
    """5 AdamW steps of Qwen2-MoE-A14B at its published width cut to
    `TRAIN_A14B_LAYERS` decoder layer, dropless, on one seeded batch;
    returns (the 5 steps' launch counts, the first step's routed group
    sizes)."""
    import torch
    from unittest import mock
    from paddle_tpu_torch.incubate import moe as tmoe
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.moe import MoEConfig, MoEForCausalLM
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_matmul as gm
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.recipes.moe_train import (
        TRAIN_A14B_LAYERS, TRAIN_A14B_SHAPE, train_a14b_config)
    full = MoEConfig.qwen2_moe_a14b()
    cfg = train_a14b_config()
    L, (b, s) = TRAIN_A14B_LAYERS, TRAIN_A14B_SHAPE
    log(f"train_moe_a14b_width: qwen2_moe_a14b at full width cut to {L} of "
        f"{full.num_hidden_layers} decoder layers, dropless: AdamW with "
        f"multi_precision holds 16 bytes a parameter, "
        f"{16 * full.num_params() / 1e12:.2f} TB at full depth "
        f"({full.num_params() / 1e9:.1f}B parameters) against the card's "
        f"80 GB; {cfg.num_params() / 1e9:.2f}B parameters at {L} layer, "
        f"{cfg.active_params() / 1e9:.3f}B active a token")
    t0 = time.perf_counter()
    model = MoEForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s + 1))).cuda()
    x, y = ids[:, :-1], ids[:, 1:]

    # kernels against plain versions, one forward and backward each; the
    # plain versions under a planted fault (the gmm's tile->group map off
    # by one) show the budget catches it
    named = ("model.layers.0.mlp.w_gate", "model.layers.0.mlp.w_up",
             "model.layers.0.mlp.w_down", "model.layers.0.mlp.gate_weight",
             "model.layers.0.mlp.shared_up.weight",
             "model.layers.0.self_attn.q_proj.weight",
             "model.layers.0.input_layernorm.weight", "model.norm.weight")
    params = dict(model.named_parameters())

    def fwd_bwd(use_kernel):
        loss, _ = model(x, labels=y, use_kernel=use_kernel)
        loss.backward()
        out = (float(loss.detach()), {n: params[n].grad.clone()
                                      for n in named})
        for p in model.parameters():
            p.grad = None
        del loss
        torch.cuda.empty_cache()
        return out

    lp, gp = fwd_bwd(False)

    def against_plain(run):
        loss, grads = run
        return abs(loss - lp) / abs(lp), {
            n: ((grads[n].float() - gp[n].float()).norm()
                / gp[n].float().norm()).item() for n in named}
    loss_rel, grad_rel = against_plain(fwd_bwd(True))

    plain = gm.gmm_plain

    def boundary_fault(lhs, rhs, sizes, trans=False):
        return _gmm_boundary_fault(plain, lhs, rhs, sizes, trans)
    with mock.patch.object(gm, "gmm_plain", boundary_fault):
        fault_loss, fault_grad = against_plain(fwd_bwd(False))
    del gp
    torch.cuda.empty_cache()
    log(f"train_moe_a14b_width path check: loss relative diff "
        f"{loss_rel:.3g}; relative grad-norm differences "
        f"{json.dumps(grad_rel)} (budget {MOE_GRAD_REL_BUDGET}); planted "
        f"fault (plain gmm, the rows a group shares with the tile of the "
        f"group before it take that group's matrix): loss "
        f"{fault_loss:.3g}, grads {json.dumps(fault_grad)}")
    if not (loss_rel <= TRAIN_LOSS_REL_BUDGET
            and max(grad_rel.values()) <= MOE_GRAD_REL_BUDGET):
        raise AssertionError("A14B-width MoE training: kernels and plain "
                             "versions disagree")
    if max(fault_grad.values()) <= MOE_GRAD_REL_BUDGET:
        raise AssertionError("A14B-width MoE training: the gradient budget "
                             "misses the planted fault")

    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, opt, loss_fn=lambda m, a, c: m(a, labels=c)[0])
    sizes = []
    real_rows = tmoe._expert_ffn_rows

    def record_sizes(xs_in, eid, *a, **k):
        if not sizes:
            sizes.append(torch.bincount(eid, minlength=cfg.num_experts)
                         .tolist())
        return real_rows(xs_in, eid, *a, **k)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    with mock.patch.object(tmoe, "_expert_ffn_rows", record_sizes):
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(x, y)))   # waits for the step
            times.append(time.perf_counter() - t0)
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    drops = model.model.layers[0].mlp.last_drop_count
    want = {k: 0 for k in counts}
    want.update(grouped_matmul=6 * L * TRAIN_STEPS,
                flash_attention_fwd=L * TRAIN_STEPS,
                flash_attention_bwd_dq=L * TRAIN_STEPS,
                flash_attention_bwd_dkv=L * TRAIN_STEPS,
                rms_norm=(2 * L + 1) * TRAIN_STEPS,
                rms_norm_bwd=(2 * L + 1) * TRAIN_STEPS)
    log(f"launches (moe training) {counts} expected {want} over "
        f"{TRAIN_STEPS} steps")
    if counts != want:
        raise AssertionError("MoE training launch counts do not match the "
                             "steps")

    # one more step with CUDA events around every grouped matmul, every
    # d(rhs) and every flash backward (delta, dQ and dK/dV): their device
    # time within a step
    spans = {"gmm": [], "drhs": [], "flash_fwd": [], "flash_bwd": []}
    with mock.patch.object(gm, "_gmm_cuda",
                           _event_spans(gm._gmm_cuda, spans["gmm"])), \
            mock.patch.object(gm, "drhs_plain",
                              _event_spans(gm.drhs_plain, spans["drhs"])), \
            mock.patch.object(fa, "_flash_fwd",
                              _event_spans(fa._flash_fwd,
                                           spans["flash_fwd"])), \
            mock.patch.object(fa, "_flash_bwd",
                              _event_spans(fa._flash_bwd,
                                           spans["flash_bwd"])):
        float(step(x, y))
    torch.cuda.synchronize()
    span_ms = {k: sum(a.elapsed_time(c) for a, c in v)
               for k, v in spans.items()}
    step_s = statistics.median(times[1:])
    tokens = b * s
    stats = dict(layers=L, batch=b, seq=s, params=cfg.num_params(),
                 active_params=cfg.active_params(), losses=losses,
                 step_ms=1e3 * step_s, first_step_ms=1e3 * times[0],
                 tokens_per_s=tokens / step_s,
                 mfu_active=_moe_flops(cfg, tokens, s) / step_s / PEAK_BF16,
                 mfu_note="6 x active parameters (top-8 routed experts, "
                 "shared expert, attention, router, lm_head) x tokens plus "
                 "12 L h S tokens, over 989 TFLOP/s bf16",
                 peak_mem_gib=peak, build_s=build_s,
                 gmm_ms_per_step=span_ms["gmm"],
                 gmm_launches_timed=len(spans["gmm"]),
                 gmm_design=gm.gmm_design(torch.bfloat16, cfg.hidden_size,
                                          cfg.moe_intermediate_size),
                 flash_fwd_ms_per_step=span_ms["flash_fwd"],
                 drhs_ms_per_step=span_ms["drhs"],
                 flash_bwd_ms_per_step=span_ms["flash_bwd"],
                 flash_design=fa.sm90_design(torch.bfloat16, cfg.head_dim),
                 drops=drops, routed_rows=sum(sizes[0]),
                 nonempty_experts=sum(1 for v in sizes[0] if v),
                 largest_expert_rows=max(sizes[0]),
                 launches_per_step={k: v // TRAIN_STEPS
                                    for k, v in counts.items() if v},
                 path_check=dict(loss_rel_diff=loss_rel,
                                 grad_rel_diff=grad_rel,
                                 planted_fault_loss_rel_diff=fault_loss,
                                 planted_fault_grad_rel_diff=fault_grad))
    log("train_moe_a14b_width " + json.dumps(stats))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"A14B-width MoE training loss did not fall: "
                             f"{losses}")
    if drops != 0:
        raise AssertionError(f"the dropless path dropped {drops} slots")
    del step, opt, model, params
    torch.cuda.empty_cache()
    return counts, sizes[0]


def train_bert_base():
    """The ported BERT recipe in-process at BERT-base, f32, with its
    configured dropout; returns the 5 steps' launch counts."""
    import torch
    from paddle_tpu_torch.models.bert import BertConfig
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.recipes import bert_mlm
    b, s = 32, 512
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    r = bert_mlm.main(["--size", "base", "--batch-size", str(b),
                       "--seq-len", str(s), "--steps", str(TRAIN_STEPS),
                       "--log-every", "1"])
    counts = dict(launch_counts)
    cfg = BertConfig.base()
    step_s = statistics.median(r.step_seconds[1:])
    L = cfg.num_hidden_layers
    n_ln = (2 * L + 2) * TRAIN_STEPS
    stats = dict(size="base", batch=b, seq=s, dtype="float32",
                 params=cfg.num_params(),
                 dropout=[cfg.hidden_dropout_prob,
                          cfg.attention_probs_dropout_prob],
                 losses=r.losses, step_ms=1e3 * step_s,
                 first_step_ms=1e3 * r.step_seconds[0],
                 tokens_per_s=b * s / step_s,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches_per_step={k: v // TRAIN_STEPS
                                    for k, v in counts.items() if v},
                 note="attention dropout 0.1 sends attention to the plain "
                 "masked path, as in JAX: no flash launches")
    log("train_bert_base " + json.dumps(stats))
    want = {k: 0 for k in counts}
    want.update(layer_norm=n_ln, layer_norm_bwd=n_ln)
    if counts != want or not np.isfinite(r.final_loss):
        raise AssertionError(f"BERT training launches {counts}, expected "
                             f"{want}")
    torch.cuda.empty_cache()
    return counts


def train_moe_small():
    """The ported MoE recipe in-process at ``--size small --bf16``: the
    capacity path (MoEConfig's default) runs its experts as einsums, no
    grouped-matmul launch."""
    import torch
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.recipes import moe_train
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    r = moe_train.main(["--size", "small", "--bf16", "--steps",
                        str(TRAIN_STEPS), "--log-every", "1"])
    counts = {k: v for k, v in launch_counts.items() if v}
    step_s = statistics.median(r.step_seconds[1:])
    stats = dict(size="small", mode="capacity", batch=8, seq=128,
                 losses=r.losses, step_ms=1e3 * step_s,
                 tokens_per_s=8 * 128 / step_s,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 launches=counts,
                 grouped_matmul_launches=launch_counts["grouped_matmul"],
                 note="the capacity path computes its experts with einsums: "
                 "no grouped-matmul launch, as in JAX")
    log("train_moe_small " + json.dumps(stats))
    if launch_counts["grouped_matmul"] != 0 or \
            not np.isfinite(r.final_loss):
        raise AssertionError("the capacity MoE recipe did not train as "
                             "expected")
    torch.cuda.empty_cache()


# packed (varlen) attention and rope: the kernels against their plain
# versions (`varlen_phase`), then the two packed main paths at Llama-3-8B
# attention width (`packed_sft_8b`, `packed_pretrain_8b`)
VARLEN_TILE = 64          # q rows and keys per tile (csrc/flash_kernels.cuh)
PACKED_DOC_LENS = (64, 2048)
PACKED_SFT_TOKENS = 16384
PACKED_SFT_TAIL = 213
PACKED_PRETRAIN_SHAPE = (2, 8192)    # Llama 3's pretraining length
PACKED_PRETRAIN_THETA = 500000.0     # LlamaConfig.llama3_8b().rope_theta
# (label, B, Sq, Sk, H, HK, D, causal, dtype, packing, timed)
VARLEN_CASES = [
    ("packed_4096", 1, 4096, 4096, 32, 8, 128, True, "bfloat16", "docs",
     True),
    ("packed_4096_f32", 1, 4096, 4096, 8, 2, 128, True, "float32", "docs",
     False),
    ("sq1000_sk3000", 1, 1000, 3000, 8, 2, 128, True, "bfloat16", "suffix",
     False),
    ("single_tokens", 1, 700, 700, 8, 2, 64, True, "bfloat16", "singles",
     False),
    ("non_monotone", 2, 1000, 1000, 8, 2, 128, True, "bfloat16", "random",
     False),
    ("noncausal_f16", 1, 2000, 2000, 8, 2, 128, False, "float16", "docs",
     False),
    ("dit_d72", 2, 600, 600, 16, 16, 72, False, "bfloat16", "docs",
     False)]


def _doc_lengths(total, rng, lo=PACKED_DOC_LENS[0], hi=PACKED_DOC_LENS[1]):
    """Seeded document lengths in [lo, hi] filling `total` tokens (the
    last one cut to fit)."""
    lens = []
    while sum(lens) < total:
        lens.append(int(rng.integers(lo, hi + 1)))
    lens[-1] -= sum(lens) - total
    return lens


def _packed_segments(lens, total):
    """(total,) int32 ids: document n over its run, -1 past the last."""
    seg = np.full(total, -1, np.int32)
    seg[:sum(lens)] = np.repeat(np.arange(len(lens)), lens)
    return seg


def _varlen_case_segments(packing, b, sq, sk, rng):
    """(seg_q, seg_k) int32 arrays of shape (B, Sq) / (B, Sk): ``docs``
    packs seeded documents ending in a padding tail (segments do not
    line up with the 64-row tiles); ``suffix`` makes q the last Sq
    positions of k's packing (Sq != Sk, end-aligned); ``singles`` puts
    40 one-token segments before two-token ones; ``random`` draws ids
    in [-1, 3] per position (not monotone)."""
    if packing == "docs":
        seg = np.stack([_packed_segments(_doc_lengths(
            sq - 100, rng, 64, sq // 3), sq) for _ in range(b)])
        return seg, seg
    if packing == "suffix":
        seg_k = np.stack([_packed_segments(_doc_lengths(
            sk - 37, rng, 64, 600), sk) for _ in range(b)])
        return np.ascontiguousarray(seg_k[:, sk - sq:]), seg_k
    if packing == "singles":
        seg = np.repeat(np.arange(sq), 2)[None, :sq].astype(np.int32)
        seg[:, :40] = np.arange(40)
        seg[:, 40:] += 20
        return seg, seg
    seg = rng.integers(-1, 4, (b, sq)).astype(np.int32)
    return seg, seg


def _varlen_pairs(seg_q, seg_k, causal):
    """(q row, key) pairs the mask keeps, summed over the batch: the work
    of one head (the data-dependent count the bounds use)."""
    from paddle_tpu_torch.ops import flash_varlen as fv
    return int(fv._live(seg_q, seg_k, causal).sum())


def _tile_ranges(seg, tile):
    """Per tile of `tile` rows: (lo, hi) of its non-padding ids, hi = -1
    when it has none; (B, n_tiles) each."""
    import torch
    b, s = seg.shape
    n = -(-s // tile)
    pad = torch.full((b, n * tile - s), -1, dtype=seg.dtype,
                     device=seg.device)
    t = torch.cat([seg, pad], 1).reshape(b, n, tile)
    big = torch.iinfo(seg.dtype).max
    lo = torch.where(t >= 0, t, big).amin(-1)
    return lo, t.amax(-1)


def _skip_off_by_one(fv_live):
    """A planted fault of the plain version's mask: a (q tile, key tile)
    pair is visited when the q tile's segment range meets the range of
    the NEXT key tile (the skip test off by one tile), as a kernel would
    with that bug; keys of a skipped pair are dropped."""
    import torch

    def live(seg_q, seg_k, causal):
        m = fv_live(seg_q, seg_k, causal)
        qlo, qhi = _tile_ranges(seg_q, VARLEN_TILE)
        klo, khi = _tile_ranges(seg_k, VARLEN_TILE)
        # the next tile's range; past the last tile, none
        klo = torch.cat([klo[:, 1:], torch.full_like(klo[:, :1],
                                                     torch.iinfo(klo.dtype)
                                                     .max)], 1)
        khi = torch.cat([khi[:, 1:], torch.full_like(khi[:, :1], -1)], 1)
        meet = (qhi[:, :, None] >= 0) & (khi[:, None, :] >= 0) & \
            (qlo[:, :, None] <= khi[:, None, :]) & \
            (klo[:, None, :] <= qhi[:, :, None])
        sq, sk = seg_q.shape[1], seg_k.shape[1]
        qt = torch.arange(sq, device=seg_q.device) // VARLEN_TILE
        kt = torch.arange(sk, device=seg_q.device) // VARLEN_TILE
        return m & meet[:, qt][:, :, kt][:, None]
    return live


def _varlen_faults(fv, q, k, v, do, seg_q, seg_k, scale, causal):
    """The plain versions' (o, dq, dk, dv) under the planted faults:
    ``one_segment`` (the segment mask ignored: every non-padding
    position in one segment) and ``skip_off_by_one``."""
    import torch
    from unittest import mock

    def plain(sq_, sk_):
        o, lse = fv.flash_attention_varlen_ref(q, k, v, sq_, sk_, causal,
                                               scale)
        return (o, *fv.flash_attention_varlen_bwd_ref(
            q, k, v, o, lse, do, sq_, sk_, causal, scale))
    one = lambda s: torch.where(s >= 0, 0, -1).to(torch.int32)
    faults = {"one_segment": plain(one(seg_q), one(seg_k))}
    with mock.patch.object(fv, "_live", _skip_off_by_one(fv._live)):
        faults["skip_off_by_one"] = plain(seg_q, seg_k)
    return faults


def _varlen_plain_by_group(q, k, v, do, seg_q, seg_k, causal, scale):
    """The plain varlen forward and backward on full-size inputs, one
    batch row and one KV head's group of query heads at a time, so that
    only one group's dense (G, Sq, Sk) f32 scores are held (1 GiB at
    G = 4 and 8192 tokens): ``((o, dq, dk, dv), fwd ms, bwd ms)``, the
    times the device time of the pieces summed."""
    import torch
    from paddle_tpu_torch.ops import flash_varlen as fv
    b, h, hk = q.shape[0], q.shape[2], k.shape[2]
    g = h // hk
    o, dq = torch.empty_like(q), torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fwd_ms = bwd_ms = 0.0
    for i in range(b):
        rows = slice(i, i + 1)
        for j in range(hk):
            hs, ks = slice(j * g, (j + 1) * g), slice(j, j + 1)
            qc, dc = q[rows, :, hs], do[rows, :, hs]
            kc, vc = k[rows, :, ks], v[rows, :, ks]
            sq_, sk_ = seg_q[rows], seg_k[rows]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            oc, lc = fv.flash_attention_varlen_ref(qc, kc, vc, sq_, sk_,
                                                   causal, scale)
            ev[1].record()
            grads = fv.flash_attention_varlen_bwd_ref(
                qc, kc, vc, oc, lc, dc, sq_, sk_, causal, scale)
            ev[2].record()
            ev[2].synchronize()
            fwd_ms += ev[0].elapsed_time(ev[1])
            bwd_ms += ev[1].elapsed_time(ev[2])
            o[rows, :, hs], dq[rows, :, hs] = oc, grads[0]
            dk[rows, :, ks], dv[rows, :, ks] = grads[1], grads[2]
            del oc, lc, grads
    torch.cuda.empty_cache()
    return (o, dq, dk, dv), fwd_ms, bwd_ms


def _masked_sdpa_library(q, k, v, seg_q, seg_k, causal, lens=None):
    """The library's attention on the packed inputs, timed as a yardstick
    (the port never calls it): SDPA with an explicit block-diagonal
    (causal) bool mask, forward and whole backward; and, given the
    document lengths of a B = 1 packing, the loop of per-document SDPA
    ``is_causal`` calls (forward)."""
    import torch
    from paddle_tpu_torch.ops import flash_varlen as fv
    sdpa = torch.nn.functional.scaled_dot_product_attention
    mask = fv._live(seg_q, seg_k, causal)
    # K and V repeated to H heads (a mask with enable_gqa is not taken by
    # every backend); padding rows give NaN there, and are not compared
    g = q.shape[2] // k.shape[2]
    qh, kh, vh = (t.transpose(1, 2).repeat_interleave(
        1 if t is q else g, dim=1).detach().requires_grad_()
        for t in (q, k, v))
    kw = dict(attn_mask=mask)
    out = sdpa(qh, kh, vh, **kw)
    do = torch.randn_like(out)
    fwd = time_ms(lambda: sdpa(qh, kh, vh, **kw), iters=10)
    bwd = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), do,
                                              retain_graph=True), iters=10)
    loop = None
    if lens is not None:
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])

        def per_doc():
            for s0, n in zip(starts, lens):
                sdpa(qh[:, :, s0:s0 + n], kh[:, :, s0:s0 + n],
                     vh[:, :, s0:s0 + n], is_causal=causal)
        loop = time_ms(per_doc, iters=10)
    del out, mask
    return fwd, bwd, loop


# the rope phase's cases (label, B, S, H, HK, D, dtype, timed, bytes off
# 16 of q's pointer, the design `rp.rope_design` must pick): the packed
# pretraining run's q, k and q + k (HK 0: a single tensor), f32, f16 at D
# 72 with k, D 2 and a view off 16 bytes (both the pair design by rule)
def _rope_cases():
    b, s = PACKED_PRETRAIN_SHAPE
    return [("pretrain_q", b, s, 32, 0, 128, "bfloat16", True, 0, "vec"),
            ("pretrain_k", b, s, 8, 0, 128, "bfloat16", True, 0, "vec"),
            ("pretrain_qk", b, s, 32, 8, 128, "bfloat16", True, 0, "vec"),
            ("f32", 2, 1000, 4, 0, 128, "float32", False, 0, "vec"),
            ("f16_d72", 2, 999, 3, 1, 72, "float16", False, 0, "vec"),
            ("d2", 3, 17, 2, 1, 2, "bfloat16", False, 0, "pair"),
            ("view_off16", 2, 300, 4, 2, 128, "bfloat16", False, 8, "pair")]


def _rope_timed(rp, xs, c, sn, nbytes):
    """rope_vec, the pair design, ``clone`` of the same tensors (the same
    bytes read and written) and, for q + k, two single rope_vec launches,
    forward and backward (sign -1), in turns by `timed_in_turns` over
    input sets rotated past the L2 (the first set the case's own)."""
    import torch
    sets = [tuple(xs) + (None,) * (2 - len(xs))]
    for _ in range(rotation_sets(nbytes) - 1):
        sets.append(tuple(torch.randn_like(x, dtype=torch.float32)
                          .to(x.dtype) for x in xs) + (None,) * (2 - len(xs)))
    named = {}
    for sign, tag in ((1, ""), (-1, "_bwd")):
        named["vec" + tag] = lambda st, sg=sign: rp._launch(
            st[0], st[1], c, sn, sg)
        named["pair" + tag] = lambda st, sg=sign: rp._launch(
            st[0], st[1], c, sn, sg, _design="pair")
        if len(xs) == 2:
            named["vec_two" + tag] = lambda st, sg=sign: (
                rp._rope_cuda(st[0], c, sn, sg),
                rp._rope_cuda(st[1], c, sn, sg))
    named["clone"] = lambda st: [x.clone() for x in st if x is not None]
    return timed_in_turns(named, sets)


def _rope_phase(results):
    """The rope kernels (forward, and backward: sign -1) against their
    plain version, bitwise: both designs (`rp.rope_design`: rope_vec, q
    and k in one launch; the pair design) at the packed pretraining run's
    q, k and q + k shapes in bf16, in f32, f16 at D 72, D 2 and on a view
    off 16 bytes; planted faults (a sign error in the backward, half-split
    `rotate_half` pairs, trig one position off) must break the equality.
    The packed cases timed in turns (`_rope_timed`). ptxas's registers
    and spills of every rope kernel (a spill fails the run)."""
    import torch
    from paddle_tpu_torch.models.llama import precompute_rope
    from paddle_tpu_torch.ops import kernel_errors
    from paddle_tpu_torch.ops import rope as rp
    usage = ptxas_usage("rope")
    log("rope ptxas " + json.dumps({k: dict(registers=v[0],
                                            spill_stores=v[1],
                                            spill_loads=v[2])
                                    for k, v in usage.items()}))
    if not usage or any(v[1] or v[2] for v in usage.values()):
        raise AssertionError(f"rope kernels spill (or ptxas printed no "
                             f"usage): {usage}")
    gen = torch.Generator(device="cuda").manual_seed(27)
    for label, b, s, h, hk, d, name, timed, off, want in _rope_cases():
        dt = getattr(torch, name)
        cos, sin = (t.cuda() for t in precompute_rope(
            d, s + 1, PACKED_PRETRAIN_THETA))
        c, sn = cos[:s].contiguous(), sin[:s].contiguous()
        shift = off // dt.itemsize
        q = torch.randn(b * s * h * d + shift, device="cuda",
                        generator=gen).to(dt)[shift:].view(b, s, h, d)
        xs = [q]
        if hk:
            xs.append(torch.randn(b, s, hk, d, device="cuda",
                                  generator=gen).to(dt))
        k = xs[1] if hk else None
        design = rp.rope_design(dt, d, c.data_ptr(), sn.data_ptr(),
                                *(x.data_ptr() for x in xs))
        if design != want:
            raise AssertionError(f"rope_design picked {design} for {label}; "
                                 f"{want} expected")
        ok, err, outs = True, 0.0, {}
        for des in (("vec", "pair") if design == "vec" else ("pair",)):
            for sign in (1, -1):
                ys = rp._launch(q, k, c, sn, sign, _design=des)
                for x, y in zip(xs, ys):
                    r = rp.rope_ref(x, c, sn, float(sign))
                    ok = ok and torch.equal(y, r)
                    err = max(err, (y.float() - r.float()).abs().max().item())
                outs[des, sign] = ys[0]
        torch.cuda.synchronize()
        y, gx = outs[design, 1], outs[design, -1]
        half = d // 2
        x1, x2 = q[..., :half].float(), q[..., half:].float()
        cb, sb = c[None, :, None, :], sn[None, :, None, :]
        rotate_half = torch.cat([x1 * cb - x2 * sb, x2 * cb + x1 * sb],
                                -1).to(dt)
        faults = {"backward_sign": kernel_errors(gx, rp.rope_ref(q, c, sn,
                                                                 1.0)),
                  "trig_one_position_off": kernel_errors(
                      y, rp.rope_ref(q, cos[1:s + 1], sin[1:s + 1], 1.0))}
        # at D 2 the half-split pair is the interleaved one
        if d > 2:
            faults["half_split_pairs"] = kernel_errors(y, rotate_half)
        caught = all(e[0] > 1e-2 for e in faults.values())
        numel = sum(x.numel() for x in xs)
        nbytes = 2 * numel * dt.itemsize + 2 * c.numel() * 4
        # four f32 multiplies and two adds a pair, on the CUDA cores
        b_ms, b_by = bound(nbytes, 3 * numel, "float32")
        rec = dict(kernel="rope", case=label, dtype=name, shape=[b, s, h, d],
                   hk=hk, design=design, bitwise_equal=ok, max_abs_err=err,
                   planted_faults=faults, bound_ms=b_ms, bound_by=b_by,
                   ms=None, bwd_ms=None, plain_ms=None, library_ms=None,
                   library_note="none: no single PyTorch call computes "
                   "RoPE; clone_device_ms is a copy of the same bytes")
        if timed:
            t = _rope_timed(rp, xs, c, sn, nbytes)
            dev = t["vec"]["device_ms"]
            rec.update(
                ms=t["vec"]["ms"], bwd_ms=t["vec_bwd"]["ms"],
                device_ms=dev, bwd_device_ms=t["vec_bwd"]["device_ms"],
                host_us=t["vec"]["host_us"],
                bwd_host_us=t["vec_bwd"]["host_us"],
                bound_fraction=b_ms / dev,
                bwd_bound_fraction=b_ms / t["vec_bwd"]["device_ms"],
                pair_device_ms=t["pair"]["device_ms"],
                pair_bwd_device_ms=t["pair_bwd"]["device_ms"],
                pair_ms=t["pair"]["ms"],
                clone_device_ms=t["clone"]["device_ms"],
                over_clone=dev / t["clone"]["device_ms"],
                vec_two_device_ms=t.get("vec_two", {}).get("device_ms"),
                vec_two_bwd_device_ms=t.get("vec_two_bwd", {}).get(
                    "device_ms"),
                timings=t,
                plain_ms=time_ms(lambda: [rp.rope_ref(x, c, sn, 1.0)
                                          for x in xs], iters=5, warmup=1))
        log("kernel " + json.dumps(rec))
        results.append(rec)
        if not ok:
            raise AssertionError(f"rope kernel differs from its plain "
                                 f"version on {label}")
        if not caught:
            raise AssertionError(f"rope check misses a planted fault on "
                                 f"{label}: {faults}")
        del q, k, xs, y, gx, outs, rotate_half
    torch.cuda.empty_cache()


def _doc_runs(seg_np):
    """Lengths of the runs of equal ids of each row of a (B, S) packing,
    rows one after the other: the sequences of the flattened buffer that a
    cumulative-length library call takes (segments of different rows never
    pair, so this is exact for the documents; a run of padding is a
    sequence of its own there, where the kernels give it no key)."""
    lens = []
    for row in np.asarray(seg_np):
        cut = np.flatnonzero(np.diff(row)) + 1
        lens += np.diff(np.concatenate([[0], cut, [len(row)]])).tolist()
    return lens


def _varlen_library(q, k, v, do, seg_np, causal):
    """PyTorch's one call for packed attention, on the same packing (a
    yardstick; the port never calls it): `torch.nn.attention.varlen.
    varlen_attn` (GQA native, causal as window (-1, 0)) over the B rows
    flattened into one buffer with the cumulative lengths of `_doc_runs`,
    else the aten `_flash_attention_forward` / `_backward` with the same
    lengths (K and V repeated to H heads): the forward's and the whole
    backward's ms (events around one call, median of 20), the call and
    the torch version. A refusal is recorded in its own words."""
    import inspect
    import torch
    b, s, h, _ = q.shape
    hk = k.shape[2]
    lens = _doc_runs(seg_np)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      dtype=torch.int32, device="cuda")
    mx = int(max(lens))
    qf, kf, vf, dof = (t.reshape(b * s, *t.shape[2:]).detach()
                       for t in (q, k, v, do))
    rec = dict(torch=torch.__version__, sequences=len(lens), max_len=mx,
               library_fwd_ms=None, library_bwd_ms=None)
    try:
        from torch.nn.attention import varlen as tv
        fn = tv.varlen_attn
    except (ImportError, AttributeError):
        fn = None
    try:
        if fn is not None:
            params = inspect.signature(fn).parameters
            kw = {}
            if "window_size" in params:
                kw["window_size"] = (-1, 0) if causal else (-1, -1)
            else:
                kw["is_causal"] = causal
            if "enable_gqa" in params:
                kw["enable_gqa"] = True
            elif hk != h:
                kf, vf = (t.repeat_interleave(h // hk, dim=1)
                          for t in (kf, vf))
            rec["call"] = "torch.nn.attention.varlen.varlen_attn(" + \
                ", ".join(f"{k_}={v_!r}" for k_, v_ in kw.items()) + ")"
            leaves = [t.clone().requires_grad_() for t in (qf, kf, vf)]
            out = fn(*leaves, cu, cu, mx, mx, **kw)
            rec["library_fwd_ms"] = time_ms(
                lambda: fn(qf, kf, vf, cu, cu, mx, mx, **kw))
            rec["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                out, leaves, dof, retain_graph=True))
        else:
            aten = torch.ops.aten
            kf, vf = (t.repeat_interleave(h // hk, dim=1) for t in (kf, vf))
            rec["call"] = "torch.ops.aten._flash_attention_forward / " \
                "_flash_attention_backward (cum_seq_q, cum_seq_k)"
            fwd = lambda: aten._flash_attention_forward(
                qf, kf, vf, cu, cu, mx, mx, 0.0, causal, False)
            out, lse, rng, unused, _ = fwd()
            rec["library_fwd_ms"] = time_ms(fwd)
            rec["library_bwd_ms"] = time_ms(
                lambda: aten._flash_attention_backward(
                    dof, qf, kf, vf, out, lse, cu, cu, mx, mx, 0.0, causal,
                    rng, unused))
    except (RuntimeError, TypeError, ValueError, NotImplementedError) as e:
        rec["refused"] = f"{type(e).__name__}: {e}"[:400]
    torch.cuda.empty_cache()
    return rec


VARLEN_VARIANTS = ("mma.sync", "sm90", "sm90_other_order")


def _varlen_timed(q, k, v, do, seg_q, seg_k, scale, causal, o, lse):
    """The varlen kernels at one case, every variant in turns (the
    mma.sync design, the sm90 design in its block order,
    `fv.SM90_ORDER`, and in the other one; A B C, C B A) by
    `timed_in_turns` over input sets rotated past the L2 (device_ms:
    graphs of 20 launches; ms: one call between two events), the plan
    kernel and `_delta` (the mma.sync dQ reads it; the sm90 dQ, given o,
    forms it): {(kernel, variant): times}."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_varlen as fv
    delta = fa._delta(o, do)
    base = dict(q=q, k=k, v=v, do=do, o=o, lse=lse, delta=delta, sq=seg_q,
                sk=seg_k, plan=fv._varlen_plan(seg_q, seg_k, causal))
    nbytes = sum(t.numel() * t.element_size() for t in base.values())
    sets = [base] + [{n: t.clone() for n, t in base.items()}
                     for _ in range(rotation_sets(nbytes) - 1)]

    def kw(var, part, st):
        if var == "mma.sync":
            return dict(_design="mma.sync")
        out = dict(_design="sm90", plan=st["plan"])
        if var == "sm90_other_order":
            out["_order"] = _other_order(fv, part)
        if part == "dq":
            out["o"] = st["o"]   # the path's dQ: it forms delta
        return out
    named = {}
    for var in VARLEN_VARIANTS:
        named[("flash_varlen_fwd", var)] = lambda st, var=var: \
            fv._varlen_fwd(st["q"], st["k"], st["v"], st["sq"], st["sk"],
                           scale, causal, **kw(var, "fwd", st))
        named[("flash_varlen_bwd_dq", var)] = lambda st, var=var: \
            fv._varlen_bwd_dq(st["q"], st["k"], st["v"], st["do"],
                              st["lse"], st["delta"], st["sq"], st["sk"],
                              scale, causal, **kw(var, "dq", st))
        named[("flash_varlen_bwd_dkv", var)] = lambda st, var=var: \
            fv._varlen_bwd_dkv(st["q"], st["k"], st["v"], st["do"],
                               st["lse"], st["delta"], st["sq"], st["sk"],
                               scale, causal, **kw(var, "dkv", st))
    named[("flash_varlen_plan", "sm90")] = lambda st: fv._varlen_plan(
        st["sq"], st["sk"], causal)
    named[("delta", "torch")] = lambda st: fa._delta(st["o"], st["do"])
    times = timed_in_turns(named, sets, host=False)
    del sets, base
    return times


def _other_order(fv, part):
    """The block order the sm90 kernel ``part`` ("fwd", "dq", "dkv") does
    not launch in (`fv.SM90_ORDER`), timed beside its own."""
    return "plan" if fv.SM90_ORDER[part] == "dense" else "dense"


def _plan_record(fv, seg_q, seg_k, causal, label, times):
    """The plan kernel against `varlen_tile_plan` on the card (every
    field equal; max_abs_err the largest difference), its bound (the ids
    read once, the plan written once), and its times."""
    import torch
    b, sq = seg_q.shape
    sk = seg_k.shape[1]
    got = fv.unpack_plan(fv._varlen_plan(seg_q, seg_k, causal), b, sq, sk)
    want = fv.varlen_tile_plan(seg_q, seg_k, causal)
    err = max(int((x.to(torch.int64) - want[n].to(torch.int64)).abs().max())
              if x.numel() else 0 for n, x in got.items())
    words = fv._plan_layout(b, sq, sk)["words"]
    b_ms, b_by = bound(4 * (b * (sq + sk) + words), 0, "float32")
    rec = dict(kernel="flash_varlen_plan", case=label, dtype="int32",
               design="sm90", path_design=True, causal=causal,
               plan_equal=err == 0, max_abs_err=err, bound_ms=b_ms,
               bound_by=b_by, ms=None, device_ms=None, plain_ms=None,
               library_ms=None, library_note="none: no PyTorch call "
               "computes a segment tile plan",
               sorted=got["sorted"].tolist(),
               q_tiles_walked=int(got["q_count"].sum()),
               k_tiles_walked=int(got["k_count"].sum()))
    if times is not None:
        t = times[("flash_varlen_plan", "sm90")]
        rec.update(ms=t["ms"], device_ms=t["device_ms"],
                   plain_ms=time_ms(lambda: fv.varlen_tile_plan(
                       seg_q, seg_k, causal), iters=5, warmup=1))
    return rec


def _varlen_work(q, k, seg_q, seg_k, causal):
    """Bytes and operations of the three varlen kernels at these inputs:
    each input read once and each output written once (lse and delta
    rows, the ids), 4D, 6D and 8D flops a live (q row, key) pair of one
    head times H."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    pairs = _varlen_pairs(seg_q, seg_k, causal) * h
    isz = q.element_size()
    qo, kv = b * sq * h * d * isz, b * sk * hk * d * isz
    rows, segs = 4 * b * h * sq, 4 * b * (sq + sk)
    return pairs, {
        "flash_varlen_fwd": (qo * 2 + kv * 2 + rows + segs, 4 * d * pairs),
        "flash_varlen_bwd_dq": (qo * 3 + kv * 2 + 2 * rows + segs,
                                6 * d * pairs),
        "flash_varlen_bwd_dkv": (qo * 2 + kv * 4 + 2 * rows + segs,
                                 8 * d * pairs)}


def _varlen_records(label, name, designs, design, errs, abs_err, work,
                    times, extra):
    """The kernel records of one case: one a kernel and design (the sm90
    records with their block order and the other order's time beside);
    ``times`` from `_varlen_timed` or None."""
    from paddle_tpu_torch.ops import flash_varlen as fv
    recs = []
    parts = {"flash_varlen_fwd": ("o",), "flash_varlen_bwd_dq": ("dq",),
             "flash_varlen_bwd_dkv": ("dk", "dv")}
    for kernel, (nbytes, ops) in work.items():
        b_ms, b_by = bound(nbytes, ops, name)
        for des in designs:
            rec = dict(kernel=kernel, case=label, dtype=name, design=des,
                       path_design=des == design,
                       rel_row_errors={p: errs[des][p]
                                       for p in parts[kernel]},
                       max_abs_err=max(abs_err[des][p]
                                       for p in parts[kernel]),
                       bound_ms=b_ms, bound_by=b_by, ms=None,
                       device_ms=None, plain_ms=None, library_ms=None,
                       **extra)
            if times is not None:
                t = times[(kernel, des)]
                rec.update(ms=t["ms"], device_ms=t["device_ms"],
                           device_ms_turns=t["device_ms_turns"],
                           bound_fraction=b_ms / t["device_ms"])
                if kernel == "flash_varlen_bwd_dq":
                    rec.update(delta_ms=times[("delta", "torch")][
                        "device_ms"], delta_note="the sm90 dQ forms delta "
                        "from o; the mma.sync dQ reads `_delta`'s "
                        "(delta_ms)")
                if des == "sm90":
                    part = kernel.rsplit("_", 1)[1]
                    other = times[(kernel, "sm90_other_order")]
                    rec.update(order=fv.SM90_ORDER[part],
                               other_order=_other_order(fv, part),
                               other_order_device_ms=other["device_ms"],
                               other_order_ms=other["ms"],
                               mma_sync_over_sm90_device=times[
                                   (kernel, "mma.sync")]["device_ms"]
                               / t["device_ms"])
            recs.append(rec)
    return recs


def _varlen_libraries(recs, q, k, v, do, seg_q, seg_k, seg_np, causal,
                      plain_fwd, plain_bwd, lens=None):
    """The yardsticks beside the timed records: the plain versions' ms,
    the one-call library (`_varlen_library`: ``library_ms``), SDPA under
    the explicit block-diagonal mask and, given B = 1 document lengths,
    the per-document SDPA loop."""
    lib = _varlen_library(q, k, v, do, seg_np, causal)
    m_fwd, m_bwd, m_loop = _masked_sdpa_library(q, k, v, seg_q, seg_k,
                                                causal, lens)
    log("varlen_library " + json.dumps(lib))
    for rec in recs:
        if rec["kernel"] == "flash_varlen_plan":
            continue
        fwd = rec["kernel"] == "flash_varlen_fwd"
        lib_ms = lib["library_fwd_ms" if fwd else "library_bwd_ms"]
        rec.update(
            plain_ms=plain_fwd if fwd else plain_bwd, library_ms=lib_ms,
            library_call=lib.get("call"), library_torch=lib["torch"],
            library_refused=lib.get("refused"),
            masked_sdpa_ms=m_fwd if fwd else m_bwd,
            library_per_document_loop_fwd_ms=m_loop,
            library_note="library_ms: one call on the B rows flattened "
            "with cumulative lengths (varlen_library); masked_sdpa_ms: "
            "scaled_dot_product_attention under an explicit block-diagonal "
            "causal bool mask, K and V repeated to H heads",
            note=None if fwd else "plain_ms, library_ms and masked_sdpa_ms "
            "are the whole backward (dq, dk and dv together)")


def varlen_phase(results):
    """The varlen kernels, through `flash_attention_varlen_values`
    forward and backward (the path's design, `fv.varlen_design`) and
    through their launchers in both designs (sm90: wgmma + TMA over the
    device plan; mma.sync), against their plain versions on packed cases
    (`VARLEN_CASES`): the flash limits (`ops.flash_attention.
    KERNEL_LIMITS`), lse within 1e-3, padding rows and keys exactly zero,
    the plan kernel equal to `varlen_tile_plan`, the sm90 design bitwise
    on repeat and equal to the wrapper's; the limits are shown to catch
    the planted faults of `_varlen_faults`. The packed 4096-token case is
    timed (`_varlen_timed`: both designs and both block orders in turns)
    beside the plain versions, the one-call library, masked SDPA and the
    per-document SDPA loop. Then the rope kernel (`_rope_phase`)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_varlen as fv
    gen = torch.Generator(device="cuda").manual_seed(9)
    names = ("o", "dq", "dk", "dv")
    for (label, b, sq, sk, h, hk, d, causal, name, packing,
         timed) in VARLEN_CASES:
        dt = getattr(torch, name)
        lim = fa.KERNEL_LIMITS[dt]
        rng = np.random.default_rng(len(label))
        sq_np, sk_np = _varlen_case_segments(packing, b, sq, sk, rng)
        seg_q = torch.from_numpy(np.ascontiguousarray(sq_np)).cuda()
        seg_k = torch.from_numpy(np.ascontiguousarray(sk_np)).cuda()
        f = lambda *shape: torch.randn(*shape, device="cuda",
                                       generator=gen).to(dt)
        q, k, v, do = f(b, sq, h, d), f(b, sk, hk, d), f(b, sk, hk, d), \
            f(b, sq, h, d)
        scale = d ** -0.5
        design = fv.varlen_design(dt, d)
        designs = [design] + (["mma.sync"] if design == "sm90" else [])
        # the wrapper, forward and backward, as a user calls it
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fv.flash_attention_varlen_values(*leaves, seg_q, seg_k, causal,
                                             scale)
        o.backward(do)
        wrapper = (o.detach(), *(x.grad for x in leaves))
        del leaves, o
        # each design through its launchers; the path's twice
        plan = fv._varlen_plan(seg_q, seg_k, causal) \
            if design == "sm90" else None

        def run(des):
            p = plan if des == "sm90" else None
            od, ld = fv._varlen_fwd(q, k, v, seg_q, seg_k, scale, causal,
                                    des, p)
            return (od, *fv._varlen_bwd(q, k, v, od, ld, do, seg_q, seg_k,
                                        scale, causal, des, p)), ld
        runs = {des: run(des) for des in designs}
        again, _ = run(design)
        outs = {des: r[0] for des, r in runs.items()}
        o, lse = outs[design][0], runs[design][1]
        ro, rlse = fv.flash_attention_varlen_ref(q, k, v, seg_q, seg_k,
                                                 causal, scale)
        want = (ro, *fv.flash_attention_varlen_bwd_ref(
            q, k, v, o, lse, do, seg_q, seg_k, causal, scale))
        torch.cuda.synchronize()
        errs = {des: {n: fa.kernel_errors(a, r) for n, a, r in
                      zip(names, outs[des], want)} for des in designs}
        abs_err = {des: {n: (a.float() - r.float()).abs().max().item()
                         for n, a, r in zip(names, outs[des], want)}
                   for des in designs}
        lse_err = {des: (runs[des][1] - rlse).abs().max().item()
                   for des in designs}
        faults = {fault: {n: fa.kernel_errors(a, r)
                          for n, a, r in zip(names, fouts, want)}
                  for fault, fouts in _varlen_faults(
                      fv, q, k, v, do, seg_q, seg_k, scale, causal).items()}

        def passes(e):
            return e[0] <= lim["rel"] and e[1] <= lim["row"]
        pad_q, pad_k = seg_q < 0, seg_k < 0
        pads_zero = {des: not (out[0][pad_q].any() or out[1][pad_q].any()
                               or out[2][pad_k].any()
                               or out[3][pad_k].any())
                     for des, out in outs.items()}
        bitwise = all(torch.equal(a, c) for a, c in zip(outs[design],
                                                        again))
        wrapper_equal = all(torch.equal(a, c) for a, c in
                            zip(wrapper, outs[design]))
        times = None
        if timed:
            times = _varlen_timed(q, k, v, do, seg_q, seg_k, scale, causal,
                                  o, lse)
            plain_fwd = time_ms(lambda: fv.flash_attention_varlen_ref(
                q, k, v, seg_q, seg_k, causal, scale), iters=3, warmup=1)
            plain_bwd = time_ms(lambda: fv.flash_attention_varlen_bwd_ref(
                q, k, v, o, lse, do, seg_q, seg_k, causal, scale), iters=3,
                warmup=1)
        plan_rec = None if plan is None else _plan_record(
            fv, seg_q, seg_k, causal, label, times)
        ok = (all(passes(e) for de in errs.values() for e in de.values())
              and max(lse_err.values()) <= 1e-3 and all(pads_zero.values())
              and wrapper_equal and (plan_rec is None
                                     or plan_rec["plan_equal"]))
        ok = ok and (bitwise or design != "sm90")
        caught = not any(passes(e) for fe in faults.values()
                         for e in fe.values())
        pairs, work = _varlen_work(q, k, seg_q, seg_k, causal)
        del ro, rlse, want
        extra = dict(B=b, Sq=sq, Sk=sk, H=h, HK=hk, D=d, causal=causal,
                     packing=packing, segments=int(seg_q.max()) + 1,
                     padding_rows=int(pad_q.sum()), live_pairs=pairs,
                     limits=lim, planted_faults=faults,
                     bitwise_repeat=bitwise if design == "sm90" else None,
                     wrapper_equal=wrapper_equal)
        recs = _varlen_records(label, name, designs, design, errs, abs_err,
                               work, times, extra)
        for rec in recs:
            rec.update(lse_max_abs_err=lse_err[rec["design"]],
                       padding_zero=pads_zero[rec["design"]])
        if timed:
            lens = np.bincount(sq_np[0][sq_np[0] >= 0]).tolist() \
                if b == 1 and packing == "docs" else None
            _varlen_libraries(recs, q, k, v, do, seg_q, seg_k, sq_np,
                              causal, plain_fwd, plain_bwd, lens)
        if plan_rec is not None:
            recs.append(plan_rec)
        for rec in recs:
            log("kernel " + json.dumps(rec))
            results.append(rec)
        if not ok:
            raise AssertionError(f"varlen kernels disagree on {label}: "
                                 f"{errs}, lse {lse_err}, padding zero "
                                 f"{pads_zero}, bitwise {bitwise}, wrapper "
                                 f"equal {wrapper_equal}, plan {plan_rec}")
        if not caught:
            raise AssertionError(f"the flash limits {lim} miss a planted "
                                 f"varlen fault on {label}: {faults}")
        del q, k, v, do, o, lse, outs, runs, again, wrapper, plan
        torch.cuda.empty_cache()
    _rope_phase(results)


def packed_sft_8b():
    """`F.flash_attn_unpadded` at Llama-3-8B attention width (H 32, HK 8,
    D 128), bf16, causal, over `PACKED_SFT_TOKENS` packed tokens of
    seeded document lengths ending in a padding tail: one forward and
    backward through the varlen kernels (exactly 1/1/1 launches, no
    plain version), held to `KERNEL_LIMITS` against the plain versions on
    the same packed inputs (one KV-head group at a time) and against the
    same documents one at a time through the dense flash kernels;
    returns the run's launch counts."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_varlen as fv
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = LlamaConfig.llama3_8b()
    h, hk, d = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    t = PACKED_SFT_TOKENS
    rng = np.random.default_rng(61)
    lens = _doc_lengths(t - PACKED_SFT_TAIL, rng)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      dtype=torch.int32, device="cuda")
    n = sum(lens)
    gen = torch.Generator(device="cuda").manual_seed(62)
    f = lambda *shape: torch.randn(*shape, device="cuda",
                                   generator=gen).bfloat16()
    q, k, v, do = f(t, h, d), f(t, hk, d), f(t, hk, d), f(t, h, d)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out, _ = F.flash_attn_unpadded(*leaves, cu, cu, max(lens), max(lens),
                                   causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(launch_counts)
    want = {k_: 0 for k_ in counts}
    want.update(flash_varlen_fwd=1, flash_varlen_bwd_dq=1,
                flash_varlen_bwd_dkv=1, flash_varlen_plan=1)
    log(f"launches (packed_sft_8b) {counts} expected {want}")
    if counts != want:
        raise AssertionError("packed SFT launch counts do not match one "
                             "forward and backward")
    got = (out.detach(), *(x.grad for x in leaves))

    # the documents one at a time through the dense flash kernels
    refs = [[], [], [], []]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    for s0, ln in zip(starts, lens):
        sl = slice(int(s0), int(s0 + ln))
        part = [x[sl][None].clone().requires_grad_() for x in (q, k, v)]
        o_i = fa.flash_attention_values(*part, causal=True)
        o_i.backward(do[sl][None])
        for acc, x in zip(refs, (o_i.detach(), *(p.grad for p in part))):
            acc.append(x[0])
    want_t = [torch.cat(r) for r in refs]
    lim = fa.KERNEL_LIMITS[torch.bfloat16]
    names = ("o", "dq", "dk", "dv")
    errs = {name: fa.kernel_errors(a[:n], r)
            for name, a, r in zip(names, got, want_t)}
    tail_zero = all(not a[n:].any() for a in got)
    # the plain versions on the same packed inputs, tail included
    seg = fv.segments_from_cu_seqlens(cu, t)[None]
    plain, _, _ = _varlen_plain_by_group(q[None], k[None], v[None],
                                         do[None], seg, seg, True,
                                         d ** -0.5)
    plain_errs = {name: fa.kernel_errors(a, r[0])
                  for name, a, r in zip(names, got, plain)}
    plain_abs = {name: (a.float() - r[0].float()).abs().max().item()
                 for name, a, r in zip(names, got, plain)}
    del plain

    def fwd_bwd():
        ls = [x.detach().requires_grad_() for x in (q, k, v)]
        F.flash_attn_unpadded(*ls, cu, cu, max(lens), max(lens),
                              causal=True)[0].backward(do)

    def per_doc():
        for s0, ln in zip(starts, lens):
            sl = slice(int(s0), int(s0 + ln))
            ls = [x[sl][None].detach().requires_grad_() for x in (q, k, v)]
            fa.flash_attention_values(*ls, causal=True).backward(
                do[sl][None])
    stats = dict(tokens=t, documents=len(lens), padding_tail=t - n,
                 doc_len_min=min(lens), doc_len_max=max(lens), H=h, HK=hk,
                 D=d, first_call_wall_ms=1e3 * wall,
                 fwd_bwd_ms=time_ms(fwd_bwd, iters=5, warmup=1),
                 per_document_dense_kernels_fwd_bwd_ms=time_ms(
                     per_doc, iters=5, warmup=1),
                 rel_row_errors=errs, rel_row_errors_plain=plain_errs,
                 max_abs_err_plain=plain_abs, limits=lim,
                 tail_zero=tail_zero, launches=counts)
    log("packed_sft_8b " + json.dumps(stats))
    within = lambda es: all(e[0] <= lim["rel"] and e[1] <= lim["row"]
                            for e in es.values())
    if not (within(errs) and within(plain_errs)) or not tail_zero:
        raise AssertionError(f"packed SFT differs from the per-document "
                             f"dense kernels ({errs}) or the plain "
                             f"versions ({plain_errs}), tail zero "
                             f"{tail_zero}")
    del q, k, v, do, leaves, out, got, refs, want_t
    torch.cuda.empty_cache()
    return counts


def packed_pretrain_8b(results):
    """Document-masked pretraining attention at Llama-3-8B width: x (B,
    S, 4096) bf16 -> q/k/v `F.linear` -> `fused_rotary_position_embedding`
    (theta 500000) -> `incubate...flash_attention_varlen` under (B, S)
    segment ids of seeded document lengths -> o_proj, mean-square loss
    against a seeded target, 5 `AdamW` steps (the port's counterpart of
    the reference's packed trainer, tests/test_flash_varlen.py:163-207).
    Exact launches a step: 1/1/1 varlen, 1 rope in the forward (q and k
    in one) and 1 in the backward, nothing else. Then the varlen wrapper, forward and
    backward, on the last step's own q, k, v and dO, held to
    `KERNEL_LIMITS` against the plain versions (one KV-head group at a
    time), and the three kernels timed there (the ``pretrain_8b``
    records); returns the 5 steps' launch counts."""
    import torch
    from unittest import mock
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.models.llama import LlamaConfig, precompute_rope
    from paddle_tpu_torch.ops import flash_varlen as fv
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.ops import rope as rp
    from paddle_tpu_torch.optimizer import AdamW
    cfg = LlamaConfig.llama3_8b()
    e, h, hk, d = cfg.hidden_size, cfg.num_attention_heads, \
        cfg.num_key_value_heads, cfg.head_dim
    b, s = PACKED_PRETRAIN_SHAPE
    rng = np.random.default_rng(71)
    seg_np = np.stack([_packed_segments(_doc_lengths(s, rng), s)
                       for _ in range(b)])
    seg = torch.from_numpy(seg_np).cuda()
    cos, sin = (x.cuda() for x in precompute_rope(d, s,
                                                  PACKED_PRETRAIN_THETA))

    class PackedAttention(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator().manual_seed(72)
            lin = lambda o, i: torch.nn.Parameter(
                (0.02 * torch.randn(o, i, generator=gen)).to(
                    "cuda", torch.bfloat16))
            self.wq, self.wk = lin(h * d, e), lin(hk * d, e)
            self.wv, self.wo = lin(hk * d, e), lin(e, h * d)

        def forward(self, x):
            q = torch.nn.functional.linear(x, self.wq).reshape(b, s, h, d)
            k = torch.nn.functional.linear(x, self.wk).reshape(b, s, hk, d)
            v = torch.nn.functional.linear(x, self.wv).reshape(b, s, hk, d)
            q, k = IF.fused_rotary_position_embedding(q, k, cos, sin)
            o = IF.flash_attention_varlen(q, k, v, seg, seg, causal=True)
            # the step's attention inputs and cotangent, for the check
            # after the run
            self.seen = [t.detach() for t in (q, k, v)]
            if o.requires_grad:
                o.register_hook(lambda g: self.seen.append(g.detach()))
            return torch.nn.functional.linear(o.reshape(b, s, h * d),
                                              self.wo)

    model = PackedAttention()
    gen = torch.Generator(device="cuda").manual_seed(73)
    x = torch.randn(b, s, e, device="cuda", generator=gen).bfloat16()
    target = torch.randn(b, s, e, device="cuda", generator=gen).bfloat16()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times, fwd_counts = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = (model(x).float() - target.float()).square().mean()
        fwd_counts.append(launch_counts["rope"])
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(float(loss))          # waits for the step
        times.append(time.perf_counter() - t0)
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k_: 0 for k_ in counts}
    want.update(flash_varlen_fwd=TRAIN_STEPS, flash_varlen_bwd_dq=TRAIN_STEPS,
                flash_varlen_bwd_dkv=TRAIN_STEPS,
                flash_varlen_plan=TRAIN_STEPS, rope=2 * TRAIN_STEPS)
    rope_fwd = [c - 2 * i for i, c in enumerate(fwd_counts)]
    log(f"launches (packed_pretrain_8b) {counts} expected {want} over "
        f"{TRAIN_STEPS} steps; rope launches in each step's forward "
        f"{rope_fwd} (1 expected: q and k in one)")
    if counts != want or rope_fwd != [1] * TRAIN_STEPS:
        raise AssertionError("packed pretraining launch counts do not "
                             "match the steps")

    # one more step with CUDA events around every varlen, plan and rope
    # launch
    spans = {"varlen": [], "plan": [], "rope": []}

    def timed(key, fn):
        def run(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            spans[key].append((e0, e1))
            return out
        return run
    with mock.patch.object(fv, "_varlen_fwd", timed("varlen",
                                                    fv._varlen_fwd)), \
            mock.patch.object(fv, "_varlen_bwd_dq",
                              timed("varlen", fv._varlen_bwd_dq)), \
            mock.patch.object(fv, "_varlen_bwd_dkv",
                              timed("varlen", fv._varlen_bwd_dkv)), \
            mock.patch.object(fv, "_varlen_plan",
                              timed("plan", fv._varlen_plan)), \
            mock.patch.object(rp, "_launch", timed("rope", rp._launch)):
        loss = (model(x).float() - target.float()).square().mean()
        loss.backward()
        opt.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    span_ms = {k_: sum(a.elapsed_time(c) for a, c in v_)
               for k_, v_ in spans.items()}
    step_s = statistics.median(times[1:])
    stats = dict(batch=b, seq=s, hidden=e, H=h, HK=hk, D=d,
                 documents_per_row=[int(r.max()) + 1 for r in seg_np],
                 losses=losses, step_ms=1e3 * step_s,
                 first_step_ms=1e3 * times[0],
                 tokens_per_s=b * s / step_s, peak_mem_gib=peak,
                 varlen_design=fv.varlen_design(torch.bfloat16, d),
                 varlen_ms_per_step=span_ms["varlen"],
                 varlen_launches_timed=len(spans["varlen"]),
                 plan_ms_per_step=span_ms["plan"],
                 plan_launches_timed=len(spans["plan"]),
                 rope_ms_per_step=span_ms["rope"],
                 rope_launches_timed=len(spans["rope"]),
                 launches_per_step={k_: v_ // TRAIN_STEPS
                                    for k_, v_ in counts.items() if v_})
    log("packed_pretrain_8b " + json.dumps(stats))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"packed pretraining loss did not fall: "
                             f"{losses}")
    q, k, v, do = model.seen
    del model, opt, x, target, loss
    torch.cuda.empty_cache()
    _pretrain_varlen_check(q, k, v, do, seg, seg_np, results)
    return counts


def _pretrain_varlen_check(q, k, v, do, seg, seg_np, results):
    """The varlen wrapper on the pretraining step's own (q, k, v, dO),
    and the mma.sync design through its launchers: forward and backward
    against the plain versions one KV-head group at a time, within
    `KERNEL_LIMITS`; the plan kernel against `varlen_tile_plan`; every
    kernel of both designs timed on those inputs in turns
    (`_varlen_timed`), beside the plain versions (the group pieces'
    device time summed), the one-call library, masked SDPA; the
    ``pretrain_8b`` kernel records."""
    import torch
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_varlen as fv
    d = q.shape[3]
    scale = d ** -0.5
    lim = fa.KERNEL_LIMITS[torch.bfloat16]
    design = fv.varlen_design(q.dtype, d)
    designs = [design] + (["mma.sync"] if design == "sm90" else [])
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = IF.flash_attention_varlen(*leaves, seg, seg, causal=True)
    o.backward(do)
    got = {design: (o.detach(), *(t.grad for t in leaves))}
    del leaves, o
    for des in designs[1:]:
        od, ld = fv._varlen_fwd(q, k, v, seg, seg, scale, True, des)
        got[des] = (od, *fv._varlen_bwd(q, k, v, od, ld, do, seg, seg,
                                        scale, True, des))
    want, plain_fwd, plain_bwd = _varlen_plain_by_group(
        q, k, v, do, seg, seg, True, scale)
    names = ("o", "dq", "dk", "dv")
    errs = {des: {n: fa.kernel_errors(a, r) for n, a, r in
                  zip(names, got[des], want)} for des in designs}
    abs_err = {des: {n: (a.float() - r.float()).abs().max().item()
                     for n, a, r in zip(names, got[des], want)}
               for des in designs}
    del got, want
    torch.cuda.empty_cache()
    o, lse = fv._varlen_fwd(q, k, v, seg, seg, scale, True)
    times = _varlen_timed(q, k, v, do, seg, seg, scale, True, o, lse)
    pairs, work = _varlen_work(q, k, seg, seg, True)
    b, s, h, _ = q.shape
    recs = _varlen_records(
        "pretrain_8b", "bfloat16", designs, design, errs, abs_err, work,
        times, dict(B=b, Sq=s, Sk=s, H=h, HK=k.shape[2], D=d, causal=True,
                    live_pairs=pairs, limits=lim,
                    plain_note="the plain versions one batch row and one "
                    "KV-head group at a time, device time summed"))
    _varlen_libraries(recs, q, k, v, do, seg, seg, seg_np, True, plain_fwd,
                      plain_bwd)
    plan_rec = _plan_record(fv, seg, seg, True, "pretrain_8b", times)
    for rec in recs + [plan_rec]:
        log("kernel " + json.dumps(rec))
        results.append(rec)
    del o, lse
    torch.cuda.empty_cache()
    if not all(e[0] <= lim["rel"] and e[1] <= lim["row"]
               for de in errs.values() for e in de.values()):
        raise AssertionError(f"the varlen kernels on the pretraining "
                             f"step's inputs differ from the plain "
                             f"versions: {errs}")
    if not plan_rec["plan_equal"]:
        raise AssertionError(f"the plan kernel differs from "
                             f"varlen_tile_plan: {plan_rec}")


# ---------------------------------------------------------------------------
# the single-card model families: GPT-2, ERNIE-base and DiT-XL/2
# ---------------------------------------------------------------------------
GPT2_SHAPE = (8, 1024)
# `generate()` on GPT-2: prompts, prompt length, new tokens, beams (B 1)
GPT2_GEN = (4, 512, 64, 4)
ERNIE_SHAPE = (8, 512)
# ERNIE-base trains in f32: kernels against plain versions differ by f32
# sums in another order (tiny BERT, f32, card against CPU: 3e-6 after
# three steps), so its gradients are held to 1e-3 relative
ERNIE_GRAD_REL_BUDGET = 1e-3
DIT_BATCH = 32
# the DDIM run: steps, batch; and the recipe's own sample (10 steps)
DDIM_SHAPE = (50, 8)
DIT_RECIPE_STEPS = 3
# adaLN-Zero starts every gate at 0 (DiT's output is exactly 0 and
# attention contributes nothing): every DiT check first sets `ada` and
# `final_layer` to seeded Normal(0, DIT_GATE_STD) values
DIT_GATE_STD = 0.02
# the planted fault of the DiT check: the plain path's attention without
# its 1/sqrt(D) scale (a 1.25x scale moved its gradients 0.014-0.033,
# too close to the budget to show it)


def _open_gates(model, seed=1):
    """``model`` (a DiT) with every ``ada`` and ``final_layer`` weight and
    bias set to seeded Normal(0, `DIT_GATE_STD`) values."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if ".ada." in n or n.startswith("final_layer."):
                p.copy_(DIT_GATE_STD * torch.randn(p.shape, generator=gen))
    return model


def _scale_left_out():
    """The DiT planted fault: flash attention (the plain path too)
    without its 1/sqrt(D) scale."""
    from unittest import mock
    from paddle_tpu_torch.ops import flash_attention as fa
    apply = fa._FlashAttentionFn.apply
    return mock.patch.object(
        fa._FlashAttentionFn, "apply",
        lambda q, k, v, scale, *a: apply(q, k, v, 1.0, *a))


def _ln_mean_left_out():
    """A planted fault of the plain LayerNorm: the mean left out."""
    import torch
    from unittest import mock
    from paddle_tpu_torch.ops import norm_kernels as nk

    def faulty(x, w, b, eps=1e-5):
        xf = x.float()
        r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (xf * r * w.float() + b.float()).to(x.dtype)
    return mock.patch.object(nk, "layer_norm_ref", faulty)


def model_path_check(label, model, loss_of, named, fault, budget,
                     before=None):
    """One forward and backward of ``loss_of(use_kernel)`` on ``model``
    through the kernels and through the plain versions (``before()``
    first, each run: a reseeded dropout stream): the loss within
    `TRAIN_LOSS_REL_BUDGET` and each ``named`` gradient within ``budget``
    of the plain run's (relative norms); the plain run under ``fault``
    must break the gradient budget. Returns the readings."""
    import torch
    params = dict(model.named_parameters())

    def run(use_kernel):
        if before:
            before()
        loss = loss_of(use_kernel)
        loss.backward()
        out = (float(loss.detach()),
               {n: params[n].grad.float().clone() for n in named})
        for p in model.parameters():
            p.grad = None
        del loss
        torch.cuda.empty_cache()
        return out
    lp, gp = run(False)
    lk, gk = run(True)
    with fault:
        lf, gf = run(False)

    def rel(g):
        return {n: ((g[n] - gp[n]).norm() / gp[n].norm()).item()
                for n in named}
    rec = dict(loss_kernels=lk, loss_plain=lp,
               loss_rel_diff=abs(lk - lp) / abs(lp), grad_rel_diff=rel(gk),
               grad_budget=budget, planted_fault_loss_rel_diff=abs(lf - lp)
               / abs(lp), planted_fault_grad_rel_diff=rel(gf))
    log(f"{label} path check " + json.dumps(rec))
    if not (np.isfinite(lk) and rec["loss_rel_diff"] <= TRAIN_LOSS_REL_BUDGET
            and max(rec["grad_rel_diff"].values()) <= budget):
        raise AssertionError(f"{label}: kernels and plain versions "
                             f"disagree")
    if max(rec["planted_fault_grad_rel_diff"].values()) <= budget:
        raise AssertionError(f"{label}: the gradient budget misses the "
                             f"planted fault")
    return rec


def timed_train_steps(step, batch, want_per_step, label):
    """`TRAIN_STEPS` steps of ``step(*batch)``, the launch counts set to 0
    just before and held to ``want_per_step`` x the steps after: (losses,
    host seconds a step, the counts, peak GiB)."""
    import torch
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(float(step(*batch)))     # waits for the step
        times.append(time.perf_counter() - t0)
    counts = dict(launch_counts)
    want = {**{k: 0 for k in counts},
            **{k: v * TRAIN_STEPS for k, v in want_per_step.items()}}
    log(f"{label} launches {counts} expected {want}")
    if counts != want:
        raise AssertionError(f"{label}: launch counts do not match the "
                             f"steps")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    return losses, times, counts, torch.cuda.max_memory_allocated() / 2 ** 30


def tiny_gpt_parity():
    """The tiny f32 GPT (LayerNorm kernels, causal flash), card against
    CPU."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    cfg = GPTConfig.tiny()
    ids = np.random.default_rng(21).integers(0, cfg.vocab_size, (2, 65))
    L = cfg.num_hidden_layers
    n_ln = (2 * L + 1) * TINY_MOE_STEPS
    _card_vs_cpu("tiny gpt train parity",
                 lambda: GPTForCausalLM(cfg, device="cpu", seed=6),
                 (ids[:, :-1], ids[:, 1:]),
                 {"layer_norm": n_ln, "layer_norm_bwd": n_ln,
                  "flash_attention_fwd": L * TINY_MOE_STEPS,
                  "flash_attention_bwd_dq": L * TINY_MOE_STEPS})


def tiny_ernie_parity():
    """The tiny f32 ERNIE at dropout 0 (flash attention), MLM + SOP loss
    with token types, card against CPU."""
    from paddle_tpu_torch.models.ernie import (ErnieConfig,
                                               ErnieForPretraining,
                                               synthetic_ernie_batch)
    cfg = ErnieConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    ids, lbl, sop = synthetic_ernie_batch(2, 64, cfg.vocab_size, seed=22)
    tt = np.random.default_rng(22).integers(0, 4, (2, 64))
    L = cfg.num_hidden_layers
    n_ln = (2 * L + 2) * TINY_MOE_STEPS
    _card_vs_cpu("tiny ernie train parity (dropout 0)",
                 lambda: ErnieForPretraining(cfg, device="cpu", seed=7),
                 (ids, lbl, sop, tt),
                 {"layer_norm": n_ln, "layer_norm_bwd": n_ln,
                  "flash_attention_fwd": L * TINY_MOE_STEPS},
                 loss_fn=lambda m, a, b, c, d: m(
                     a, token_type_ids=d, labels=b, sop_labels=c)[0])


def tiny_dit_parity():
    """The tiny f32 DiT with its gates open (`_open_gates`; LayerNorms
    without an affine, non-causal flash), `training_loss` with a fixed
    noise, card against CPU."""
    import torch
    from paddle_tpu_torch.models.dit import (DiT, DiTConfig,
                                             GaussianDiffusion,
                                             synthetic_dit_batch)
    cfg = DiTConfig.tiny()
    x, t, y = synthetic_dit_batch(2, cfg, seed=23)
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(23))
    L = cfg.num_hidden_layers
    n_ln = (2 * L + 1) * TINY_MOE_STEPS
    diffusion = GaussianDiffusion()
    _card_vs_cpu("tiny dit train parity (gates open)",
                 lambda: _open_gates(DiT(cfg, device="cpu", seed=8)),
                 (x, t, y, noise),
                 {"layer_norm": n_ln, "layer_norm_bwd": n_ln,
                  "flash_attention_fwd": L * TINY_MOE_STEPS,
                  "flash_attention_bwd_dkv": L * TINY_MOE_STEPS},
                 loss_fn=lambda m, a, b, c, d: diffusion.training_loss(
                     m, a, b, c, noise=d))


def generate_gpt2(model):
    """`GPTForCausalLM.generate()` on GPT-2, bf16: `GPT2_GEN`'s prompts,
    greedy twice (equal) and beam search at B 1; the prefill's logits
    through the kernels against the plain versions, and against the
    uncached forward's last row (within the same 0.1 x max |logit|, the
    picks equal up to a near tie); exact launches each run (flash forward
    L in the prefill; LayerNorm 2L + 1 a forward)."""
    import torch
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = model.config
    L = cfg.num_hidden_layers
    b, prompt, new, beams = GPT2_GEN
    ids = torch.from_numpy(np.random.default_rng(24).integers(
        0, cfg.vocab_size, (b, prompt)).astype(np.int32)).cuda()
    diff, scale = gen_prefill_check(
        model, ids, prompt + new,
        {"flash_attention_fwd": L, "layer_norm": 2 * L + 1}, near_ties=True)
    # the cached prefill (the caches' prefix, made contiguous) against the
    # uncached forward over the prompts, both through the kernels
    with torch.no_grad():
        cached = model._zero_caches_prefill(ids, prompt + new)[0].float()
        uncached = model(ids)[:, -1].float()
    u_diff = (cached - uncached).abs().max().item()
    u_picks = uncached.gather(1, cached.argmax(-1, keepdim=True))[:, 0]
    u_agree = (u_picks >= uncached.amax(-1) - u_diff).tolist()
    del cached, uncached
    want = {"flash_attention_fwd": L, "layer_norm": (2 * L + 1) * new}
    beam = dict(decode_strategy="beam_search", num_beams=beams)
    model.generate(ids, max_new_tokens=new)            # warm-up
    runs, walls, outs = {}, {}, []
    for name, x, kw in (("greedy", ids, {}), ("greedy_again", ids, {}),
                        ("beam", ids[:1], beam)):
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        toks, scores = model.generate(x, max_new_tokens=new, **kw)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        runs[name] = dict(launch_counts)
        outs.append((toks, scores))
    (g, gs), (g2, _), (bt, bs) = outs
    rec = dict(batch=b, prompt_len=prompt, new_tokens=new, beams=beams,
               prefill_max_abs_logit_diff=diff, prefill_max_abs_logit=scale,
               prefill_against_uncached_max_abs_diff=u_diff,
               prefill_against_uncached_picks_agree=u_agree,
               greedy_wall_s=walls["greedy"],
               greedy_tokens_per_s=b * new / walls["greedy"],
               decode_ms_per_token_step=1e3 * walls["greedy"] / new,
               beam_wall_s=walls["beam"], beam_score=bs.item(),
               greedy_runs_equal=bool(torch.equal(g, g2)),
               launches={k: {n: c for n, c in v.items() if c}
                         for k, v in runs.items()})
    log("generate_gpt2 " + json.dumps(rec))
    for name, got in runs.items():
        if got != {**{k: 0 for k in got}, **want}:
            raise AssertionError(f"generate_gpt2 {name}: launches {got}, "
                                 f"expected {want}")
    if u_diff > 0.1 * scale or not all(u_agree):
        raise AssertionError("generate_gpt2: the cached prefill and the "
                             "uncached forward disagree")
    if not torch.equal(g, g2) or g.shape != (b, new) \
            or bt.shape != (1, new) or not torch.isfinite(gs).all() \
            or not np.isfinite(bs.item()) or int(g.min()) < 0 \
            or int(g.max()) >= cfg.vocab_size:
        raise AssertionError("generate_gpt2: outputs malformed")


def train_gpt2():
    """GPT-2 (124M) at full width and depth, bf16 with AdamW master
    weights, B 8 x S 1024: the path check (planted fault: `_skip_tile`),
    `TRAIN_STEPS` steps with exact launches (flash L each kernel,
    LayerNorm 2L + 1 forward and backward a step), step ms, tokens/s and
    MFU; then `generate_gpt2`. Returns the steps' launch counts."""
    import torch
    from unittest import mock
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                             synthetic_lm_batch)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    t_phase = time.perf_counter()
    cfg = GPTConfig.gpt2()
    L = cfg.num_hidden_layers
    b, s = GPT2_SHAPE
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    x, y = (t.cuda() for t in synthetic_lm_batch(b, s, cfg.vocab_size,
                                                 seed=0))
    check = model_path_check(
        "train_gpt2", model,
        lambda uk: model(x, labels=y, use_kernel=uk)[0],
        ("transformer.wte.weight", "transformer.wpe.weight",
         "transformer.h.0.ln_1.weight", "transformer.h.0.attn.qkv.weight",
         "transformer.h.11.attn.proj.weight", "transformer.h.11.fc.weight",
         "transformer.ln_f.weight"),
        mock.patch.object(fa, "_live", _skip_tile(fa._live)),
        TRAIN_GRAD_REL_BUDGET)
    opt = AdamW(learning_rate=3e-4, parameters=model.parameters(),
                weight_decay=0.01, multi_precision=True)
    step = TrainStep(model, opt, loss_fn=_lm_loss)
    losses, times, counts, peak = timed_train_steps(
        step, (x, y), {"flash_attention_fwd": L, "flash_attention_bwd_dq": L,
                       "flash_attention_bwd_dkv": L,
                       "layer_norm": 2 * L + 1,
                       "layer_norm_bwd": 2 * L + 1}, "train_gpt2")
    step_s = statistics.median(times[1:])
    mfu = _mfu(cfg, b * s, s, step_s)
    del step, opt
    torch.cuda.empty_cache()
    model.eval()
    generate_gpt2(model)
    stats = dict(params=cfg.num_params(), batch=b, seq=s, dtype="bfloat16",
                 losses=losses, step_ms=1e3 * step_s,
                 first_step_ms=1e3 * times[0], tokens_per_s=b * s / step_s,
                 mfu=mfu[0], mfu_without_embedding=mfu[1],
                 peak_mem_gib=peak,
                 flash_design=fa.sm90_design(torch.bfloat16, cfg.head_dim),
                 launches_per_step={k: v // TRAIN_STEPS
                                    for k, v in counts.items() if v},
                 path_check=check,
                 phase_s=time.perf_counter() - t_phase)
    log("train_gpt2 " + json.dumps(stats))
    del model
    torch.cuda.empty_cache()
    return counts


def train_ernie_base():
    """ERNIE-base through the port's `recipes.ernie_4d` at B 8 x S 512,
    f32, with its configured dropout (attention dropout 0.1 sends
    attention to the plain path, as in JAX: no flash launch): exact
    LayerNorm launches (26 forward and backward a step), the path check
    on a second model (dropout stream reseeded each run; planted fault:
    the plain LayerNorm without its mean) and one
    `ErnieForSequenceClassification` loss at base width. Returns the
    recipe's launch counts."""
    import torch
    from paddle_tpu_torch.models.ernie import (
        ErnieConfig, ErnieForPretraining, ErnieForSequenceClassification,
        synthetic_ernie_batch)
    from paddle_tpu_torch.nn.layers import set_generator
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.recipes import ernie_4d
    t_phase = time.perf_counter()
    cfg = ErnieConfig.base()
    L = cfg.num_hidden_layers
    b, s = ERNIE_SHAPE
    n_ln = 2 * L + 2
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    r = ernie_4d.main(["--size", "base", "--batch-size", str(b),
                       "--seq-len", str(s), "--steps", str(TRAIN_STEPS),
                       "--log-every", "1"])
    counts = dict(launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {**{k: 0 for k in counts}, "layer_norm": n_ln * TRAIN_STEPS,
            "layer_norm_bwd": n_ln * TRAIN_STEPS}
    log(f"train_ernie_base launches {counts} expected {want}")
    if counts != want or not np.isfinite(r.final_loss):
        raise AssertionError("train_ernie_base: launches off or the loss "
                             "is not finite")
    step_s = statistics.median(r.step_seconds[1:])
    ids, lbl, sop = (t.cuda() for t in synthetic_ernie_batch(
        b, s, cfg.vocab_size, seed=25))

    def reseed(m):
        return lambda: set_generator(m, torch.Generator("cuda")
                                     .manual_seed(3))
    model = ErnieForPretraining(cfg, device="cuda", seed=1)
    check = model_path_check(
        "train_ernie_base", model,
        lambda uk: model(ids, labels=lbl, sop_labels=sop, use_kernel=uk)[0],
        ("ernie.embeddings.word_embeddings.weight",
         "ernie.embeddings.layer_norm.weight",
         "ernie.encoder.layers.0.self_attn.q_proj.weight",
         "ernie.encoder.layers.11.norm2.weight",
         "ernie.encoder.layers.11.linear2.weight", "layer_norm.weight",
         "decoder_bias", "seq_relationship.weight"),
        _ln_mean_left_out(), ERNIE_GRAD_REL_BUDGET, reseed(model))
    del model
    torch.cuda.empty_cache()
    cls = ErnieForSequenceClassification(cfg, num_classes=3, device="cuda",
                                         seed=2)
    cls_check = model_path_check(
        "ernie_base_classification", cls,
        lambda uk: cls(ids, labels=sop, use_kernel=uk)[0],
        ("ernie.embeddings.layer_norm.weight",
         "ernie.encoder.layers.5.self_attn.v_proj.weight",
         "ernie.pooler.weight", "classifier.weight"),
        _ln_mean_left_out(), ERNIE_GRAD_REL_BUDGET, reseed(cls))
    reset_launch_counts()
    loss = cls(ids, labels=sop)[0]
    loss.backward()
    cls_counts = {k: v for k, v in launch_counts.items() if v}
    del cls, loss
    torch.cuda.empty_cache()
    stats = dict(size="base", batch=b, seq=s, dtype="float32",
                 dropout=[cfg.hidden_dropout_prob,
                          cfg.attention_probs_dropout_prob],
                 losses=r.losses, step_ms=1e3 * step_s,
                 first_step_ms=1e3 * r.step_seconds[0],
                 tokens_per_s=b * s / step_s, peak_mem_gib=peak,
                 launches_per_step={k: v // TRAIN_STEPS
                                    for k, v in counts.items() if v},
                 path_check=check, classification_path_check=cls_check,
                 classification_launches=cls_counts,
                 phase_s=time.perf_counter() - t_phase)
    log("train_ernie_base " + json.dumps(stats))
    if cls_counts != {"layer_norm": 2 * L + 1, "layer_norm_bwd": 2 * L + 1}:
        raise AssertionError(f"ERNIE classification launches {cls_counts}")
    return counts


def ddim_run(diffusion, model, y, seed):
    """(the DDIM sample, its wall seconds, its launches)."""
    import torch
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    steps, b = DDIM_SHAPE
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    img = diffusion.ddim_sample(model, b, y, num_steps=steps, seed=seed)
    torch.cuda.synchronize()
    return img, time.perf_counter() - t0, dict(launch_counts)


def _dit_flops(cfg, images):
    """6 N per token plus the attention term 12 L h S per token (the
    bench.py formula over the `num_patches` tokens of each image); N
    leaves out the label table, a lookup."""
    s = cfg.num_patches
    n = cfg.num_params() - (cfg.num_classes + 1) * cfg.hidden_size
    return images * s * (6.0 * n + 12 * cfg.num_hidden_layers
                         * cfg.hidden_size * s)


def train_dit_xl2():
    """DiT-XL/2 (28 layers, width 1152, 16 heads of 72) at full width and
    depth, bf16 with AdamW master weights, B 32 (256 patch tokens each),
    its gates open (`_open_gates`): the path check (planted fault: the
    attention's scale left out), `TRAIN_STEPS` steps with exact
    launches (flash L each kernel, LayerNorm 2L + 1 forward and backward
    a step), step ms, images/s and MFU; then `ddim_sample` at
    `DDIM_SHAPE`, eta 0, twice with one seed (bitwise equal), flash L and
    LayerNorm 2L + 1 a step. The timed steps start from the published
    adaLN-Zero init (the gates closed again: with them open at random,
    AdamW's first step at 3e-4 drove the loss from 1.59 to 17.6) and
    train on the check's noise. Returns the steps' launch counts."""
    import torch
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.dit import (DiT, DiTConfig,
                                             GaussianDiffusion,
                                             synthetic_dit_batch)
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.optimizer import AdamW
    t_phase = time.perf_counter()
    cfg = DiTConfig.xl_2()
    L = cfg.num_hidden_layers
    model = _open_gates(DiT(cfg, device="cuda", dtype=torch.bfloat16,
                            seed=0))
    diffusion = GaussianDiffusion(seed=0)
    x, t, y = (a.cuda() for a in synthetic_dit_batch(DIT_BATCH, cfg,
                                                      seed=0))
    noise = torch.randn(x.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(26))
    check = model_path_check(
        "train_dit_xl2", model,
        lambda uk: diffusion.training_loss(model, x, t, y, noise=noise,
                                           use_kernel=uk),
        ("x_embedder.weight", "t_embedder.mlp.0.weight",
         "blocks.0.qkv.weight", "blocks.0.ada.weight", "blocks.13.fc1.weight",
         "blocks.27.proj.weight", "final_layer.ada.weight",
         "final_layer.linear.weight"),
        _scale_left_out(), TRAIN_GRAD_REL_BUDGET)
    # the steps: from adaLN-Zero, on a fixed objective (the check's noise)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if ".ada." in n or n.startswith("final_layer."):
                p.zero_()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.0, multi_precision=True)
    step = TrainStep(model, opt, loss_fn=lambda m, a, b, c, n:
                     diffusion.training_loss(m, a, b, c, noise=n))
    losses, times, counts, peak = timed_train_steps(
        step, (x, t, y, noise), {"flash_attention_fwd": L,
                          "flash_attention_bwd_dq": L,
                          "flash_attention_bwd_dkv": L,
                          "layer_norm": 2 * L + 1,
                          "layer_norm_bwd": 2 * L + 1}, "train_dit_xl2")
    step_s = statistics.median(times[1:])
    del step, opt
    torch.cuda.empty_cache()
    # DDIM: a warm-up of one step, then two runs with one seed
    steps, b = DDIM_SHAPE
    yy = torch.arange(b, dtype=torch.int32) * 97 % cfg.num_classes
    diffusion.ddim_sample(model, b, yy, num_steps=1, seed=1)
    runs = [ddim_run(diffusion, model, yy, seed=5)
            for _ in range(2)]
    (img, wall, dcounts), (img2, wall2, dcounts2) = runs
    ddim_want = {**{k: 0 for k in dcounts},
                 "flash_attention_fwd": L * steps,
                 "layer_norm": (2 * L + 1) * steps}
    stats = dict(params=cfg.num_params(), batch=DIT_BATCH,
                 tokens_per_image=cfg.num_patches, head_dim=cfg.hidden_size
                 // cfg.num_attention_heads, dtype="bfloat16",
                 losses=losses, step_ms=1e3 * step_s,
                 first_step_ms=1e3 * times[0],
                 images_per_s=DIT_BATCH / step_s,
                 mfu=_dit_flops(cfg, DIT_BATCH) / step_s / PEAK_BF16,
                 peak_mem_gib=peak,
                 flash_design=fa.sm90_design(torch.bfloat16, 72),
                 launches_per_step={k: v // TRAIN_STEPS
                                    for k, v in counts.items() if v},
                 path_check=check,
                 ddim=dict(steps=steps, batch=b, eta=0.0, wall_s=[wall, wall2],
                           ms_per_step=1e3 * min(wall, wall2) / steps,
                           launches={k: v for k, v in dcounts.items() if v},
                           bitwise_equal=bool(torch.equal(img, img2)),
                           finite=bool(torch.isfinite(img).all()),
                           max_abs=img.abs().max().item()),
                 phase_s=time.perf_counter() - t_phase)
    log("train_dit_xl2 " + json.dumps(stats))
    if dcounts != ddim_want or dcounts2 != ddim_want:
        raise AssertionError(f"DDIM launches {dcounts}, expected "
                             f"{ddim_want}")
    if not (stats["ddim"]["bitwise_equal"] and stats["ddim"]["finite"]) \
            or img.shape != (b, cfg.in_channels, cfg.input_size,
                             cfg.input_size):
        raise AssertionError("DDIM: two runs of one seed differ, or the "
                             "sample is malformed")
    del model, img, img2
    torch.cuda.empty_cache()
    return counts


def dit_recipe():
    """The port's `recipes.dit_train` at ``--size s`` (head dim 64, f32),
    `DIT_RECIPE_STEPS` steps and its 10-step DDIM sample: exact launches
    (flash forward L a training step and a sampling step, backward L a
    training step; LayerNorm 2L + 1 likewise) and a finite sample."""
    import torch
    from paddle_tpu_torch.ops import launch_counts, reset_launch_counts
    from paddle_tpu_torch.recipes import dit_train
    t0 = time.perf_counter()
    L = dit_train.s_config().num_hidden_layers
    reset_launch_counts()
    r = dit_train.main(["--size", "s", "--steps", str(DIT_RECIPE_STEPS),
                        "--sample-after", "--log-every", "1"])
    counts = {k: v for k, v in launch_counts.items() if v}
    n, k = DIT_RECIPE_STEPS, 10
    want = {"flash_attention_fwd": L * (n + k),
            "flash_attention_bwd_dq": L * n, "flash_attention_bwd_dkv": L * n,
            "layer_norm": (2 * L + 1) * (n + k),
            "layer_norm_bwd": (2 * L + 1) * n}
    rec = dict(losses=r.losses, step_ms=[1e3 * t for t in r.step_seconds],
               sample_shape=list(r.sample.shape),
               sample_finite=bool(torch.isfinite(r.sample).all()),
               launches=counts, seconds=time.perf_counter() - t0)
    log("dit_recipe " + json.dumps(rec))
    if counts != want or not rec["sample_finite"] \
            or rec["sample_shape"] != [2, 4, 32, 32] \
            or not np.isfinite(r.final_loss):
        raise AssertionError(f"dit_recipe: launches {counts}, expected "
                             f"{want}, or the sample is malformed")


# the kernels of the single-card families' training paths
FAMILY_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv", "layer_norm", "layer_norm_bwd")


def single_card_families():
    """The GPT, ERNIE and DiT phases, each model freed before the next;
    returns {phase: the launch counts of its training steps}."""
    t0 = time.perf_counter()
    tiny_gpt_parity()
    tiny_ernie_parity()
    tiny_dit_parity()
    out = dict(train_gpt2=train_gpt2(), train_ernie_base=train_ernie_base(),
               train_dit_xl2=train_dit_xl2())
    dit_recipe()
    log(f"single-card families {time.perf_counter() - t0:.1f}s")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only "
              "on an NVIDIA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        print("chip_smoke: the paddle_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from paddle_tpu_torch.ops import _build
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    results = []
    from paddle_tpu_torch.ops.ragged_paged_attention import \
        pack_ragged_batch
    # the first admission batch of the serving phase: its 8 prompts
    first = [{"seq": s, "tokens": p, "offset": 0}
             for s, (p, _) in enumerate(make_requests(LLAMA_VOCAB)[:8])]
    packed = pack_ragged_batch(first, 8, block_q=8, pad_to=16)
    t_adm = packed["t_pad"]
    # the first admission batch's sequences under the LoRA run's rows:
    # sequence s under row s % 4 (0: the base), padding rows none
    seq = np.asarray(packed["token_seq"])
    seg_ids = torch.from_numpy(np.where(seq >= 0, seq % 4, 0)
                               .astype(np.int32))
    rms_phase(rms_shapes(t_adm), results)
    attn_phase(results)
    dq_phase(t_adm, results)
    attn_phase(results, int8kv=True)
    lora_phase(t_adm, results, seg_ids)
    paged_phase(results)
    flash_phase(results)
    rms_bwd_phase(results)
    tiny_parity()
    tiny_quant_parity()
    tiny_lora_parity()
    tiny_legacy_parity()
    tiny_train_parity()
    tcounts = train_8b_width()
    train_8b_resume()
    rcounts = train_8b_recompute(train_recipe())
    ln_phase(results)
    tiny_moe_train_parity()
    tiny_bert_train_parity()
    mcounts, routed = train_moe_a14b_width()
    gmm_phase(results, routed)
    bcounts = train_bert_base()
    train_moe_small()
    varlen_phase(results)
    packed_sft_8b()
    pcounts = packed_pretrain_8b(results)
    fcounts = single_card_families()
    model, counts, reqs, streams, stats = serve_8b()
    path_check(model, reqs)
    serve_8b_pipelined(model, reqs, streams, stats)
    serve_8b_graphs(model, reqs, streams)
    prefix_streams = serve_8b_prefix(model)
    qcounts, qweights, qstreams = serve_8b_quant(model, reqs, "int8",
                                                 N_REQUESTS)
    path_check(model, reqs, qweights)
    del qweights
    serve_8b_quant(model, reqs, "fp8", N_FP8_REQUESTS)
    lcounts, lora_eng = serve_8b_lora(model, reqs)
    path_check(model, reqs, lora_engine=lora_eng)
    del lora_eng
    gcounts, lstreams = serve_8b_legacy(model, reqs)
    # generate(), the dense layout, the legacy prefix cache and the legacy
    # chunked prefill, each with its launches counted
    t0 = time.perf_counter()
    generate_8b(model)
    serve_8b_dense(model, reqs)
    serve_8b_legacy_prefix(model)
    serve_8b_legacy_chunked(model, reqs)
    log(f"generate, dense and legacy phases {time.perf_counter() - t0:.1f}s")
    # speculative decoding and engine sampling
    t0 = time.perf_counter()
    spec_attn_phase(results)
    draft, gaps = serve_8b_spec(model, reqs, streams)
    generate_8b_spec(model, draft)
    serve_8b_sample(model, reqs, streams, gaps)
    log(f"spec and sampling phases {time.perf_counter() - t0:.1f}s")
    # telemetry, fault points and the decode-round attribution
    t0 = time.perf_counter()
    serve_8b_telemetry(model, reqs, streams, draft, lstreams)
    del draft
    log(f"telemetry phase {time.perf_counter() - t0:.1f}s")
    # KV page transfer: migrations, their drills, int8 KV, the spill tier
    serve_8b_migrate(model, reqs, streams, gaps, qstreams, prefix_streams)
    # each kernel's launches on its own main path: the full-width run
    # for RMSNorm and full-width attention, the int8 run for int8-KV
    # attention and the dequant matmul, the LoRA run for the epilogue,
    # the legacy run for paged attention
    counts.update((k, qcounts[k]) for k in (
        "ragged_paged_attention_int8kv", "dequant_matmul"))
    counts["lora_epilogue"] = lcounts["lora_epilogue"]
    counts["paged_attention"] = gcounts["paged_attention"]

    counts.update((k, tcounts[k]) for k in NO_TRAINING)
    counts["grouped_matmul"] = mcounts["grouped_matmul"]
    counts["layer_norm"] = bcounts["layer_norm"]
    counts["layer_norm_bwd"] = bcounts["layer_norm_bwd"]
    # the LayerNorm pair and the flash triplet also run on the
    # single-card families' training paths: their launches are added
    by_path = {k: {"train_8b_width": tcounts[k]} for k in FAMILY_KERNELS}
    # the recompute run of 5h drives the flash triplet and the RMSNorm
    # pair on its own path
    for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        by_path[k]["train_8b_recompute"] = rcounts[k]
    by_path["rms_norm"] = {"serve_8b": counts["rms_norm"]}
    by_path["rms_norm_bwd"] = {"train_8b_width": counts["rms_norm_bwd"]}
    for k in ("rms_norm", "rms_norm_bwd"):
        by_path[k]["train_8b_recompute"] = rcounts[k]
        counts[k] = sum(by_path[k].values())
    for k in ("layer_norm", "layer_norm_bwd"):
        by_path[k] = {"train_bert_base": bcounts[k]}
    for k in FAMILY_KERNELS:
        for path, c in fcounts.items():
            by_path[k][path] = c[k]
        counts[k] = sum(by_path[k].values())
    # the varlen kernels and rope: the packed pretraining run
    counts.update((k, pcounts[k]) for k in (
        "flash_varlen_fwd", "flash_varlen_bwd_dq", "flash_varlen_bwd_dkv",
        "flash_varlen_plan", "rope"))

    main_case = {"rms_norm": ("rows=8_h=4096", "bfloat16", None),
                 "ragged_paged_attention": ("decode", "bfloat16", None),
                 "ragged_paged_attention_int8kv": ("decode", "bfloat16",
                                                   None),
                 "dequant_matmul": ("decode_gate_up", "bfloat16", "int8"),
                 "lora_epilogue": ("decode_gate_up", "bfloat16", None),
                 "paged_attention": ("decode", "bfloat16", None),
                 "flash_attention_fwd": ("slice_8b", "bfloat16", None),
                 "flash_attention_bwd_dq": ("slice_8b", "bfloat16", None),
                 "flash_attention_bwd_dkv": ("slice_8b", "bfloat16", None),
                 "rms_norm_bwd": ("rows=4096_h=4096", "bfloat16", None),
                 "grouped_matmul": ("a14b_gate_up", "bfloat16", None),
                 "layer_norm": ("rows=16384", "float32", None),
                 "layer_norm_bwd": ("rows=16384_h=768", "float32", None),
                 "flash_varlen_fwd": ("pretrain_8b", "bfloat16", None),
                 "flash_varlen_bwd_dq": ("pretrain_8b", "bfloat16", None),
                 "flash_varlen_bwd_dkv": ("pretrain_8b", "bfloat16", None),
                 "flash_varlen_plan": ("pretrain_8b", "int32", None),
                 "rope": ("pretrain_qk", "bfloat16", None)}
    # the packed path's design (bf16, D 128): sm90, plan included
    varlen_src = "paddle_tpu_torch/csrc/flash_varlen_sm90.cu"
    # the main paths' forward and backward (bf16, D 128 and 64): the
    # wgmma designs
    flash_src = "paddle_tpu_torch/csrc/flash_fwd_sm90.cu"
    bwd_src = "paddle_tpu_torch/csrc/flash_bwd_sm90.cu"
    # the split design the main paths run: its kernels live in the header
    attn_src = ("paddle_tpu_torch/csrc/decode_attention.cuh",
                "paddle_tpu/ops/ragged_paged_attention.py:293")
    meta = {"rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                         "paddle_tpu/ops/norm_kernels.py:45"),
            "ragged_paged_attention": attn_src,
            "ragged_paged_attention_int8kv": attn_src,
            "dequant_matmul": ("paddle_tpu_torch/csrc/dequant_matmul.cu",
                               "paddle_tpu/ops/quant_matmul.py:130"),
            "lora_epilogue": ("paddle_tpu_torch/csrc/lora_epilogue.cu",
                              "paddle_tpu/ops/lora_epilogue.py:111"),
            "paged_attention": ("paddle_tpu_torch/csrc/decode_attention.cuh",
                                "paddle_tpu/ops/paged_attention.py:53"),
            "flash_attention_fwd": (flash_src,
                                    "paddle_tpu/ops/flash_attention.py:127"),
            "flash_attention_bwd_dq": (
                bwd_src, "paddle_tpu/ops/flash_attention.py:223"),
            "flash_attention_bwd_dkv": (
                bwd_src, "paddle_tpu/ops/flash_attention.py:270"),
            "rms_norm_bwd": ("paddle_tpu_torch/csrc/rms_norm.cu",
                             "paddle_tpu/ops/norm_kernels.py:53"),
            "grouped_matmul": ("paddle_tpu_torch/csrc/grouped_matmul.cu",
                               "paddle_tpu/ops/grouped_matmul.py:46"),
            "layer_norm": ("paddle_tpu_torch/csrc/layer_norm.cu",
                           "paddle_tpu/ops/norm_kernels.py:148"),
            "layer_norm_bwd": ("paddle_tpu_torch/csrc/layer_norm.cu",
                               "paddle_tpu/ops/norm_kernels.py:160"),
            "flash_varlen_fwd": (varlen_src,
                                 "paddle_tpu/ops/flash_varlen.py:60"),
            "flash_varlen_bwd_dq": (varlen_src,
                                    "paddle_tpu/ops/flash_varlen.py:106"),
            "flash_varlen_bwd_dkv": (varlen_src,
                                     "paddle_tpu/ops/flash_varlen.py:149"),
            # the tile-level part of `_mask` and the kernels' skip tests
            "flash_varlen_plan": (varlen_src,
                                  "paddle_tpu/ops/flash_varlen.py:47"),
            "rope": ("paddle_tpu_torch/csrc/rope.cu",
                     "paddle_tpu/ops/rope.py:27")}
    kernels = []
    for name, (case, dt, mode) in main_case.items():
        rec = next(r for r in results if r["kernel"] == name
                   and r["case"] == case and r["dtype"] == dt
                   and r.get("mode") == mode and r.get("path_design", True))
        kernels.append(dict(
            name=name, route="cuda", source=meta[name][0],
            design=rec.get("design"),
            replaces=meta[name][1], launches=counts[name],
            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
            device_ms=rec.get("device_ms"), host_us=rec.get("host_us"),
            plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"],
            launches_by_path=by_path.get(name)))
    log(f"smoke seconds {time.perf_counter() - START:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
