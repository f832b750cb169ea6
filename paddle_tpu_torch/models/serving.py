"""Continuous-batching serving over a paged or dense KV cache: greedy,
sampled, or speculative.

≙ `paddle_tpu/models/serving.py`: `EngineOverloaded` / `PoolExhausted` /
`EngineInvariantError` / `ModelMismatch` :322-369, `Request` :457, and
the parts of `ContinuousBatchingEngine` that serve greedy requests:
construction :502-931 (both layouts), `add_request` / `run` / `step` /
`lifecycle_info` :1307-1512, `_expire` :2002, `cache_memory_info`
:2034-2066, `check_invariants` :2069-2176 with its adapter checks,
`_finalize` / `_release_slot` :2284-2350, admission :2394-2763 (one
packed ragged dispatch per batch, with `prefill_chunk` chunk
continuations and prefix-cache suffixes; on the legacy path one
dispatch per request, `_admit` :2472-2561 with its three branches), the
page allocator and the prefix cache's page trie :2852-3110 (trash page
0, refcounts, worst-case reservation, LRU eviction of childless nodes)
and the decode step with lazy page growth and preemption :3268-3565,
synchronous or pipelined (``harvest_every=k``: `_harvest_due` /
`_harvest_pending` / `quiesce` :3573-3730). Quantized serving (≙
`QUANT_MATMULS` / `QuantServingConfig` :401-453, the ``quant=`` check
:561-571, the int8 page and scale pools :668-693, `_build_quant_weights`
:930-964 without tensor parallelism). Multi-model serving (≙
`install_adapter` / `evict_adapter` / `install_weights` /
`reset_weights` / `_adapter_row` / `_lora_pv` :972-1304,
`add_request(adapter=)` :1334-1339 and the slot-to-adapter map). The
legacy paths, ``attention_impl="legacy"`` and ``kv_layout="dense"``
(≙ `_bucket` / `_build_prefill` :2347-2392, `_admit_shared` :2563-2592,
`_dense_insert` :2935-2952, `_paged_insert` / `_build_scatter`
:3079-3102, `_admit_chunked` / `_build_chunk_prefill` / `_build_sample`
:3112-3183, `_build_suffix_prefill` :3185-3239 and both arms of
`_build_decode` :3241-3266). The program cache (≙ `_jit_lru` /
`_jit_singleton` :2819-2850 over `_ragged_jits`, `_prefill_jits` and
`_suffix_jits` :810-814, `_get_prefill` :2352, `_get_ragged_prefill`
:2860, `_get_suffix_prefill` :3185, and the decode and chunk programs).
Sampling (≙ ``do_sample`` / ``temperature`` / ``top_k`` / ``top_p`` /
``seed`` :510-514, :624-628, `_next_keys` :2342 and the `_sample_token`
call of every program). Speculative decoding on the ragged path (≙
`SpecConfig` :373-399, the ``spec_decode=`` checks and draft pools
:816-919, `_check_invariants_draft` :2234, the draft drop of
`_release_slot` :2335-2340, `_build_ragged_step`'s ``draft=`` /
``select_rows=`` :2871-2930 and the spec round :3776-4161 without its
fault sites: `_spec_decode`, `_spec_draft`, `_d_grow` / `_d_release`,
`_spec_backfill`, `_dispatch_draft_prefill`, `_spec_scan`,
`_build_draft_scan`, `_spec_verify`, `spec_info`). Fault points,
failure isolation and telemetry (≙ the ``_M_*`` instruments :196-320,
`_admission_failed` :2453, the decode retry of `step` :1433-1455, the
``serving.*`` and ``speculative.*`` fault sites, `_spec_degrade` :3841,
`profile_round` :3730 and the spans, events and `note_round` calls of
every path): a prefill that raises before its admission writes the
pools fails its request alone; a decode step that faults before its
dispatch is retried up to ``max_decode_retries``; a spec round whose
draft or verify site faults decodes plainly; every ``pdt_*`` series of
the JAX engine is kept under the same names and labels, the program
cache metered by the JAX engine's family names. KV page transfer (≙
the payload helpers :103-197, `PayloadCorruption` / `QuantMismatch`
:338-356, `get_request` :1513, `_resident_slot` / `export_pages` /
`import_pages` / `evict_request` / `import_prefix` :1579-1948 and
`_install_kv` / `_build_install` :1950-2000): a running request's pages
and state leave one engine as a host payload with a sha256 manifest
and enter another through the install program
(`serving/transfer.py`, `serving/prefix_store.py`).

With ``attention_impl="ragged"`` (the default) each admission batch and
each decode step is ONE ragged dispatch: the packed token axis runs
through `LlamaForCausalLM.forward` with one `RaggedKVCacheView` per
layer, whose attention writes the new K/V rows into the page pools in
place and launches the ragged paged attention kernel. A prefix-cache hit
attaches the cached pages to the slot's block table and admits only the
prompt's suffix, at an offset, through the same dispatch. With
``harvest_every=k > 1`` a decode dispatch's greedy tokens stay on the
device and feed the next dispatch; the host reads them back once every k
dispatches (or sooner, when host work needs them).

With ``"legacy"`` each admitted request gets its own prefill dispatch:
its prompt padded to a ``prompt_pad`` bucket into the program's own
(1, bucket, HK, D) caches, whose K/V rows are then scattered into its
pages; a prefix-cache hit gathers the shared pages into the suffix
program's caches and prefills only the suffix, at ``position_offset =
shared_len``; a prompt of at least ``prefill_chunk`` tokens prefills in
fixed chunks through one program at a device offset (the model's traced
branch), each chunk's rows scattered as it completes. Every legacy
program that makes K/V rows (prefill, suffix, chunk) writes them into
one engine-wide rows buffer (`_legacy_rows`), and one scatter program a
row count copies them into the pages, the source offset, the true
length and the block-table row among its device inputs. A decode step is
one dispatch of (B, 1) tokens whose attention launches the q = 1 paged
attention kernel. ``kv_layout="dense"`` serves through the legacy
paths only: per-slot contiguous (B, S, HK, D) caches, the bucketed
prefill's rows copied into the slot's rows, and a (B, 1) decode at (B,)
positions over the caches in plain PyTorch (`masked_multihead_attention`,
as the JAX package computes it, outside any Pallas kernel); it has no
pages, so no prefix cache and no chunked prefill (both warn and are
dropped, as in JAX).

Under ``do_sample`` every program draws its tokens by
`generation.sample_tokens`: Gumbel-max over the filtered logits, the
uniforms a hash of (``seed``, a dispatch counter) that rides in the
program's input beside the index arrays. A captured program holds no
generator state, so the same seed gives the same streams eager and
graphed; the counter advances once a sampling dispatch, as JAX's key
splits once a dispatch.

With ``spec_decode=SpecConfig(draft, k)`` each decode step is a
speculative round: the draft model's own page pools (backfilled by a
draft prefill when a slot's draft cache was dropped), one draft-scan
program of k + 1 single-token draft forwards (the last the catch-up
that writes the k-th proposal's row), one host read of the proposals,
one verify dispatch of every slot's [last token, proposals] through the
target's ragged program returning every packed row's greedy pick, one
host read of those, then `speculative.spec_accept_greedy`, the commit
and the rewind. The streams equal the plain greedy engine's.

Each dispatch family the JAX engine compiles is a family of programs
here (`_Program`), keyed as the JAX engine keys its programs and held
in the same LRU: ragged admission by (padded tokens, pages bound) in
`_ragged_programs`, the legacy prefill by its bucket in
`_prefill_programs`, both capped at ``max_prefill_programs``, the
legacy suffix prefill by (shared_len, bucket) in `_suffix_programs`,
capped at twice that; the spec engine's draft prefills by (padded
tokens, pages bound) in `_d_prefill_programs` and its verify dispatches
likewise in `_verify_programs`; the legacy page scatter by its row
count in `_scatter_programs` and the transfer plane's page install by
its page count in `_install_programs`, each capped at
``max_prefill_programs`` (≙ `_scatter_jits`, `_install_jits`); the
decode step (ragged, paged or dense), the chunk prefill and the draft
scan are one program each. A
program's body is the dispatch's code on static input buffers, with the
KV pools or caches and the dispatch weights bound when it is built; on the card it is captured
once as a CUDA graph and replayed, so a step costs one host launch per
program instead of one per kernel. A weight or adapter change drops
every program (`_drop_programs`).

Every constructor option outside this subset raises NotImplementedError
naming the ROADMAP.md item that will port it.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import observability as telemetry
from ..observability import profile as _profile
from ..ops import launch_counts, resolve_device
from ..ops.lora_epilogue import LoraWeight
from ..ops.paged_attention import paged_prefill_scatter
from ..ops.quant_matmul import QuantizedWeight, quantize_weight_values
from ..ops.ragged_paged_attention import pack_ragged_batch, stream_tickets
from .generation import RequestStatus, _sample_token, sample_tokens
from .llama import PagedKVCacheView, RaggedKVCacheView
from .speculative import spec_accept_greedy
from ..utils.faults import FaultError, fault_point

__all__ = ["ContinuousBatchingEngine", "Request", "RequestStatus",
           "SpecConfig", "QuantServingConfig", "EngineOverloaded",
           "PoolExhausted", "EngineInvariantError", "ModelMismatch",
           "PayloadCorruption", "QuantMismatch", "assemble_payload_kv",
           "payload_checksums", "payload_scale_checksums",
           "verify_payload"]


# -- transfer payloads (≙ :103-197) --------------------------------------
# A payload's arrays are CPU torch tensors (numpy has no bfloat16); the
# helpers take numpy arrays as well, so that a JAX engine's payload
# verifies and installs here.
def _dtype_name(dt) -> str:
    """The JAX package's name of a dtype ("bfloat16", "float32", "int8")
    for a torch dtype."""
    return str(dt).replace("torch.", "")


def _host_tensor(a) -> torch.Tensor:
    """``a``, a torch tensor or a numpy array (bfloat16 through
    ``ml_dtypes``, as the JAX package exports it), as a torch tensor on
    the host, sharing its memory where it can."""
    if torch.is_tensor(a):
        return a
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _sha256(a) -> str:
    """``"sha256:<hex>"`` of an array's raw bytes in C order: the same
    digest as the JAX package's ``np.ascontiguousarray(a).tobytes()``
    for the same values (a bf16 tensor hashes its 16-bit words)."""
    if torch.is_tensor(a):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.numpy()
    raw = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    return "sha256:" + hashlib.sha256(raw).hexdigest()


def assemble_payload_kv(payload: dict):
    """The logical per-layer (k, v) page rows of a transfer payload:
    ``payload["kv"]``, or a tensor-parallel source's per-shard fragments
    (``payload["kv_shards"]``: outer list the shards in head order,
    inner the layers) joined on the KV-head axis. This engine exports
    ``kv`` (one shard); a JAX tensor-parallel payload installs through
    this view."""
    if payload.get("kv") is not None:
        return payload["kv"]
    shards = payload["kv_shards"]
    if len(shards) == 1:
        return list(shards[0])
    return [tuple(torch.cat([_host_tensor(s[li][j]) for s in shards])
                  for j in range(2))
            for li in range(len(shards[0]))]


def payload_checksums(payload: dict):
    """One ``"sha256:<hex>"`` per key and value array of every shard
    fragment (the wire unit), per layer, in wire order: the bytes that
    cross the device-to-host link, so a flipped byte anywhere in the
    payload is seen before it installs into a target's pool."""
    shards = [payload["kv"]] if payload.get("kv") is not None \
        else payload["kv_shards"]
    return [[[_sha256(k), _sha256(v)] for k, v in shard]
            for shard in shards]


def payload_scale_checksums(payload: dict):
    """The checksums of a quantized payload's per-page scale rows
    (``payload["kv_scales"]``, one (k_scale, v_scale) pair a layer): a
    flipped scale byte corrupts every row of a page at dequant. None
    for a full-width payload."""
    scales = payload.get("kv_scales")
    if scales is None:
        return None
    return [[_sha256(ks), _sha256(vs)] for ks, vs in scales]


def verify_payload(payload: dict) -> None:
    """Hold a payload's ``kv_sha256`` manifest (and ``scales_sha256``)
    to its bytes; raises :class:`PayloadCorruption` on any mismatch. A
    payload without a manifest passes (`export_pages` always attaches
    one). `import_pages` calls it before any target mutation."""
    want = payload.get("kv_sha256")
    if want is None:
        return
    got = payload_checksums(payload)
    if got != [[list(pair) for pair in shard] for shard in want]:
        for s, (gs, ws) in enumerate(zip(got, want)):
            for layer, (gp, wp) in enumerate(zip(gs, ws)):
                if gp != list(wp):
                    raise PayloadCorruption(
                        f"KV payload checksum mismatch for request "
                        f"{payload.get('request_id')!r} at shard {s} "
                        f"layer {layer} — the payload was corrupted "
                        "in flight; refusing to install")
        raise PayloadCorruption(
            f"KV payload checksum manifest shape mismatch for request "
            f"{payload.get('request_id')!r} (manifest "
            f"{len(want)} shards vs payload {len(got)})")
    want_sc = payload.get("scales_sha256")
    if want_sc is not None:
        got_sc = payload_scale_checksums(payload)
        if got_sc != [list(pair) for pair in want_sc]:
            raise PayloadCorruption(
                f"KV payload SCALE checksum mismatch for request "
                f"{payload.get('request_id')!r} — the per-page dequant "
                "scales were corrupted in flight; refusing to install")


# -- telemetry (≙ :196-320: names, help, labels and buckets unchanged) --
# Instruments are process-global (all engines in a process aggregate)
# and created unconditionally — recording is a no-op unless telemetry
# is enabled (PDT_TELEMETRY=1 / telemetry.enable()).
_M_QUEUE_DEPTH = telemetry.gauge(
    "pdt_serving_queue_depth", "Requests waiting for a slot.")
_M_RUNNING = telemetry.gauge(
    "pdt_serving_running_slots", "Slots with an in-flight request.")
_M_ADMISSIONS = telemetry.counter(
    "pdt_serving_admissions_total",
    "Requests admitted into a slot (prefill dispatched successfully).")
_M_REJECTIONS = telemetry.counter(
    "pdt_serving_rejections_total",
    "add_request refusals by reason.", ("reason",))
_M_TERMINAL = telemetry.counter(
    "pdt_serving_requests_terminal_total",
    "Requests reaching a terminal state, by final status.", ("status",))
_M_TTFT = telemetry.histogram(
    "pdt_serving_ttft_seconds",
    "Time to first token: enqueue to first prefill token, engine clock.")
_M_TPOT = telemetry.histogram(
    "pdt_serving_tpot_seconds",
    "Time per output token after the first, finished requests.",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5))
_M_DECODE_STEP = telemetry.histogram(
    "pdt_serving_decode_step_seconds",
    "Wall time of one batched decode dispatch incl. its D2H sync "
    "(the synchronous harvest_every=1 path).")
# pipelined decode (harvest_every=k): dispatch wall and harvest/D2H
# wall are SEPARATE histograms — the single step histogram conflates
# exactly the two costs the overlap window trades off
_M_DECODE_DISPATCH = telemetry.histogram(
    "pdt_serving_decode_dispatch_seconds",
    "Wall time of one batched decode dispatch WITHOUT its D2H sync "
    "(the device-feedback half of the pipelined hot loop).")
_M_HARVEST = telemetry.histogram(
    "pdt_serving_harvest_seconds",
    "Wall time of one batched harvest: the D2H sync over a whole "
    "deferred window (harvest_every dispatches) plus token commits.")
_M_DECODE_TOKENS = telemetry.counter(
    "pdt_serving_decode_tokens_total",
    "Tokens emitted by decode steps (excludes prefill first tokens).")
_M_TOKENS_PER_SEC = telemetry.gauge(
    "pdt_serving_tokens_per_sec",
    "Decode throughput of the most recent step (active slots / wall).")
_M_PREEMPTIONS = telemetry.counter(
    "pdt_serving_preemptions_total",
    "Preemption events (requeues and starvation finalizations).")
_M_DECODE_RETRIES = telemetry.counter(
    "pdt_serving_decode_retries_total",
    "Transient decode-dispatch faults retried.")
_M_PAGES_IN_USE = telemetry.gauge(
    "pdt_serving_pages_in_use", "Allocated KV pages (paged layout).")
_M_PAGE_OCCUPANCY = telemetry.gauge(
    "pdt_serving_page_occupancy",
    "Fraction of usable KV pages allocated (paged layout).")
_M_INVARIANT_SECONDS = telemetry.histogram(
    "pdt_serving_invariant_check_seconds",
    "Duration of check_invariants() page-accounting sweeps.")
# -- speculative decoding (spec_decode=SpecConfig(...)) ---------------
_M_SPEC_ROUNDS = telemetry.counter(
    "pdt_spec_rounds_total",
    "Completed speculative decode rounds (draft + verify + commit).")
_M_SPEC_PROPOSED = telemetry.counter(
    "pdt_spec_proposed_total",
    "Draft tokens submitted to a verify pass.")
_M_SPEC_ACCEPTED = telemetry.counter(
    "pdt_spec_accepted_total",
    "Draft tokens the target's greedy verify accepted.")
_M_SPEC_ACCEPT_RATE = telemetry.gauge(
    "pdt_spec_acceptance_rate",
    "Running accepted/proposed fraction across all spec rounds.")
_M_SPEC_DEGRADED = telemetry.counter(
    "pdt_spec_degraded_total",
    "Spec rounds degraded to plain decode, by failing site.", ("site",))
_M_SPEC_DRAFT_SECONDS = telemetry.histogram(
    "pdt_spec_draft_seconds",
    "Wall time of one round's draft pass (backfill prefills + the "
    "k-step draft scan), incl. the D2H sync.")
_M_SPEC_VERIFY_SECONDS = telemetry.histogram(
    "pdt_spec_verify_seconds",
    "Wall time of one batched verify dispatch incl. the D2H sync.")
# -- quantized serving (quant=QuantServingConfig(...)) -----------------
_M_QUANT_WEIGHT_LAYERS = telemetry.gauge(
    "pdt_quant_weight_layers",
    "Matmul weights held quantized (int8/fp8 + per-channel scale) by "
    "the most recently built quantized engine.")
_M_QUANT_WEIGHT_BYTES = telemetry.gauge(
    "pdt_quant_weight_bytes",
    "Bytes of the most recently built engine's quantized weights, "
    "storage plus scales (the HBM the full-width copies would have "
    "multiplied).")
_M_QUANT_PAGE_BYTES = telemetry.gauge(
    "pdt_quant_page_bytes",
    "Bytes of ONE quantized KV page across layers, int8 storage plus "
    "per-page-row scales (cache_memory_info page_bytes of the most "
    "recently built quantized engine).")
_M_QUANT_MISMATCH = telemetry.counter(
    "pdt_quant_mode_mismatch_total",
    "Cross-quant-mode installs refused with QuantMismatch, by entry "
    "path (import = migration payload, prefix = spill-chain restore).",
    ("kind",))
# -- multi-model serving (serving/model_store.py) ----------------------
_M_MODEL_MISMATCH = telemetry.counter(
    "pdt_model_mismatch_total",
    "Cross-model installs refused with ModelMismatch, by entry path "
    "(import = migration payload, adapter = unknown/non-resident "
    "adapter id at add_request or import).", ("kind",))
_M_LORA_RESIDENT = telemetry.gauge(
    "pdt_lora_adapters_resident",
    "LoRA adapter rows resident in the most recently mutated engine's "
    "stacked A/B tensors (row 0 — the all-zeros no-adapter row — "
    "excluded).")
_M_LORA_BYTES = telemetry.gauge(
    "pdt_lora_adapter_bytes",
    "Bytes held by the resident LoRA adapter stacks (A + B + per-row "
    "scales) across all adapted matmuls of the most recently mutated "
    "engine.")
_M_LORA_INSTALLS = telemetry.counter(
    "pdt_lora_installs_total",
    "Adapter rows installed into an engine's stacks (install_adapter "
    "commits).")
_M_LORA_EVICTIONS = telemetry.counter(
    "pdt_lora_evictions_total",
    "Adapter rows evicted from an engine's stacks (evict_adapter "
    "commits; refusals for in-flight use do not count).")


class EngineOverloaded(RuntimeError):
    """add_request refused: the bounded admission queue is full or the
    admission policy rejected the request."""


class PoolExhausted(RuntimeError):
    """A KV page allocation could not be satisfied. Admission
    reservation makes this unreachable on the healthy path; decode-time
    growth turns it into preemption."""


class EngineInvariantError(AssertionError):
    """check_invariants() found inconsistent page accounting."""


class PayloadCorruption(ValueError):
    """A transfer payload's KV bytes do not match its ``kv_sha256``
    manifest (`verify_payload`). Raised by `import_pages` before any
    target mutation: both engines stay consistent, and the transfer
    plane counts ``pdt_transfer_failures_total{stage="verify"}``."""


class QuantMismatch(ValueError):
    """A KV install crossed quantization modes: int8 pages and their
    scales offered to a full-width engine, or the other way. The bytes
    are not interpretable on the other side. Raised by `import_pages` /
    `import_prefix` before any target mutation and counted
    ``pdt_quant_mode_mismatch_total{kind=}``."""


class ModelMismatch(ValueError):
    """A request or KV install crossed model identity: a migration
    payload produced under one hosted model (``model_tag``) or adapter
    offered to an engine serving another, whose pages would encode
    another function of the weights, or a request naming a LoRA adapter
    that is not resident in this engine's stacks. Raised before any
    target mutation (by `add_request` before the request is queued) and
    counted ``pdt_model_mismatch_total{kind=}``; the fleet model store
    (`serving.model_store`) installs the right weights or adapter before
    it routes a request there."""


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    output: List[int] = field(default_factory=list)
    done: bool = False
    status: str = RequestStatus.QUEUED
    enqueue_time: float = 0.0
    preemptions: int = 0
    error: Optional[str] = None
    first_token_time: Optional[float] = None   # engine clock
    arrival_time: float = 0.0                  # add_request tick
    request_id: str = ""
    priority: int = 0                          # lower admits first
    adapter: Optional[str] = None              # resident LoRA adapter
    deadline: Optional[float] = None           # absolute engine clock
    max_queue_time: Optional[float] = None     # seconds waiting for a slot
    # tokens the device has produced, counting dispatches of a pipelined
    # window not harvested yet: >= len(output), resynced to it at every
    # harvest (at harvest_every=1, every step). The JAX engine leaves it
    # at 0 at k = 1: read it as max(device_len, len(output)) there
    device_len: int = 0


# constructor options of the JAX engine that this port does not have
# yet: (argument, the value that means "off", ROADMAP.md queue A item)
_UNPORTED_OPTIONS = (
    ("submesh", None, "9 (tensor parallelism)"),
)


@dataclass
class SpecConfig:
    """Speculative decoding as an engine mode:
    ``ContinuousBatchingEngine(spec_decode=SpecConfig(draft, k))``. Every
    decode round drafts ``k`` greedy tokens a slot with ``draft_model``
    over its own page pools (one draft-scan program), verifies every slot
    in ONE ragged target dispatch, keeps the longest matching prefix plus
    the bonus token (`speculative.spec_accept_greedy`) and rewinds past
    the rejected positions (their stale K/V is overwritten by the next
    round's scatter before any causal mask admits it). Greedy streams
    equal the plain engine's exactly.

    ``draft_model`` shares the target's vocabulary and device and covers
    ``max_seq_len`` with its rope table; its weights stay its own (full
    width under ``quant=``, whose int8 KV the draft pools take too).
    ``num_pages`` sizes the draft page pool (default the full ``B x
    pages_per_seq`` worst case: the draft cache has no prefix sharing).
    Greedy engines only; sampling callers use
    `speculative.speculative_generate`."""

    draft_model: object
    k: int = 4
    num_pages: Optional[int] = None


# the matmuls a quantized engine converts (embeddings stay full width:
# the embed lookup is a gather, not a matmul, and a tied lm_head reuses
# the embedding, so it is left out with it)
QUANT_MATMULS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj", "lm_head")


@dataclass
class QuantServingConfig:
    """Quantized serving as an engine mode:
    ``ContinuousBatchingEngine(quant=QuantServingConfig(...))``.

    ``weights``: ``"int8"`` | ``"fp8"`` | None — the `QUANT_MATMULS`
    weights are converted once at engine build to int8 or
    float8_e4m3fn storage with one f32 scale per output channel
    (`ops.quant_matmul.quantize_weight_values`) and run through the
    dequant matmul kernel. The model object is untouched: the engine
    hands the quantized weights to each dispatch.

    ``kv``: ``"int8"`` | None — the KV page pools store int8 with
    (P, page_size) f32 per-page-row dequant scales
    (`ragged_scatter_quantized` quantizes on commit, the ragged
    attention kernel dequantizes per page in flight). Per-row
    quantization keeps the page bytes path-invariant, so quantized-mode
    greedy streams stay bit-identical through preemption.

    Requires ``kv_layout="paged"`` with ``attention_impl="ragged"``."""

    weights: Optional[str] = None
    kv: Optional[str] = None

    def __post_init__(self):
        if self.weights not in (None, "int8", "fp8"):
            raise ValueError(
                f"quant weights {self.weights!r}: int8|fp8|None")
        if self.kv not in (None, "int8"):
            raise ValueError(f"quant kv {self.kv!r}: int8|None")
        if self.weights is None and self.kv is None:
            raise ValueError(
                "QuantServingConfig with neither weights nor kv set — "
                "drop the quant= argument instead")


def _invariants_enabled() -> bool:
    return os.environ.get("PDT_CHECK_INVARIANTS") == "1"


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A, item {item})")


class _Program:
    """One program of the engine's program cache (≙ one compiled program
    of the JAX engine: an entry of `_ragged_jits` or `_prefill_jits`, or
    a decode program). It owns its static input ``flat``, ONE int32
    tensor on the engine's device holding every index array of a
    dispatch (`ContinuousBatchingEngine._upload` writes into it), its
    ``body``, the dispatch's code on views of ``flat`` with the KV pools
    and the dispatch weights bound when the program was built, and, once
    captured, its static output ``out`` (the greedy tokens). A legacy
    prefill, suffix or chunk program's body writes its K/V rows into the
    engine's `_legacy_rows`, which the scatter program or the dense copy
    reads. A body holds no
    reference to its engine, so an engine that is dropped frees its
    pools at once, not at the next garbage collection.

    `ContinuousBatchingEngine._run_program` runs it: on the card the
    first run is the body, eagerly, on the engine's capture stream (the
    warm-up, which makes what the kernels create at first use: that
    stream's split tickets, the loaded libraries); the second run
    captures the body into ``graph`` and replays it, and every later run
    replays it, adding ``launches`` (the launch counts the capture
    recorded) to `ops.launch_counts`. ``held`` keeps alive the buffers
    the graph reads by address that nothing else owns. On the CPU the
    body runs eagerly every time, on the same buffers, and its result is
    copied into ``out``. ``family`` and ``key`` are the JAX engine's
    names for its program family and its key, the labels under which
    its first run (and on the card its capture) is metered."""

    def __init__(self, flat: torch.Tensor, body: Callable[[], torch.Tensor]):
        self.flat = flat
        self.body = body
        self.out: Optional[torch.Tensor] = None
        self.graph = None
        self.runs = 0
        self.launches: Dict[str, int] = {}
        self.held: tuple = ()
        # the program-cache family and key, the labels of its metering
        self.family = "misc"
        self.key = None


class ContinuousBatchingEngine:
    """In-flight batched serving for `LlamaForCausalLM`.

    Runs on the CUDA card unless ``device`` names another device; the
    model must live on that device. The KV page pools take the model's
    parameter dtype, or int8 with f32 scale pools under
    ``quant=QuantServingConfig(kv="int8")``. ``attention_impl`` picks
    the ragged dispatch (default) or the legacy paged path (module
    docstring); ``kv_layout="dense"`` keeps per-slot contiguous caches
    and serves through the legacy paths; ``prompt_pad`` is the legacy
    prefill's bucket step and the ragged admission's pad.
    ``do_sample`` draws every token from softmax of the logits under
    ``temperature``, ``top_k`` and ``top_p`` (`generation.filter_logits`),
    reproducibly from ``seed`` (module docstring); a greedy engine
    ignores the four, as the JAX engine does. ``spec_decode`` takes a
    `SpecConfig` (paged ragged greedy engines only).
    ``max_prefill_programs`` caps each keyed program family (module
    docstring).

    ``_graphs`` (private) False runs every dispatch eagerly, with no
    program cache: the yardstick that the card checks and the tests
    hold the graphed engine against."""

    def __init__(self, model, max_batch_size: int = 8,
                 max_seq_len: Optional[int] = None,
                 eos_token_id: Optional[int] = None,
                 prompt_pad: int = 16,
                 kv_layout: str = "paged",
                 attention_impl: str = "ragged",
                 page_size: int = 16,
                 num_pages: Optional[int] = None,
                 do_sample: bool = False,
                 temperature: float = 1.0,
                 top_k: int = 0,
                 top_p: float = 1.0,
                 seed: int = 0,
                 max_prefill_programs: int = 8,
                 enable_prefix_caching: bool = False,
                 max_prefix_entries: int = 32,
                 prefill_chunk: Optional[int] = None,
                 max_waiting: Optional[int] = None,
                 request_timeout: Optional[float] = None,
                 max_queue_time: Optional[float] = None,
                 max_preemptions: int = 3,
                 max_decode_retries: int = 3,
                 admission_policy: Optional[
                     Callable[["ContinuousBatchingEngine", Request],
                              bool]] = None,
                 clock: Optional[Callable[[], float]] = None,
                 spec_decode=None,
                 submesh=None,
                 quant=None,
                 harvest_every: int = 1,
                 device=None,
                 _graphs: bool = True):
        given = dict(locals())
        # pipelined decode (≙ :539-560): the JAX engine's checks, before
        # any other option is looked at
        self.harvest_every = int(harvest_every)
        if self.harvest_every < 1:
            raise ValueError(
                f"harvest_every must be >= 1, got {harvest_every}")
        if self.harvest_every > 1:
            if kv_layout != "paged" or attention_impl != "ragged":
                raise ValueError(
                    "harvest_every > 1 requires kv_layout='paged' with "
                    "attention_impl='ragged' — the deferred-harvest "
                    "window feeds the device token vector back through "
                    "the ragged dispatch only")
            if do_sample:
                raise ValueError(
                    "harvest_every > 1 is greedy-only: a window "
                    "dispatched past another slot's EOS would draw "
                    "random numbers the synchronous loop never draws")
            if spec_decode is not None:
                raise ValueError(
                    "harvest_every > 1 does not compose with "
                    "spec_decode — a speculative round's verify pass "
                    "is its synchronous harvest")
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"kv_layout {kv_layout!r}: paged|dense")
        if attention_impl not in ("ragged", "legacy"):
            raise ValueError(
                f"attention_impl {attention_impl!r}: ragged|legacy")
        if quant is not None and (kv_layout != "paged"
                                  or attention_impl != "ragged"):
            raise ValueError(
                "quant= requires kv_layout='paged' with "
                "attention_impl='ragged' — the quantized page layout "
                "and the fused dequant epilogue thread through the "
                "ragged dispatch family only")
        for name, off, item in _UNPORTED_OPTIONS:
            if given[name] != off:
                _not_ported(f"{name}={given[name]!r}", item)
        cfg = model.config
        if kv_layout == "paged" and cfg.sliding_window is not None \
                and enable_prefix_caching:
            # ≙ :610-620: slid-out pages are reclaimed and trash-routed,
            # so a window model's prompt pages are not stable shared KV
            warnings.warn(
                "sliding_window model: prefix caching is DISABLED "
                "(window reclamation invalidates cached prompt pages)")
            enable_prefix_caching = False
        dev = resolve_device(device)
        mdev = model.device
        if dev.type != mdev.type or (dev.index is not None
                                     and dev.index != mdev.index):
            raise ValueError(f"engine device {dev} but the model lives "
                             f"on {mdev}")
        self.device = mdev
        self.model = model
        self._params = dict(model.named_parameters())
        # ragged attention walks the page table; the dense layout has no
        # pages, so it always serves through the legacy paths (≙ :606-609)
        self.layout = kv_layout
        self.attn_impl = attention_impl if kv_layout == "paged" \
            else "legacy"
        self.B = int(max_batch_size)
        self.S = int(max_seq_len or cfg.max_position_embeddings)
        if self.S > cfg.max_position_embeddings:
            raise ValueError(
                f"max_seq_len {self.S} exceeds the model's rope table "
                f"(max_position_embeddings="
                f"{cfg.max_position_embeddings})")
        self._window = cfg.sliding_window
        self.eos = eos_token_id
        self.pad = int(prompt_pad)
        hk, hd = cfg.num_key_value_heads, cfg.head_dim
        dt = next(model.parameters()).dtype
        self._qw_mode = quant.weights if quant is not None else None
        self._qkv = quant.kv if quant is not None else None
        self._kv_shape = (cfg.num_hidden_layers, hk, hd, dt)
        # the quantized weights handed to every dispatch, and their count
        # and bytes (the ``pdt_quant_weight_*`` gauges)
        self._qweights = self._build_quant_weights() if self._qw_mode \
            else None
        qws = (self._qweights or {}).values()
        self.quant_weight_layers = len(qws)
        self.quant_weight_bytes = sum(w.nbytes for w in qws)
        if self._qw_mode:
            _M_QUANT_WEIGHT_LAYERS.set(self.quant_weight_layers)
            _M_QUANT_WEIGHT_BYTES.set(self.quant_weight_bytes)
        if kv_layout == "dense":
            # ≙ :641-660: per-slot contiguous (B, S, HK, D) caches, no
            # pages, so neither the prefix cache nor chunked prefill
            if enable_prefix_caching:
                warnings.warn(
                    "enable_prefix_caching requires kv_layout='paged' — "
                    "prefix caching is DISABLED on the dense layout")
            self._prefix_enabled = False
            self.prefix_hits = 0
            self.prefix_tokens_reused = 0
            if prefill_chunk:
                warnings.warn("prefill_chunk requires kv_layout='paged' "
                              "— chunked prefill is DISABLED on the "
                              "dense layout")
            self._chunk = None
            self._caches = [tuple(torch.zeros(self.B, self.S, hk, hd,
                                              dtype=dt, device=self.device)
                                  for _ in range(2))
                            for _ in range(cfg.num_hidden_layers)]
        else:
            self._init_pages(page_size, num_pages, enable_prefix_caching,
                             max_prefix_entries, prefill_chunk)
            if self._qkv:
                _M_QUANT_PAGE_BYTES.set(
                    self.cache_memory_info()["page_bytes"])
        # sampling (≙ :624-628): the (seed, counter) key of the next
        # sampling dispatch (`_next_key`)
        self.strategy = "sampling" if do_sample else "greedy_search"
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self._seed_bits = int(np.array([int(seed) & 0xFFFFFFFF],
                                       np.uint32).view(np.int32)[0])
        self._sample_ctr = 0
        self._ragged_block_q = 8
        self._init_spec(spec_decode, do_sample)
        # host-side slot state
        self._pos = np.zeros(self.B, np.int32)       # next write position
        self._tok = np.zeros(self.B, np.int32)       # last emitted token
        self._slot_req: List[Optional[Request]] = [None] * self.B
        self._queue: List[Request] = []
        self._next_rid = 0
        self.max_waiting = None if max_waiting is None else int(max_waiting)
        self.request_timeout = request_timeout
        self.max_queue_time = max_queue_time
        self.max_preemptions = int(max_preemptions)
        self.max_decode_retries = int(max_decode_retries)
        self.admission_policy = admission_policy
        self._clock = clock if clock is not None else time.monotonic
        self.num_timeouts = 0
        self.num_failures = 0
        self.num_preemptions = 0
        self.num_decode_retries = 0
        self._consec_decode_faults = 0
        # writes to the KV pools or dense caches begun by a non-ragged
        # writer (the scatter and install programs, `_dense_insert`),
        # counted just before each: a failed legacy admission is
        # isolated only while it has written nothing (`_admit_legacy`)
        self._pool_writes = 0
        self._finished_backlog: List[Request] = []
        self._admit_seq = 0
        self._slot_seq = np.zeros(self.B, np.int64)
        # the decode window: one entry per decode dispatch not harvested
        # yet (at harvest_every=1, harvested in the same step), {nxt: its
        # device tokens, act: the active slots (constant within a
        # window), pos: _pos after it};
        # _tok_dev is the last dispatch's device tokens, the next one's
        # input; _window_wall sums the window's dispatch walls
        self._pending: List[dict] = []
        self._tok_dev: Optional[torch.Tensor] = None
        self._window_wall = 0.0
        # multi-model serving: model_tag is None for the build-time
        # weights; install_weights swaps in {name: value} for EVERY
        # parameter (`_mpv`) and stamps the tag. Batched multi-LoRA:
        # per adapted matmul a stacked (R, K, r) / (R, r, N) pair whose
        # row 0 is the all-zeros no-adapter row; _slot_adapter maps each
        # slot to its request's row and gives every dispatch its
        # per-token adapter rows
        self.model_tag: Optional[str] = None
        self._mpv: Optional[Dict[str, object]] = None
        self._lora: Optional[Dict[str, object]] = None
        self._adapter_rows: Dict[str, int] = {}
        self._lora_free_rows: List[int] = []
        self._slot_adapter = np.zeros(self.B, np.int32)
        # the ``pdt_lora_installs_total`` / ``_evictions_total`` counts of
        # this engine (the two gauges are the properties below)
        self.lora_installs = 0
        self.lora_evictions = 0
        # dispatch accounting: every dispatch runs each layer's attention
        # once and every RMSNorm once
        self.num_admission_dispatches = 0
        self.num_decode_dispatches = 0
        # host wall of decode dispatches with their D2H token copies (a
        # window's dispatch walls plus its one harvest copy at k > 1),
        # and the tokens they committed
        self.decode_seconds = 0.0
        self.decode_tokens = 0
        # the host wall of the decode dispatches alone, without the token
        # copies: what the host spends issuing a step
        self.decode_dispatch_seconds = 0.0
        self.admission_seconds = 0.0   # host wall of admission dispatches
        self.admission_tokens = 0      # prompt tokens they prefilled
        # the program cache (≙ `_ragged_jits` / `_prefill_jits` under
        # `_max_prefill`, and the decode program): LRU order, oldest
        # first. Captures are metered apart from the dispatch walls, as
        # the JAX engine meters compiles (`compile_timed`): the
        # counterparts of ``pdt_jit_compiles_total`` and its seconds
        self._graphs = bool(_graphs)
        self._max_prefill = int(max_prefill_programs)
        self._ragged_programs: "OrderedDict[tuple, _Program]" = OrderedDict()
        self._prefill_programs: "OrderedDict[int, _Program]" = OrderedDict()
        # the legacy prefix cache's suffix prefills by (shared_len,
        # bucket), under twice the cap (≙ `_suffix_jits`)
        self._suffix_programs: "OrderedDict[tuple, _Program]" = \
            OrderedDict()
        self._decode_program: Optional[_Program] = None
        # the legacy chunked prefill's one program (≙ `_chunk_jit`)
        self._chunk_program: Optional[_Program] = None
        # the spec engine's families (≙ `_d_prefill_jits`,
        # `_verify_jits`, `_d_scan_jit`)
        self._d_prefill_programs: "OrderedDict[tuple, _Program]" = \
            OrderedDict()
        self._verify_programs: "OrderedDict[tuple, _Program]" = \
            OrderedDict()
        self._draft_scan_program: Optional[_Program] = None
        # the legacy page scatter by row count and the page install by
        # page count (≙ `_scatter_jits`, `_install_jits`), and the static
        # buffers they read, made at first use: the legacy programs' K/V
        # rows (`_legacy_rows`) and the install's staging
        # (`_install_staging`)
        self._scatter_programs: "OrderedDict[int, _Program]" = OrderedDict()
        self._install_programs: "OrderedDict[int, _Program]" = OrderedDict()
        self._rows: Optional[list] = None
        self._staging: Optional[torch.Tensor] = None
        self._capture_stream = None
        self._graph_pool = None
        self.num_graph_captures = 0
        self.graph_capture_seconds = 0.0

    def _init_pages(self, page_size, num_pages, enable_prefix_caching,
                    max_prefix_entries, prefill_chunk):
        """The paged layout's state (≙ :661-760): the page pools, the
        allocator, the prefix cache's trie and the chunked prefill."""
        self.page_size = int(page_size)
        self.pps = -(-self.S // self.page_size)
        # +1: page 0 is the reserved trash page
        self.num_pages = int(num_pages or self.B * self.pps + 1)
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        L, hk, hd, dt = self._kv_shape
        pool_dt = torch.int8 if self._qkv else dt

        def pools():
            # (k, v) pages, and for int8 pages (k_scale, v_scale): one
            # f32 dequant scale per page row, shared by every head
            kv = [torch.zeros(hk, self.num_pages, self.page_size, hd,
                              dtype=pool_dt, device=self.device)
                  for _ in range(2)]
            if self._qkv:
                kv += [torch.zeros(self.num_pages, self.page_size,
                                   dtype=torch.float32, device=self.device)
                       for _ in range(2)]
            return tuple(kv)
        self._kv = [pools() for _ in range(L)]
        self._bt = np.zeros((self.B, self.pps), np.int32)
        self._free: List[int] = list(range(1, self.num_pages))
        self._slot_pages: List[List[int]] = [[] for _ in range(self.B)]
        self._slot_reserved = np.zeros(self.B, np.int64)
        # pages ever attached: the next block-table index to fill; stays
        # monotonic after window reclamation frees leading pages
        self._slot_next_idx = np.zeros(self.B, np.int64)
        self._slot_freed = np.zeros(self.B, np.int64)
        self._page_rc = np.zeros(self.num_pages, np.int32)
        # the prefix cache (≙ :704-727): a page trie, one node per
        # (parent key, page of tokens) in LRU order, each holding one
        # reference on its page; a slot attaches matched pages read-only
        # and holds one reference on each in _slot_shared_pages
        self._prefix_enabled = bool(enable_prefix_caching)
        self._max_prefix_entries = int(max_prefix_entries)
        self._prefix_nodes: "OrderedDict[tuple, dict]" = OrderedDict()
        self._slot_shared_pages: List[List[int]] = [[] for _ in
                                                    range(self.B)]
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self._chunk = int(prefill_chunk) if prefill_chunk else None
        if self._chunk is not None:
            if self._chunk % self.page_size:
                raise ValueError(
                    f"prefill_chunk {self._chunk} must be a multiple of "
                    f"page_size {self.page_size}")
            if self.S % self._chunk:
                raise ValueError(
                    f"max_seq_len {self.S} must be a multiple of "
                    f"prefill_chunk {self._chunk}")

    def _init_spec(self, spec, do_sample):
        """The spec engine's checks and state (≙ :816-919): the draft's
        page pools (page 0 the trash page; int8 with (P, page_size) f32
        scale pools under int8 KV), its block table, free list, pages a
        slot, frontier and validity, and the round counters. A draft
        cache is valid when it holds rows [0, pos) of its slot's stream;
        a release drops it, and the next round backfills it."""
        self._spec = spec
        self.num_spec_rounds = 0
        self.num_spec_proposed = 0
        self.num_spec_accepted = 0
        # spec rounds degraded to plain decode by a fault at a
        # ``speculative.*`` site (`_spec_degrade`)
        self.num_spec_degraded = 0
        # the draft's dispatches (backfill prefills, scans) and the host
        # walls of a round's halves, the reads included (the JAX
        # engine's ``pdt_spec_draft_seconds`` / ``_verify_seconds``)
        self.num_draft_prefills = 0
        self.num_draft_scans = 0
        self.spec_draft_seconds = 0.0
        self.spec_verify_seconds = 0.0
        if spec is None:
            return
        if self.layout != "paged" or self.attn_impl != "ragged":
            raise ValueError(
                "spec_decode requires kv_layout='paged' with "
                "attention_impl='ragged' — the verify pass is a ragged "
                "multi-token dispatch over the page table")
        if do_sample:
            raise ValueError(
                "spec_decode is greedy-only (bit-identical to the plain "
                "engine); for sampling use "
                "models.speculative.speculative_generate")
        if self._window is not None:
            raise ValueError(
                "spec_decode does not compose with sliding_window models "
                "(window page reclamation would race the draft cache's "
                "rewind bookkeeping)")
        if int(spec.k) < 1:
            raise ValueError(f"spec_decode.k must be >= 1, got {spec.k}")
        draft = spec.draft_model
        d_cfg, cfg = draft.config, self.model.config
        if draft.device != self.device:
            raise ValueError(f"draft model on {draft.device} but the "
                             f"engine serves on {self.device}")
        if d_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(f"draft vocab {d_cfg.vocab_size} != target "
                             f"vocab {cfg.vocab_size}")
        if d_cfg.max_position_embeddings < self.S:
            raise ValueError(
                f"draft rope table ({d_cfg.max_position_embeddings} "
                f"positions) does not cover max_seq_len {self.S}")
        self._spec_k = int(spec.k)
        d_dt = next(draft.parameters()).dtype
        self._d_num_pages = int(spec.num_pages or self.B * self.pps + 1)
        hk, hd = d_cfg.num_key_value_heads, d_cfg.head_dim
        pool_dt = torch.int8 if self._qkv else d_dt

        def pools():
            kv = [torch.zeros(hk, self._d_num_pages, self.page_size, hd,
                              dtype=pool_dt, device=self.device)
                  for _ in range(2)]
            if self._qkv:
                kv += [torch.zeros(self._d_num_pages, self.page_size,
                                   dtype=torch.float32, device=self.device)
                       for _ in range(2)]
            return tuple(kv)
        self._d_kv = [pools() for _ in range(d_cfg.num_hidden_layers)]
        self._d_bt = np.zeros((self.B, self.pps), np.int32)
        self._d_free: List[int] = list(range(1, self._d_num_pages))
        self._d_slot_pages: List[List[int]] = [[] for _ in range(self.B)]
        self._d_next_idx = np.zeros(self.B, np.int64)
        self._d_valid = np.zeros(self.B, bool)
        # the verify pass packs k + 1 live rows a slot: exactly on the
        # CPU (the plain attention takes any alignment), in the kernel's
        # 8-row q blocks on the card (the tensor-core route's block)
        self._verify_block_q = self._ragged_block_q \
            if self.device.type == "cuda" else self._spec_k + 1

    # -- public API ----------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int = 32,
                    deadline: Optional[float] = None,
                    max_queue_time: Optional[float] = None,
                    request_id: Optional[str] = None,
                    priority: int = 0, adapter: Optional[str] = None
                    ) -> int:
        """Queue a request; returns its engine-local id. ``deadline`` is
        a completion budget in seconds from now on the engine's clock
        (default: the engine's ``request_timeout``); ``max_queue_time``
        bounds the time spent waiting for a slot (default: the
        engine's). An expired request finalizes with status ``timeout``
        at the next step. ``priority`` is the queue class (lower admits
        first, FIFO within a class). ``adapter`` decodes the request
        under a resident LoRA adapter (`install_adapter`); one that is
        not resident raises ModelMismatch before anything is queued.
        Raises EngineOverloaded when the bounded queue is full
        (`max_waiting`) or the admission policy rejects the request."""
        toks = [int(t) for t in np.asarray(prompt).ravel()]
        if not toks:
            raise ValueError("empty prompt")
        if adapter is not None and adapter not in self._adapter_rows:
            _M_MODEL_MISMATCH.inc(kind="adapter")
            raise ModelMismatch(
                f"adapter {adapter!r} is not resident in this engine "
                f"(resident: {sorted(self._adapter_rows)}) — "
                "install_adapter it first (the fleet model store does "
                "this before dispatch)")
        if int(max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(toks) >= self.S:
            raise ValueError(
                f"prompt length {len(toks)} does not fit max_seq_len "
                f"{self.S} (need at least one decode position)")
        if self.max_waiting is not None \
                and len(self._queue) >= self.max_waiting:
            _M_REJECTIONS.inc(reason="queue_full")
            raise EngineOverloaded(
                f"admission queue full ({self.max_waiting} waiting) — "
                "shed load or retry after in-flight requests drain")
        now = self._clock()
        budget = deadline if deadline is not None else self.request_timeout
        r = Request(self._next_rid, toks, int(max_new_tokens),
                    enqueue_time=now, arrival_time=now,
                    request_id=request_id if request_id is not None
                    else str(self._next_rid), priority=int(priority),
                    adapter=adapter,
                    deadline=None if budget is None else now + budget,
                    max_queue_time=max_queue_time
                    if max_queue_time is not None else self.max_queue_time)
        if self.layout == "paged" \
                and self._worst_pages(r) > self.num_pages - 1:
            raise ValueError(
                f"request needs up to {self._worst_pages(r)} KV pages "
                f"(prompt {len(toks)} + max_new_tokens {max_new_tokens} at "
                f"page_size {self.page_size}) but the pool has only "
                f"{self.num_pages - 1} usable pages; raise num_pages")
        if self.admission_policy is not None \
                and not self.admission_policy(self, r):
            _M_REJECTIONS.inc(reason="policy")
            raise EngineOverloaded(
                f"admission policy rejected request (prompt {len(toks)} "
                f"tokens, max_new_tokens {max_new_tokens})")
        self._next_rid += 1
        idx = len(self._queue)
        while idx > 0 and self._queue[idx - 1].priority > r.priority:
            idx -= 1
        self._queue.insert(idx, r)
        _M_QUEUE_DEPTH.set(len(self._queue))
        return r.rid

    def run(self) -> Dict[int, List[int]]:
        """Drive until every queued request completes; returns
        {request id: generated tokens}."""
        results: Dict[int, List[int]] = {}
        while self._queue or any(r is not None for r in self._slot_req):
            for r in self.step():
                results[r.rid] = r.output
        return results

    def step(self) -> List[Request]:
        """Expire requests past their deadline or queue-time budget,
        admit waiting requests into free slots (one ragged dispatch per
        admission batch; legacy: one prefill dispatch per request),
        decode ONE token for every active slot (one dispatch), release
        finished slots. Returns the requests that reached a terminal
        state this step (finished, timeout, failed or preempted: see
        ``status``).

        Pipelined (``harvest_every`` = k > 1): a due window is
        harvested FIRST, before expiry, admission and the next dispatch,
        so that each of them acts on committed tokens as the
        synchronous loop would; the decode dispatch then leaves its
        tokens on the device.

        ≙ :1400-1489 with its decode retry: a `FaultError` out of the
        decode step (``serving.decode`` fires before the dispatch, and
        before the sampling key advances) leaves slot and page state
        consistent, so the step returns and the next one retries; past
        ``max_decode_retries`` consecutive faults it raises. With
        telemetry on, the step's wall is split into the
        `profile.COMPONENTS` (`note_round`), as the JAX engine splits
        it."""
        finished = self._finished_backlog
        self._finished_backlog = []
        prof = telemetry.enabled()
        try:
            if self._pending and self._harvest_due():
                self._harvest_pending(finished)
            p0 = time.perf_counter() if prof else 0.0
            finished += self._expire()
            finished += self._admit_ragged() if self.attn_impl == "ragged" \
                else self._admit_legacy()
            active = any(r is not None for r in self._slot_req)
            if prof:
                _profile.note_round("host", time.perf_counter() - p0)
            if active:
                try:
                    # starvation-guard finalizations land in `finished`
                    # before the dispatch, so they survive a fault
                    self._decode(finished)
                except FaultError:
                    self.num_decode_retries += 1
                    _M_DECODE_RETRIES.inc()
                    self._consec_decode_faults += 1
                    if self._consec_decode_faults > self.max_decode_retries:
                        raise
                    if _invariants_enabled():
                        self._check_invariants()
                    self._update_telemetry_gauges()
                    return finished
                self._consec_decode_faults = 0
        except BaseException:
            # requests finalized this step are delivered by the next one
            self._finished_backlog = finished
            raise
        p1 = time.perf_counter() if prof else 0.0
        if _invariants_enabled():
            self._check_invariants()      # mid-window: no quiesce
        self._update_telemetry_gauges()
        if prof:
            _profile.note_round("host", time.perf_counter() - p1)
        return finished

    def _update_telemetry_gauges(self):
        """≙ :1490-1501: the point-in-time gauges, once a step (queue
        depth, running slots, page occupancy)."""
        if not telemetry.enabled():
            return
        _M_QUEUE_DEPTH.set(len(self._queue))
        _M_RUNNING.set(sum(r is not None for r in self._slot_req))
        if self.layout == "paged":
            usable = self.num_pages - 1
            in_use = usable - len(self._free)
            _M_PAGES_IN_USE.set(in_use)
            _M_PAGE_OCCUPANCY.set(in_use / max(usable, 1))

    def lifecycle_info(self) -> Dict[str, int]:
        """Queue depth and the robustness counters, keyed as the JAX
        engine's."""
        return {"waiting": len(self._queue),
                "running": sum(r is not None for r in self._slot_req),
                "timeouts": self.num_timeouts,
                "failures": self.num_failures,
                "preemptions": self.num_preemptions,
                "decode_retries": self.num_decode_retries}

    def get_request(self, rid: int) -> Optional[Request]:
        """≙ :1513: the live (queued or running) Request with engine-local
        id ``rid``, or None once it reached a terminal state (or left by
        `evict_request`)."""
        for req in self._queue:
            if req.rid == rid:
                return req
        for req in self._slot_req:
            if req is not None and req.rid == rid:
                return req
        return None

    @property
    def num_dispatches(self) -> int:
        return self.num_admission_dispatches + self.num_decode_dispatches

    def cache_memory_info(self) -> Dict[str, object]:
        """KV-cache device-memory accounting of the page pools:
        ``bytes_in_use`` is proportional to the pages allocated (prefix
        cache pages included). With int8 pages ``page_bytes`` is the
        honest bill of one page across all layers: int8 storage plus the
        f32 scale rows of both pools. With prefix caching on it adds the
        trie's size, its hits and the prompt tokens they reused. The
        dense layout's caches are all in use from the start."""
        L, hk, hd, dt = self._kv_shape
        if self.layout == "dense":
            itemsize = torch.empty((), dtype=dt).element_size()
            total = self.B * self.S * hk * hd * itemsize * 2 * L
            return {"layout": "dense", "bytes_pool": total,
                    "bytes_in_use": total, "utilization": 1.0}
        if self._qkv:
            page_bytes = self.page_size * hk * hd * 2 * L \
                + self.page_size * 4 * 2 * L
        else:
            itemsize = torch.empty((), dtype=dt).element_size()
            page_bytes = self.page_size * hk * hd * itemsize * 2 * L
        usable = self.num_pages - 1
        in_use = usable - len(self._free)
        info = {"layout": "paged", "page_bytes": page_bytes,
                "kv_quant": self._qkv,
                "total_pages": usable, "pages_in_use": in_use,
                "bytes_pool": self.num_pages * page_bytes,
                "bytes_in_use": in_use * page_bytes,
                "utilization": in_use / max(usable, 1)}
        if self._prefix_enabled:
            cached = {n["page"] for n in self._prefix_nodes.values()}
            info.update(prefix_entries=len(self._prefix_nodes),
                        prefix_pages=len(cached),
                        prefix_hits=self.prefix_hits,
                        prefix_tokens_reused=self.prefix_tokens_reused)
        return info

    # -- quantized weights ---------------------------------------------
    def _build_quant_weights(self) -> Dict[str, QuantizedWeight]:
        """Quantize the `QUANT_MATMULS` weights once at engine build:
        {parameter name: `QuantizedWeight`} (int8 / fp8 storage and one
        f32 scale per output channel). The model object is never
        changed."""
        with torch.no_grad():
            return {name: QuantizedWeight(*quantize_weight_values(
                        p, self._qw_mode))
                    for name, p in self.model.named_parameters()
                    if p.ndim == 2
                    and any(k in name.lower() for k in QUANT_MATMULS)}

    # -- multi-model serving -------------------------------------------
    @property
    def lora_adapters_resident(self) -> int:
        """Adapters resident in the stacks (row 0 excluded): the JAX
        engine's ``pdt_lora_adapters_resident`` gauge."""
        return len(self._adapter_rows)

    @property
    def lora_adapter_bytes(self) -> int:
        """Bytes of the adapter stacks (A + B + row scales) across every
        adapted matmul: the ``pdt_lora_adapter_bytes`` gauge."""
        return self._lora_nbytes()

    def install_adapter(self, adapter_id: str, deltas: dict,
                        scale: float = 1.0) -> None:
        """Install one LoRA adapter into the stacked adapter tensors
        (batched multi-LoRA decode, `ops.lora_epilogue`). ``deltas``
        maps adapted parameter names (`named_parameters` keys of Linear
        weights) to ``(A, B)`` pairs, numpy arrays or tensors, in the
        JAX package's convention: A (K, r) and B (r, N) over the (K, N)
        product, applied as ``x @ W + scale·(x@A)@B`` — the port stores
        the weight itself (N, K).

        Safe mid-flight: a new row never changes existing rows, and a
        token reads only its own row. Every adapter in an engine must
        adapt the SAME parameter set at the SAME rank (the fleet store
        pads ranks to its ``max_rank``). Transactional: the new stacks
        are built in full, in the model's dtype, before any engine
        state changes. Requires the ragged dispatch; refuses to compose
        with prefix caching, ``spec_decode`` and ``prefill_chunk``, as
        the JAX engine does. Drains a pipelined window first and drops
        every program (their graphs read the old stacks)."""
        self.quiesce()
        if self.attn_impl != "ragged":
            raise ValueError(
                "install_adapter requires kv_layout='paged' with "
                "attention_impl='ragged' — the per-token adapter-row "
                "vector threads through the ragged dispatch family only")
        if self._prefix_enabled:
            raise ValueError(
                "install_adapter refuses to compose with prefix "
                "caching: cached KV pages are a function of the "
                "weights, so a shared trie would alias KV across "
                "adapters — build the engine with "
                "enable_prefix_caching=False to serve multi-LoRA")
        if self._spec is not None:
            raise ValueError(
                "install_adapter does not compose with spec_decode (the "
                "draft cache's rewind bookkeeping has no per-adapter "
                "dimension)")
        if self._chunk is not None:
            raise ValueError(
                "install_adapter does not compose with prefill_chunk (the "
                "chunk program does not thread the per-token adapter-row "
                "vector)")
        if adapter_id in self._adapter_rows:
            raise ValueError(f"adapter {adapter_id!r} already resident")
        if not deltas:
            raise ValueError("install_adapter with empty deltas")
        names = self._params
        rank = None
        prepared = {}
        for nm, (a, b) in sorted(deltas.items()):
            p = names.get(nm)
            if p is None:
                raise ValueError(f"adapter {adapter_id!r} targets unknown "
                                 f"parameter {nm!r}")
            if p.ndim != 2 or "embed_tokens" in nm:
                raise ValueError(
                    f"adapter {adapter_id!r} targets non-matmul parameter "
                    f"{nm!r} (the embedding lookup is a gather)")
            a, b = torch.as_tensor(a), torch.as_tensor(b)
            n, k = p.shape
            if a.ndim != 2 or b.ndim != 2 or a.shape[0] != k \
                    or b.shape[1] != n or a.shape[1] != b.shape[0]:
                raise ValueError(
                    f"adapter {adapter_id!r} delta for {nm!r}: A "
                    f"{tuple(a.shape)} / B {tuple(b.shape)} do not factor "
                    f"the ({k}, {n}) base")
            if rank is None:
                rank = int(a.shape[1])
            elif int(a.shape[1]) != rank:
                raise ValueError(
                    f"adapter {adapter_id!r} mixes ranks ({rank} vs "
                    f"{a.shape[1]} at {nm!r}) — one rank per adapter (the "
                    "store pads to max_rank)")
            prepared[nm] = (a, b)
        lo = self._lora
        if lo is not None:
            if tuple(sorted(prepared)) != lo["names"]:
                raise ValueError(
                    f"adapter {adapter_id!r} adapts {sorted(prepared)} but "
                    f"resident adapters adapt {list(lo['names'])} — every "
                    "adapter in an engine must adapt the same parameter "
                    "set (pad missing targets with zero deltas)")
            if rank != lo["rank"]:
                raise ValueError(
                    f"adapter {adapter_id!r} rank {rank} != resident rank "
                    f"{lo['rank']} — the store pads every adapter to one "
                    "fixed max_rank")
        dt = names[next(iter(prepared))].dtype
        dev = self.device
        # build the new stacks FULLY before committing any state
        if lo is None:
            row = 1
            new_a, new_b = {}, {}
            for nm, (a, b) in prepared.items():
                za = torch.zeros((2,) + tuple(a.shape), dtype=dt, device=dev)
                zb = torch.zeros((2,) + tuple(b.shape), dtype=dt, device=dev)
                za[1] = a.to(dev, dt)
                zb[1] = b.to(dev, dt)
                new_a[nm], new_b[nm] = za, zb
            new_scale = torch.tensor([0.0, float(scale)],
                                     dtype=torch.float32, device=dev)
            committed = {"rank": rank, "names": tuple(sorted(prepared)),
                         "a": new_a, "b": new_b, "scale": new_scale}
        else:
            grow = not self._lora_free_rows
            row = int(lo["scale"].shape[0]) if grow \
                else self._lora_free_rows[-1]
            new_a, new_b = {}, {}
            for nm in lo["names"]:
                a, b = prepared[nm]
                sa, sb = lo["a"][nm], lo["b"][nm]
                if grow:
                    sa = torch.cat([sa, a.to(dev, dt)[None]])
                    sb = torch.cat([sb, b.to(dev, dt)[None]])
                else:
                    sa, sb = sa.clone(), sb.clone()
                    sa[row] = a.to(dev, dt)
                    sb[row] = b.to(dev, dt)
                new_a[nm], new_b[nm] = sa, sb
            new_scale = lo["scale"].clone()
            if grow:
                new_scale = torch.cat([new_scale, new_scale.new_full(
                    (1,), float(scale))])
            else:
                new_scale[row] = float(scale)
            committed = dict(lo, a=new_a, b=new_b, scale=new_scale)
        # commit
        if lo is not None and self._lora_free_rows:
            self._lora_free_rows.pop()
        self._lora = committed
        self._adapter_rows[adapter_id] = row
        self.lora_installs += 1
        _M_LORA_INSTALLS.inc()
        _M_LORA_RESIDENT.set(len(self._adapter_rows))
        _M_LORA_BYTES.set(self._lora_nbytes())
        self._drop_programs()
        if _invariants_enabled():
            self.check_invariants()

    def evict_adapter(self, adapter_id: str) -> None:
        """Evict a resident adapter: its stack row is zeroed in place
        and returns to the free-row list (stacks never shrink; a zeroed
        row is inert by the row-0 argument). REFUSES while any queued or
        running request decodes under the adapter, so an eviction never
        strands a request. Dropping the last adapter drops the stacks,
        and dispatches return to the unadapted weights. Drains a
        pipelined window first, so that a request whose last token is
        still on the device no longer counts as in flight; drops every
        program on success."""
        self.quiesce()
        row = self._adapter_rows.get(adapter_id)
        if row is None:
            raise ValueError(f"adapter {adapter_id!r} is not resident")
        live = [r.request_id for r in
                list(self._queue) + [q for q in self._slot_req
                                     if q is not None]
                if r.adapter == adapter_id]
        if live:
            raise ValueError(
                f"adapter {adapter_id!r} is in flight (requests {live}) — "
                "evicting it would strand them; drain or migrate first")
        del self._adapter_rows[adapter_id]
        if not self._adapter_rows:
            self._lora = None
            self._lora_free_rows = []
        else:
            lo = self._lora
            for nm in lo["names"]:
                lo["a"][nm][row] = 0
                lo["b"][nm][row] = 0
            lo["scale"][row] = 0.0
            self._lora_free_rows.append(row)
        self.lora_evictions += 1
        _M_LORA_EVICTIONS.inc()
        _M_LORA_RESIDENT.set(len(self._adapter_rows))
        _M_LORA_BYTES.set(self._lora_nbytes())
        self._drop_programs()
        if _invariants_enabled():
            self.check_invariants()

    def _lora_nbytes(self) -> int:
        lo = self._lora
        if lo is None:
            return 0
        n = lo["scale"].numel() * lo["scale"].element_size()
        for nm in lo["names"]:
            for t in (lo["a"][nm], lo["b"][nm]):
                n += t.numel() * t.element_size()
        return n

    def _require_idle(self, what: str):
        self.quiesce()
        if self._queue or any(r is not None for r in self._slot_req):
            raise ValueError(
                f"{what} on a busy engine: resident KV pages are a "
                "function of the weights — drain or migrate in-flight "
                "requests first")

    def _drop_adapters(self):
        self._lora = None
        self._adapter_rows = {}
        self._lora_free_rows = []
        self._slot_adapter[:] = 0
        _M_LORA_RESIDENT.set(0)
        _M_LORA_BYTES.set(0)

    def install_weights(self, values: dict, tag: str) -> None:
        """Swap the engine's dispatch weights to another checkpoint of
        the same shapes (a fleet store cold install): ``values`` maps
        EVERY named parameter to its new value in the port's layout
        (`models.convert.llama_state_from_numpy` gives one from a JAX
        state dict) — a tensor or numpy array (cast to the parameter's
        dtype and device; quantized on the fly under ``quant=`` weights
        for the `QUANT_MATMULS`) or a pre-quantized `QuantizedWeight`.
        The model object is not changed: every dispatch reads the new
        values through its ``weights`` mapping, so `reset_weights` can
        return to the build-time weights. Stamps ``model_tag``.
        IDLE-ONLY, since every resident KV page is a function of the
        weights; refuses to compose with prefix caching for the same
        reason (the trie outlives requests). Resident adapters drop with
        the base they adapted, and so does every program (its graph
        reads the old weights by address)."""
        self._require_idle("install_weights")
        if self._prefix_enabled:
            raise ValueError(
                "install_weights refuses to compose with prefix "
                "caching: the trie's cached KV pages were produced "
                "under the OLD weights and would silently poison "
                "future prefills")
        named = list(self.model.named_parameters())
        missing = [nm for nm, _ in named if nm not in values]
        if missing:
            raise ValueError(
                f"install_weights({tag!r}): checkpoint is missing "
                f"{len(missing)} parameters (first: {missing[:3]}) — full "
                "checkpoints only; use install_adapter for deltas")
        out = {}
        with torch.no_grad():
            for nm, p in named:
                v = values[nm]
                if isinstance(v, QuantizedWeight):
                    if tuple(v.qw.shape) != tuple(p.shape):
                        raise ValueError(
                            f"install_weights({tag!r}): {nm!r} shape "
                            f"{tuple(v.qw.shape)} != engine "
                            f"{tuple(p.shape)}")
                    w = QuantizedWeight(v.qw.to(self.device),
                                        v.scale.to(self.device))
                else:
                    v = torch.as_tensor(v)
                    if tuple(v.shape) != tuple(p.shape):
                        raise ValueError(
                            f"install_weights({tag!r}): {nm!r} shape "
                            f"{tuple(v.shape)} != engine {tuple(p.shape)}")
                    w = v.to(self.device, p.dtype)
                    if self._qw_mode is not None and w.ndim == 2 \
                            and any(k in nm.lower() for k in QUANT_MATMULS):
                        w = QuantizedWeight(*quantize_weight_values(
                            w, self._qw_mode))
                out[nm] = w
        # commit: the value mapping swaps at once; adapters over the old
        # base die with it
        self._mpv = out
        self.model_tag = str(tag)
        self._drop_adapters()
        self._drop_programs()

    def reset_weights(self) -> None:
        """Drop an install_weights override: dispatches return to the
        build-time weights (``model_tag`` None). Idle-only, like
        install_weights, and for the same reason; drops every
        program."""
        self._require_idle("reset_weights")
        self._mpv = None
        self.model_tag = None
        self._drop_adapters()
        self._drop_programs()

    def _adapter_row(self, req: Request) -> int:
        if req.adapter is None:
            return 0
        row = self._adapter_rows.get(req.adapter)
        if row is None:       # evict_adapter refuses while referenced
            raise ModelMismatch(
                f"request {req.request_id!r} decodes under adapter "
                f"{req.adapter!r} which is no longer resident")
        return row

    def _dispatch_weights(self, adapter_ids=None):
        """The ``weights`` mapping of one dispatch: the install_weights
        override when another checkpoint is hosted, else the quantized
        weights of a quantized engine, else None (the model's own); each
        adapted matmul's value wrapped in a `LoraWeight` carrying
        ``adapter_ids``, the dispatch's adapter row per packed token,
        when adapters are resident."""
        weights = self._mpv if self._mpv is not None else self._qweights
        lo = self._lora
        if lo is None:
            return weights
        out = dict(weights or {})
        for nm in lo["names"]:
            out[nm] = LoraWeight(out.get(nm, self._params[nm]), lo["a"][nm],
                                 lo["b"][nm], lo["scale"], adapter_ids)
        return out

    # -- migration (serving/transfer.py, serving/prefix_store.py) -------
    def _resident_slot(self, rid: int) -> int:
        for i, r in enumerate(self._slot_req):
            if r is not None and r.rid == rid:
                return i
        raise ValueError(f"no resident request with rid {rid} (queued "
                         "or terminal requests hold no pages)")

    def _pool_dtype(self) -> torch.dtype:
        return torch.int8 if self._qkv else self._kv_shape[3]

    def export_pages(self, rid: int) -> dict:
        """≙ :1586: serialize a RUNNING request's resident KV pages and
        request state for migration into another engine. Read-only: the
        request keeps running here until `evict_request`. Drains a
        pipelined window first, so that the payload holds every token the
        device made. The payload's ``kv`` is one (k, v) pair of CPU
        tensors a layer, (HK, n_pages, page_size, D) over the slot's live
        block-table window [freed, next index), in the pool dtype; under
        int8 KV ``kv_scales`` holds each layer's (n_pages, page_size) f32
        scale rows. Every layer's pages are gathered on the device into
        one buffer and cross to the host in one copy (the scales in a
        second). ``kv_sha256`` / ``scales_sha256`` are the manifest
        `verify_payload` checks; the keys and their meanings are the JAX
        engine's (``tp`` 1, ``kv_shards`` None)."""
        if self.layout != "paged":
            raise ValueError("export_pages requires the paged layout")
        self.quiesce()
        slot = self._resident_slot(rid)
        req = self._slot_req[slot]
        freed = int(self._slot_freed[slot])
        n_idx = int(self._slot_next_idx[slot])
        L, hk, hd, _ = self._kv_shape
        now = self._clock()
        pages = torch.as_tensor(self._bt[slot, freed:n_idx].astype(np.int64),
                                device=self.device)
        n = int(pages.numel())
        cuda = self.device.type == "cuda"
        with torch.no_grad():
            dev = torch.empty(2 * L, hk, n, self.page_size, hd,
                              dtype=self._pool_dtype(), device=self.device)
            for li, e in enumerate(self._kv):
                torch.index_select(e[0], 1, pages, out=dev[2 * li])
                torch.index_select(e[1], 1, pages, out=dev[2 * li + 1])
            host = self._to_host(dev)
            kv = [(host[2 * li], host[2 * li + 1]) for li in range(L)]
            kv_scales = None
            if self._qkv:
                sh = self._to_host(torch.stack([e[j][pages] for e in self._kv
                                                for j in (2, 3)]))
                kv_scales = [(sh[2 * li], sh[2 * li + 1]) for li in range(L)]
            if cuda:
                torch.cuda.current_stream(self.device).synchronize()
        payload_kv = {"kv": kv, "kv_shards": None, "kv_scales": kv_scales}
        return {
            "request_id": req.request_id,
            "prompt": list(req.prompt),
            "output": list(req.output),
            "max_new_tokens": req.max_new_tokens,
            "model_tag": self.model_tag,
            "adapter": req.adapter,
            "deadline_remaining": None if req.deadline is None
            else req.deadline - now,
            # ages, not absolutes: the target rebases them on its clock
            "first_token_age": None if req.first_token_time is None
            else now - req.first_token_time,
            "preemptions": req.preemptions,
            "priority": req.priority,
            "ctx": int(self._pos[slot]),
            "last_token": int(self._tok[slot]),
            "freed": freed,
            "n_pages": n_idx - freed,
            "page_size": self.page_size,
            "max_seq_len": self.S,
            "kv_spec": (L, hk, hd, _dtype_name(self._pool_dtype())),
            "kv": kv,
            "kv_shards": None,
            "kv_scales": kv_scales,
            "kv_quant": self._qkv,
            "kv_sha256": payload_checksums(payload_kv),
            "scales_sha256": payload_scale_checksums(payload_kv),
            "tp": 1,
        }

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` itself on the CPU; on the card a copy into pinned host
        memory, made without waiting (the caller synchronizes)."""
        if self.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    def import_pages(self, payload: dict,
                     deadline: Optional[float] = None) -> Request:
        """≙ :1682: install a serialized request (an `export_pages`
        payload, this package's or the JAX package's) into this engine:
        claim a free slot, attach any prompt prefix this engine's own
        trie holds read-only, allocate the remaining pages and write
        their contents through the install program (`_install_kv`), then
        register the installed chain in the prefix cache. ``deadline``
        (seconds from now on this engine's clock) overrides the payload's
        remaining budget. Refuses, before any mutation and in this
        order: a cross-quant-mode payload (`QuantMismatch`), a payload of
        another hosted model or of an adapter not resident here
        (`ModelMismatch`), another geometry or page size or a context
        past ``max_seq_len`` (ValueError), no free slot
        (`EngineOverloaded`), then a payload whose bytes fail their
        manifest (`PayloadCorruption`). Raises PoolExhausted when the
        worst-case pages cannot be reserved. Transactional: a failure
        after the slot is claimed backs it out. A spec engine's imported
        slot has no draft cache: its next round backfills it from the
        migrated stream."""
        if self.layout != "paged":
            raise ValueError("import_pages requires the paged layout")
        # a window's device token ring has no entry for a slot installed
        # mid-window
        self.quiesce()
        pq = payload.get("kv_quant")
        if pq != self._qkv:
            _M_QUANT_MISMATCH.inc(kind="import")
            raise QuantMismatch(
                f"cross-quant-mode migration refused: payload KV is "
                f"{pq or 'full-width'}, this engine serves "
                f"{self._qkv or 'full-width'} pages — fleets must be "
                "quant-homogeneous")
        ptag = payload.get("model_tag")
        if ptag != self.model_tag:
            _M_MODEL_MISMATCH.inc(kind="import")
            raise ModelMismatch(
                f"cross-model migration refused: payload KV was "
                f"produced under model {ptag or 'base'!r}, this "
                f"engine hosts {self.model_tag or 'base'!r} — the "
                "fleet store installs the model before routing here")
        pad = payload.get("adapter")
        if pad is not None and pad not in self._adapter_rows:
            _M_MODEL_MISMATCH.inc(kind="adapter")
            raise ModelMismatch(
                f"migration payload decodes under adapter {pad!r} "
                "which is not resident in this engine — the fleet "
                "store installs adapters before routing here")
        L, hk, hd, _ = self._kv_shape
        spec = tuple(payload["kv_spec"])
        mine = (L, hk, hd, _dtype_name(self._pool_dtype()))
        if spec != mine:
            raise ValueError(f"kv geometry mismatch: payload {spec} vs "
                             f"engine {mine}")
        if payload["page_size"] != self.page_size:
            raise ValueError(
                f"page_size mismatch: payload {payload['page_size']} "
                f"vs engine {self.page_size}")
        ctx = int(payload["ctx"])
        if ctx >= self.S:
            raise ValueError(f"context {ctx} does not fit max_seq_len "
                             f"{self.S}")
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        if not free:
            raise EngineOverloaded("no free slot for a migration "
                                   "import — retry after a step")
        # after the free-slot check: a deferred migration retries every
        # tick, and hashing the payload per deferral would be wasted
        verify_payload(payload)
        now = self._clock()
        budget = payload["deadline_remaining"] if deadline is None \
            else deadline
        output = [int(t) for t in payload["output"]]
        req = Request(self._next_rid, [int(t) for t in payload["prompt"]],
                      int(payload["max_new_tokens"]), output=output,
                      status=RequestStatus.RUNNING,
                      deadline=None if budget is None else now + budget,
                      enqueue_time=now, arrival_time=now,
                      preemptions=int(payload.get("preemptions", 0)),
                      first_token_time=None
                      if payload.get("first_token_age") is None
                      else now - payload["first_token_age"],
                      request_id=payload["request_id"],
                      priority=int(payload.get("priority", 0)),
                      adapter=pad, device_len=len(output))
        freed = int(payload["freed"])
        shared = None
        if self._prefix_enabled and not freed:
            shared = self._match_prefix(req.prompt)
            for p in shared or ():
                self._incref(p)            # pin across _reserve_ok
        # any exit without a reservation, a refusal or a raise, unpins
        ok = False
        try:
            ok = self._reserve_ok(req, len(shared) if shared else 0)
        finally:
            if not ok:
                for p in shared or ():
                    self._decref(p)
        if not ok:
            raise PoolExhausted(
                "migration import cannot reserve worst-case pages — "
                "retry after running requests release")
        slot = free[0]
        self._slot_req[slot] = req
        self._slot_adapter[slot] = self._adapter_row(req)
        self._slot_seq[slot] = self._admit_seq
        self._admit_seq += 1
        self._next_rid += 1
        try:
            m = 0
            try:
                if shared:
                    self._attach_shared(slot, shared)
                    m = len(shared)
            finally:
                for p in shared or ():
                    self._decref(p)        # unpin: the slot holds refs
            if freed:
                # a window engine's slid-out leading pages stay
                # trash-routed on the target too
                self._slot_next_idx[slot] = freed
                self._slot_freed[slot] = freed
            self._slot_reserved[slot] = self._worst_pages(req)
            n_total = freed + int(payload["n_pages"])
            while int(self._slot_next_idx[slot]) < n_total:
                self._alloc_page(slot)
            start = m if m else freed
            ids = [int(self._bt[slot, j]) for j in range(start, n_total)]
            off = start - freed
            scale_rows = None
            if self._qkv:
                scale_rows = [(_host_tensor(ks)[off:], _host_tensor(vs)[off:])
                              for ks, vs in payload["kv_scales"]]
            self._install_kv(ids, [(_host_tensor(kp)[:, off:],
                                    _host_tensor(vp)[:, off:])
                                   for kp, vp in assemble_payload_kv(payload)],
                             scale_rows)
            if self._prefix_enabled and not freed:
                self._register_prefix(slot, req)
            if shared:
                self.prefix_hits += 1
                self.prefix_tokens_reused += m * self.page_size
        except BaseException:
            self._release_slot(slot, register=False)
            raise
        self._pos[slot] = ctx
        self._tok[slot] = int(payload["last_token"])
        if _invariants_enabled():
            self._check_invariants()
        return req

    def evict_request(self, rid: int) -> Request:
        """≙ :1855: detach a live request without a terminal transition,
        the migration hand-off (its pages now live in another engine). A
        running slot is released as a finished request's is (its prompt's
        full pages enter the prefix cache); a queued request leaves the
        queue. Terminal counters are untouched: the request finishes,
        once, wherever it lands."""
        self.quiesce()          # hand off committed state only
        for i, r in enumerate(self._slot_req):
            if r is not None and r.rid == rid:
                self._release_slot(i)
                return r
        for i, r in enumerate(self._queue):
            if r.rid == rid:
                self._queue.pop(i)
                return r
        raise ValueError(f"no live request with rid {rid}")

    def import_prefix(self, pages_tokens: List[List[int]], kv_rows,
                      kv_scales=None) -> int:
        """≙ :1874: install an externally held prefix chain (the fleet
        prefix store's host spill, `serving.prefix_store`) into this
        engine's prefix cache. ``pages_tokens`` are FULL-page token lists
        forming one chain from position 0, ``kv_rows`` each layer's (k,
        v) page contents, (HK, n, page_size, D), and under int8 KV
        ``kv_scales`` each layer's (n, page_size) scale rows. Pages the
        trie holds are skipped; the missing ones (always a suffix of the
        chain) take only genuinely free pages, so the restore never
        evicts a resident chain nor changes the trie mid-build; the
        entry budget is applied after the content lands. Returns the
        pages installed (0 without prefix caching, when the chain is
        resident, or when nothing is free). A chain of the other quant
        mode is refused with `QuantMismatch`."""
        if self.layout != "paged" or not self._prefix_enabled:
            return 0
        if (kv_scales is None) == bool(self._qkv):
            _M_QUANT_MISMATCH.inc(kind="prefix")
            raise QuantMismatch(
                f"cross-quant-mode prefix install refused: chain is "
                f"{'quantized' if kv_scales is not None else 'full-width'}"
                f", this engine serves "
                f"{self._qkv or 'full-width'} pages")
        parent, missing_from = None, None
        for f, ptoks in enumerate(pages_tokens):
            if len(ptoks) != self.page_size:
                raise ValueError("import_prefix needs FULL pages "
                                 f"(page {f} has {len(ptoks)} tokens)")
            key = (parent, tuple(int(t) for t in ptoks))
            if missing_from is None and key not in self._prefix_nodes:
                missing_from = f
            parent = key
        if missing_from is None:
            return 0                       # chain already resident
        page_ids, parent = [], None
        for f, ptoks in enumerate(pages_tokens):
            key = (parent, tuple(int(t) for t in ptoks))
            if f < missing_from:
                self._prefix_nodes.move_to_end(key)
                parent = key
                continue
            if not self._free:
                break                      # install what fits for free
            page = self._free.pop()
            self._page_rc[page] = 1        # held by the trie node
            self._prefix_nodes[key] = {"page": page, "parent": parent,
                                       "children": 0}
            if parent is not None:
                self._prefix_nodes[parent]["children"] += 1
            page_ids.append(page)
            parent = key
        if page_ids:
            end = missing_from + len(page_ids)
            self._install_kv(
                page_ids, [(_host_tensor(kp)[:, missing_from:end],
                            _host_tensor(vp)[:, missing_from:end])
                           for kp, vp in kv_rows],
                None if kv_scales is None else
                [(_host_tensor(ks)[missing_from:end],
                  _host_tensor(vs)[missing_from:end])
                 for ks, vs in kv_scales])
        # the entry budget after the content lands: an eviction here can
        # only take a fully installed node
        while len(self._prefix_nodes) > self._max_prefix_entries:
            if not self._evict_one():
                break
        return len(page_ids)

    def _install_staging(self) -> torch.Tensor:
        """The install program's static device staging, made at first
        use: bytes for the (k, v) rows of every layer over ``pps`` pages
        (the most one slot holds) in the pool dtype, then under int8 KV
        their f32 scale rows. An install of n pages uses its first bytes
        (`_staging_views`); at Llama-3-8B width in bf16 it is 128 pages x
        2 MiB = 256 MiB."""
        if self._staging is None:
            self._staging = torch.empty(self._staging_bytes(self.pps),
                                        dtype=torch.uint8, device=self.device)
        return self._staging

    def _staging_bytes(self, n: int) -> int:
        L, hk, hd, _ = self._kv_shape
        item = torch.empty((), dtype=self._pool_dtype()).element_size()
        rows = 2 * L * hk * n * self.page_size * hd * item
        return rows + (2 * L * n * self.page_size * 4 if self._qkv else 0)

    def _staging_views(self, buf: torch.Tensor, n: int):
        """Views of ``buf`` (uint8, at least `_staging_bytes(n)`) in the
        layout of an n-page install: each layer's k and v rows (HK, n,
        page_size, D) in turn, then under int8 KV each layer's k and v
        scale rows (n, page_size). One list a layer."""
        L, hk, hd, _ = self._kv_shape
        ps, dt = self.page_size, self._pool_dtype()
        item = torch.empty((), dtype=dt).element_size()
        e = hk * n * ps * hd * item
        views = [[buf[(2 * li + j) * e:(2 * li + j + 1) * e].view(dt)
                  .view(hk, n, ps, hd) for j in range(2)]
                 for li in range(L)]
        if self._qkv:
            f, at = n * ps * 4, 2 * L * e
            for li in range(L):
                views[li] += [buf[at + (2 * li + j) * f:
                                  at + (2 * li + j + 1) * f]
                              .view(torch.float32).view(n, ps)
                              for j in range(2)]
        return views

    def _install_kv(self, page_ids: List[int], rows, scale_rows=None):
        """≙ `_install_kv` :1950: write transferred page contents into the
        pools. ``rows`` are each layer's (k, v) host rows (HK, n,
        page_size, D) and, under int8 KV, ``scale_rows`` each layer's (k,
        v) (n, page_size) scale rows; the quantized bytes move verbatim,
        never re-quantized. The rows go into one pinned host buffer in
        the staging layout, cross to the device staging in ONE copy, and
        the install program of n pages (`_build_install`) writes them at
        the page ids in its input; counted in `_pool_writes` before it
        runs. More than ``pps`` pages install ``pps`` at a time."""
        for at in range(0, len(page_ids), self.pps):
            part = slice(at, at + self.pps)
            self._install_part(
                page_ids[part], [(k[:, part], v[:, part]) for k, v in rows],
                None if scale_rows is None
                else [(k[part], v[part]) for k, v in scale_rows])

    def _install_part(self, page_ids, rows, scale_rows):
        n = len(page_ids)
        cuda = self.device.type == "cuda"
        staging = self._install_staging()
        host = torch.empty(self._staging_bytes(n), dtype=torch.uint8,
                           pin_memory=cuda)
        srcs = [list(r) + list(sc) for r, sc in
                zip(rows, scale_rows or [()] * len(rows))]
        for views, parts in zip(self._staging_views(host, n), srcs):
            for dst, src in zip(views, parts):
                dst.copy_(src)
        staging[:host.numel()].copy_(host, non_blocking=cuda)
        prog = self._program_lru(self._install_programs, n,
                                 lambda: self._build_install(n), "install")
        self._upload(page_ids, dst=prog.flat)
        self._pool_writes += 1
        self._run_program(prog)

    def _build_install(self, n: int) -> _Program:
        """≙ `_build_install` :1985: the program that writes an n-page
        install from the staging buffer into every layer's pools (and
        scale pools under int8 KV) at the page ids of its flat input (n),
        by `index_copy_`."""
        flat = torch.zeros(n, dtype=torch.int32, device=self.device)
        views = self._staging_views(self._install_staging(), n)
        pools = list(self._kv)

        def body():
            with torch.no_grad():
                idx = flat.long()
                for pool, parts in zip(pools, views):
                    for j, src in enumerate(parts):
                        # (HK, P, page_size, D) pages on dim 1; (P,
                        # page_size) scale rows on dim 0
                        pool[j].index_copy_(1 if j < 2 else 0, idx, src)
                return flat
        return _Program(flat, body)

    # -- invariants ----------------------------------------------------
    def check_invariants(self):
        """Page accounting: every page's refcount equals its holder
        count (the pages a slot owns, the prefix-cache pages it attaches
        and the trie's nodes), the free list is duplicate-free and is
        exactly the rc==0 pages, released slots hold nothing, and each
        active slot's live block-table window points only at allocated
        pages while all else trash-routes to page 0. Drains a pipelined
        window first. Raises EngineInvariantError listing every
        violation. The dense layout has no pages to check."""
        self.quiesce()
        self._check_invariants()

    def _check_invariants(self):
        if self.layout != "paged":
            return
        with _M_INVARIANT_SECONDS.time():
            self._check_invariants_paged()

    def _check_invariants_paged(self):
        errs: List[str] = []
        free = list(self._free)
        free_set = set(free)
        if len(free_set) != len(free):
            errs.append(f"free list has duplicates: {sorted(free)}")
        if 0 in free_set:
            errs.append("reserved trash page 0 is on the free list")
        expected = np.zeros(self.num_pages, np.int64)
        for i, r in enumerate(self._slot_req):
            if r is None and (self._slot_pages[i]
                              or self._slot_shared_pages[i]
                              or np.any(self._bt[i] != 0)):
                errs.append(f"released slot {i} still holds pages "
                            f"{self._slot_pages[i]} shared "
                            f"{self._slot_shared_pages[i]} or a nonzero "
                            "block-table row")
            for p in self._slot_pages[i] + self._slot_shared_pages[i]:
                expected[p] += 1
        for node in self._prefix_nodes.values():
            expected[node["page"]] += 1
        for p in range(1, self.num_pages):
            rc = int(self._page_rc[p])
            if rc != int(expected[p]):
                errs.append(f"page {p}: refcount {rc} != "
                            f"{int(expected[p])} holders (slots + prefix "
                            "nodes)")
            if rc == 0 and p not in free_set:
                errs.append(f"page {p} LEAKED: refcount 0 but absent "
                            "from the free list")
            if rc > 0 and p in free_set:
                errs.append(f"page {p} on the free list with refcount "
                            f"{rc}")
        for i, r in enumerate(self._slot_req):
            if r is None:
                continue
            lo = int(self._slot_freed[i])
            hi = int(self._slot_next_idx[i])
            for j in range(self.pps):
                p = int(self._bt[i, j])
                if lo <= j < hi:
                    if p == 0 or int(self._page_rc[p]) < 1:
                        errs.append(f"slot {i} block-table[{j}] -> page "
                                    f"{p} is not an allocated page")
                elif p != 0:
                    errs.append(f"slot {i} block-table[{j}] = {p} outside "
                                f"the live window [{lo}, {hi}) must "
                                "trash-route to 0")
        self._check_invariants_adapters(errs)
        if self._spec is not None:
            self._check_invariants_draft(errs)
        if errs:
            raise EngineInvariantError(
                "engine invariant violations:\n  " + "\n  ".join(errs))

    def _check_invariants_adapters(self, errs: List[str]):
        """The slot-to-adapter map mirrors slot ownership exactly (a
        stale row would add ANOTHER adapter's delta to this slot's
        stream), adapter rows are distinct, never row 0, inside the
        stacks and off the free-row list."""
        for i, r in enumerate(self._slot_req):
            want = 0
            if r is not None and r.adapter is not None:
                want = self._adapter_rows.get(r.adapter, -1)
            if int(self._slot_adapter[i]) != want:
                errs.append(
                    f"slot {i} adapter row {int(self._slot_adapter[i])} != "
                    f"expected {want} (request "
                    f"{r.request_id if r is not None else None!r})")
        rows = list(self._adapter_rows.values())
        if len(set(rows)) != len(rows) or 0 in rows:
            errs.append(f"adapter row map corrupt (duplicate or reserved "
                        f"row 0): {self._adapter_rows}")
        if self._lora is not None:
            cap = int(self._lora["scale"].shape[0])
            for aid, row in self._adapter_rows.items():
                if not 1 <= row < cap:
                    errs.append(f"adapter {aid!r} row {row} outside the "
                                f"stacks [1, {cap})")
            taken = set(rows) & set(self._lora_free_rows)
            if taken:
                errs.append(f"adapter rows {sorted(taken)} both assigned "
                            "and on the free-row list")
        elif self._adapter_rows:
            errs.append(f"adapter rows {self._adapter_rows} registered but "
                        "no stacks resident")

    def _check_invariants_draft(self, errs: List[str]):
        """Draft-cache page accounting (≙ :2234): draft pages are owned
        by one slot each, with no refcounts and no sharing, so the free
        list and the slots' page lists partition {1..P-1} exactly,
        released slots hold nothing, and each live slot's draft block
        table points only at its own pages below its frontier and at
        trash page 0 past it."""
        free = list(self._d_free)
        free_set = set(free)
        if len(free_set) != len(free):
            errs.append(f"draft free list has duplicates: {sorted(free)}")
        if 0 in free_set:
            errs.append("draft trash page 0 is on the free list")
        owner: Dict[int, int] = {}
        for i, r in enumerate(self._slot_req):
            if r is None and (self._d_slot_pages[i]
                              or np.any(self._d_bt[i] != 0)
                              or self._d_valid[i]):
                errs.append(f"released slot {i} still holds draft pages "
                            f"{self._d_slot_pages[i]} / a nonzero draft "
                            "block-table row / a validity flag")
            for p in self._d_slot_pages[i]:
                if p in owner:
                    errs.append(f"draft page {p} owned by slots "
                                f"{owner[p]} and {i}")
                owner[p] = i
        for p in range(1, self._d_num_pages):
            if (p in owner) == (p in free_set):
                errs.append(f"draft page {p} must be exactly one of "
                            f"owned/free (owned={p in owner}, "
                            f"free={p in free_set})")
        for i, r in enumerate(self._slot_req):
            if r is None:
                continue
            hi = int(self._d_next_idx[i])
            for j in range(self.pps):
                p = int(self._d_bt[i, j])
                if j < hi:
                    if p == 0 or owner.get(p) != i:
                        errs.append(f"slot {i} draft block-table[{j}] -> "
                                    f"page {p} is not a page the slot owns")
                elif p != 0:
                    errs.append(f"slot {i} draft block-table[{j}] = {p} "
                                f"past the frontier {hi} must trash-route "
                                "to 0")

    # -- request lifecycle ---------------------------------------------
    def _finalize(self, req: Request, status: str, error: Optional[str],
                  finished: List[Request]):
        """The one place a request enters a terminal state, so the
        per-status terminal counters reconcile exactly with the requests
        that step() hands back."""
        req.done = True
        req.status = status
        req.error = error
        finished.append(req)
        _M_TERMINAL.inc(status=status)
        if telemetry.enabled():
            n = len(req.output)
            if status == RequestStatus.FINISHED and n >= 2 \
                    and req.first_token_time is not None:
                _M_TPOT.observe((self._clock() - req.first_token_time)
                                / (n - 1))
            telemetry.event("serving.terminal", rid=req.rid,
                            request_id=req.request_id,
                            status=status, tokens=n,
                            preemptions=req.preemptions)

    def _expire(self) -> List[Request]:
        """≙ `_expire` :2002: finalize TIMEOUT the queued requests whose
        deadline or queue-time budget has passed and the running ones
        whose deadline has passed (releasing their slots). One engine
        step is the granularity: a request never decodes past the step
        in which its deadline elapsed."""
        now = self._clock()
        finished: List[Request] = []
        keep: List[Request] = []
        for req in self._queue:
            if (req.deadline is not None and now >= req.deadline) \
                    or (req.max_queue_time is not None
                        and now - req.enqueue_time >= req.max_queue_time):
                self.num_timeouts += 1
                self._finalize(req, RequestStatus.TIMEOUT,
                               "expired while waiting for a slot",
                               finished)
            else:
                keep.append(req)
        self._queue = keep
        for i, req in enumerate(self._slot_req):
            if req is not None and req.deadline is not None \
                    and now >= req.deadline:
                self.num_timeouts += 1
                self._finalize(req, RequestStatus.TIMEOUT,
                               "deadline expired mid-decode", finished)
                self._release_slot(i)
        return finished

    def _effective_prompt(self, req: Request) -> List[int]:
        """What admission prefills: the prompt plus everything already
        generated (a preempted request resumes by re-prefilling)."""
        return req.prompt + req.output if req.output else req.prompt

    def _release_slot(self, slot: int, register: bool = True):
        """Free ``slot``: its prompt's full pages enter the prefix cache
        first (unless ``register`` is False: a failed admission leaves
        garbage KV, which must never be shared), then every page it owns
        or attaches loses the slot's reference."""
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        self._slot_adapter[slot] = 0
        if self.layout != "paged":
            return        # a dense slot's rows are overwritten at admission
        if self._prefix_enabled and req is not None and register:
            # before the decrefs, so the prompt pages never pass through
            # the free list
            self._register_prefix(slot, req)
        for p in self._slot_pages[slot] + self._slot_shared_pages[slot]:
            self._decref(p)
        self._slot_pages[slot] = []
        self._slot_shared_pages[slot] = []
        self._slot_reserved[slot] = 0
        self._slot_next_idx[slot] = 0
        self._slot_freed[slot] = 0
        # inactive slots keep decoding garbage; their block-table row
        # must point at the trash page, not at reclaimed pages
        self._bt[slot] = 0
        if self._spec is not None:
            # the draft cache dies with the slot: a preempted request's
            # next spec round backfills it from the folded stream
            self._d_release(slot)

    def _requeue_or_starve(self, req: Request, finished: List[Request]):
        """Requeue a preempted request at the head of its priority
        class, or finalize it PREEMPTED past `max_preemptions`."""
        self.num_preemptions += 1
        _M_PREEMPTIONS.inc()
        telemetry.event("serving.preempt", rid=req.rid,
                        request_id=req.request_id,
                        preemptions=req.preemptions + 1,
                        tokens=len(req.output))
        req.preemptions += 1
        if req.preemptions > self.max_preemptions:
            self._finalize(req, RequestStatus.PREEMPTED,
                           f"preempted {req.preemptions}x under pool "
                           "pressure (starvation guard)", finished)
            return
        req.status = RequestStatus.QUEUED
        req.enqueue_time = self._clock()
        idx = 0
        while idx < len(self._queue) \
                and self._queue[idx].priority < req.priority:
            idx += 1
        self._queue.insert(idx, req)

    def _preempt_youngest(self, finished: List[Request]) -> Optional[int]:
        """Release the most recently admitted running slot; its request
        re-enters the queue with its tokens folded into the prompt (its
        prompt pages stay in the prefix cache when it is on). Returns
        the released slot, or None if nothing runs."""
        running = [i for i, r in enumerate(self._slot_req)
                   if r is not None]
        if not running:
            return None
        slot = max(running, key=lambda i: int(self._slot_seq[i]))
        req = self._slot_req[slot]
        self._release_slot(slot)
        self._requeue_or_starve(req, finished)
        return slot

    # -- page allocator --------------------------------------------------
    def _worst_pages(self, req: Request) -> int:
        worst_len = min(len(req.prompt) + req.max_new_tokens, self.S)
        return -(-worst_len // self.page_size)

    def _reserve_ok(self, req: Request, shared_pages: int = 0) -> bool:
        """Admit only if the request's worst-case page demand, net of the
        prefix pages it attaches, fits the pool net of the other slots'
        reserved-but-unallocated pages, so lazy growth can never fail
        mid-flight. Evicts prefix-cache entries when that frees
        enough."""
        outstanding = int(sum(
            self._slot_reserved[i] - self._slot_next_idx[i]
            for i, r in enumerate(self._slot_req) if r is not None))
        need = self._worst_pages(req) - shared_pages + outstanding
        return len(self._free) >= need or self._ensure_free(need)

    def _incref(self, page: int):
        self._page_rc[page] += 1

    def _decref(self, page: int):
        self._page_rc[page] -= 1
        if self._page_rc[page] == 0:
            self._free.append(page)

    def _alloc_page(self, slot: int) -> int:
        # chaos drills arm this site (exc=PoolExhausted) to force the
        # preemption path that reservation accounting makes unreachable
        fault_point("serving.alloc_page")
        if not self._free:
            self._ensure_free(1)
        if not self._free:
            raise PoolExhausted(
                f"KV page pool exhausted ({self.num_pages - 1} usable "
                "pages, none free after prefix-cache eviction)")
        page = self._free.pop()
        self._page_rc[page] = 1
        self._slot_pages[slot].append(page)
        self._bt[slot, self._slot_next_idx[slot]] = page
        self._slot_next_idx[slot] += 1
        return page

    def _reserve_and_alloc(self, slot: int, req: Request, p_len: int):
        """Record the slot's worst-case reservation and allocate the
        pages covering the prompt past any attached prefix pages."""
        self._slot_reserved[slot] = self._worst_pages(req)
        while self._slot_next_idx[slot] * self.page_size < p_len:
            self._alloc_page(slot)

    def _pages_bound(self, contexts) -> int:
        """Power-of-two bucketed bound on the pages a dispatch reads:
        the plain attention's gather trim."""
        need = max(-(-int(c) // self.page_size) for c in contexts)
        return min(1 << max(need - 1, 0).bit_length(), self.pps)

    def _grow_slot(self, slot: int, finished: List[Request],
                   extra: int = 0) -> bool:
        """Lazy page growth for `slot`'s next decode write, and ``extra``
        positions past it when a spec round scatters k + 1 rows (within
        the admission reservation: the verify budget is capped at the
        remaining token budget). On pool
        exhaustion (reachable only through an accounting fault, since
        admission reserves the worst case) harvest a pipelined window
        first (the victim keeps every token the device made, and an EOS
        in the window may free the pages), else preempt the youngest
        running request, and retry. Returns False if `slot` itself was
        finalized or preempted."""
        while self._slot_next_idx[slot] * self.page_size \
                <= int(self._pos[slot]) + extra:
            try:
                self._alloc_page(slot)
            except PoolExhausted:
                if self._pending:
                    self._harvest_pending(finished)
                    if self._slot_req[slot] is None:
                        return False
                    continue
                victim = self._preempt_youngest(finished)
                if victim is None:
                    raise
                if victim == slot:
                    return False
        return True

    # -- prefix cache ------------------------------------------------------
    def _evict_one(self) -> bool:
        """Evict the least recently used CHILDLESS trie node (an inner
        node's page must outlive its descendants' references)."""
        for key, node in self._prefix_nodes.items():        # LRU order
            if node["children"] == 0:
                del self._prefix_nodes[key]
                if node["parent"] is not None:
                    self._prefix_nodes[node["parent"]]["children"] -= 1
                self._decref(node["page"])
                return True
        return False

    def _cache_only_pages(self) -> int:
        """Pages whose every reference comes from trie nodes: the most
        that eviction can return to the free list."""
        holds: Dict[int, int] = {}
        for node in self._prefix_nodes.values():
            holds[node["page"]] = holds.get(node["page"], 0) + 1
        return sum(1 for p, n in holds.items() if self._page_rc[p] == n)

    def _ensure_free(self, n: int) -> bool:
        if len(self._free) >= n:
            return True
        # feasibility first: draining the whole cache for a request that
        # still cannot fit would destroy every shared prefix for nothing
        if len(self._free) + self._cache_only_pages() < n:
            return False
        while len(self._free) < n and self._evict_one():
            pass
        return len(self._free) >= n

    def _match_prefix(self, toks: List[int]) -> Optional[List[int]]:
        """The pages of the longest cached full-page prefix of ``toks``,
        capped so that at least one prompt token remains to prefill (its
        logits give the first token) and cut to a power-of-two page
        count, as the JAX engine does (there each distinct shared length
        is a compiled program); None on a miss."""
        max_pages = (len(toks) - 1) // self.page_size
        pages, parent = [], None
        for f in range(max_pages):
            key = (parent, tuple(toks[f * self.page_size:
                                      (f + 1) * self.page_size]))
            node = self._prefix_nodes.get(key)
            if node is None:
                break
            self._prefix_nodes.move_to_end(key)      # most recently used
            pages.append(node["page"])
            parent = key
        if not pages:
            return None
        return pages[:1 << (len(pages).bit_length() - 1)]

    def _register_prefix(self, slot: int, req: Request):
        """Walk or extend the trie along the prompt's full pages, at most
        ``max_prefix_entries`` deep (more nodes than the cache holds
        would only churn it), then evict down to the entry budget."""
        full = min(len(req.prompt) // self.page_size,
                   self._max_prefix_entries)
        parent = None
        for f in range(full):
            key = (parent, tuple(req.prompt[f * self.page_size:
                                            (f + 1) * self.page_size]))
            node = self._prefix_nodes.get(key)
            if node is None:
                page = int(self._bt[slot, f])
                self._incref(page)
                self._prefix_nodes[key] = {"page": page, "parent": parent,
                                           "children": 0}
                if parent is not None:
                    self._prefix_nodes[parent]["children"] += 1
            else:
                self._prefix_nodes.move_to_end(key)
            parent = key
        while len(self._prefix_nodes) > self._max_prefix_entries:
            if not self._evict_one():
                break

    def _attach_shared(self, slot: int, shared: List[int]) -> int:
        """Attach pinned prefix-cache pages read-only to `slot`'s block
        table; returns the shared token length."""
        self._slot_shared_pages[slot] = list(shared)
        for j, p in enumerate(shared):
            self._bt[slot, j] = p
            self._incref(p)
        self._slot_next_idx[slot] = len(shared)
        return len(shared) * self.page_size

    # -- admission -------------------------------------------------------
    def _claim_candidate(self, free):
        """Peek the queue head, match and PIN its cached prefix (before
        the reservation, which may evict the matched chain), check its
        worst-case reservation, claim a slot. Returns (slot, req,
        prompt, shared pages or None) with the prefix still pinned, or
        None when the head must wait for pages (FIFO: stop admitting)."""
        req = self._queue[0]
        prompt = self._effective_prompt(req)
        shared = self._match_prefix(prompt) if self._prefix_enabled \
            else None
        for p in shared or ():
            self._incref(p)
        try:
            ok = self.layout != "paged" or (
                self._reserve_ok(req, len(shared)) if shared
                else self._reserve_ok(req))
        except BaseException:
            for p in shared or ():
                self._decref(p)
            raise
        if not ok:
            for p in shared or ():
                self._decref(p)              # unpin before waiting
            return None
        slot = free.pop(0)
        self._queue.pop(0)
        self._slot_req[slot] = req
        req.status = RequestStatus.RUNNING
        self._slot_adapter[slot] = self._adapter_row(req)
        self._slot_seq[slot] = self._admit_seq
        self._admit_seq += 1
        return slot, req, prompt, shared

    def _admission_pool_exhausted(self, slot, req, free, finished) -> bool:
        """Back out a claimed slot after an admission-time allocation
        failure and requeue (or starve out) its request. Returns True
        when the caller should try the next queued request."""
        self._release_slot(slot, register=False)
        free.insert(0, slot)
        self._requeue_or_starve(req, finished)
        return req.done

    def _admission_failed(self, slot, req, exc, free, finished):
        """≙ :2453: isolate a failed admission: finalize THIS request
        FAILED, free the slot's partial state (its pages never enter the
        prefix cache), keep admitting the rest."""
        self.num_failures += 1
        self._finalize(req, RequestStatus.FAILED,
                       f"{type(exc).__name__}: {exc}", finished)
        self._release_slot(slot, register=False)
        free.insert(0, slot)

    def _admit_ragged(self) -> List[Request]:
        """Collect every admittable request, then prefill them in packed
        ragged dispatches; loop while instant finishes free slots."""
        finished: List[Request] = []
        while True:
            entries = self._collect_ragged_entries(finished)
            if not entries:
                break
            freed = False
            for batch in self._ragged_batches(entries):
                freed |= self._dispatch_ragged(batch, finished)
            if not (freed and self._queue):
                break
        return finished

    def _collect_ragged_entries(self, finished):
        """≙ :2614-2660, the host half of admission: reservation, slot
        and page allocation, prefix-cache attach, per request and before
        any dispatch, so a ``serving.prefill`` fault fails its request
        alone (`_admission_failed`). Returns the entries to pack: a
        prefix hit's entry is the prompt's suffix at offset
        ``shared_len``, whose attention reads the shared pages through
        the block table."""
        entries = []
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        while free and self._queue:
            claim = self._claim_candidate(free)
            if claim is None:
                break
            slot, req, prompt, shared = claim
            shared_len = 0
            try:
                with telemetry.span("serving.prefill", rid=req.rid,
                                    request_id=req.request_id,
                                    prompt_len=len(prompt),
                                    shared_pages=len(shared)
                                    if shared else 0):
                    try:
                        fault_point("serving.prefill")
                        if shared:
                            shared_len = self._attach_shared(slot, shared)
                        self._reserve_and_alloc(slot, req, len(prompt))
                    finally:
                        for p in shared or ():
                            self._decref(p)  # unpin: the slot holds refs
            except PoolExhausted:
                if self._admission_pool_exhausted(slot, req, free,
                                                  finished):
                    continue        # starved out: try the next request
                break
            except Exception as e:
                # nothing was dispatched: the pools are intact
                self._admission_failed(slot, req, e, free, finished)
                continue
            if shared:
                self.prefix_hits += 1
                self.prefix_tokens_reused += shared_len
            entries.append({"slot": slot, "req": req,
                            "tokens": prompt[shared_len:],
                            "offset": shared_len})
        return entries

    def _ragged_batches(self, entries):
        """Split admission entries into dispatch batches of at most
        `prefill_chunk` tokens (unbounded without it). A long prompt
        spills into chunk-continuation pieces in later batches; only a
        request's final piece samples."""
        budget = self._chunk
        batches, cur, cur_tok = [], [], 0
        for e in entries:
            toks, off = e["tokens"], e["offset"]
            while toks:
                if budget is not None and cur_tok >= budget:
                    batches.append(cur)
                    cur, cur_tok = [], 0
                take = len(toks) if budget is None \
                    else min(len(toks), budget - cur_tok)
                cur.append({"slot": e["slot"], "req": e["req"],
                            "tokens": toks[:take], "offset": off,
                            "sample": take == len(toks)})
                toks = toks[take:]
                off += take
                cur_tok += take
        if cur:
            batches.append(cur)
        return batches

    def _dispatch_ragged(self, batch, finished) -> bool:
        """Pack one admission batch (segments aligned to block_q = 8,
        the token axis padded to a multiple of ``prompt_pad`` rounded up
        to 8) and run it as ONE ragged dispatch. Returns True when an
        instant finish freed a slot."""
        bq = self._ragged_block_q
        grid = -(-self.pad // bq) * bq
        pk = pack_ragged_batch(
            [{"seq": p["slot"], "tokens": p["tokens"],
              "offset": p["offset"], "sample": p["sample"]}
             for p in batch], self.B, block_q=bq, pad_to=grid)
        bound = self._pages_bound(int(pk["context_len"][p["slot"]])
                                  for p in batch)
        t0 = time.perf_counter()
        captured = self.graph_capture_seconds
        t_pad = int(pk["t_pad"])
        rids = ([p["req"].request_id for p in batch]
                if telemetry.enabled() else ())
        with telemetry.span("serving.ragged_prefill",
                            tokens=int(pk["tokens"]), t_pad=t_pad,
                            rids=rids):
            prog = self._program_lru(
                self._ragged_programs, (t_pad, bound),
                lambda: self._build_ragged(t_pad, bq, bound), "ragged")
            nxt = self._harvest_sync(self._ragged_step(
                prog, pk["ids"], pk["token_seq"], pk["positions"],
                pk["query_start"], pk["query_len"], pk["context_len"],
                pk["sample_rows"]))
        self.admission_seconds += time.perf_counter() - t0 \
            - (self.graph_capture_seconds - captured)
        self.admission_tokens += sum(len(p["tokens"]) for p in batch)
        self.num_admission_dispatches += 1
        freed = False
        for piece in batch:
            if not piece["sample"]:
                continue
            req, s = piece["req"], piece["slot"]
            self._pos[s] = piece["offset"] + len(piece["tokens"])
            tok = int(nxt[s])
            self._tok[s] = tok
            req.output.append(tok)
            self._first_token(req)
            if (self.eos is not None and tok == self.eos) \
                    or len(req.output) >= req.max_new_tokens:
                self._finalize(req, RequestStatus.FINISHED, None,
                               finished)
                self._release_slot(s)
                freed = True
        return freed

    def _first_token(self, req: Request):
        """An admission's token: counted in ``pdt_serving_admissions``,
        and on the request's first (a re-admission after preemption
        keeps it) its TTFT observed with the request id as exemplar."""
        _M_ADMISSIONS.inc()
        if req.first_token_time is not None:
            return
        req.first_token_time = self._clock()
        if telemetry.enabled():
            ttft = req.first_token_time - req.arrival_time
            _M_TTFT.observe(ttft, exemplar=req.request_id)
            telemetry.event("serving.first_token", rid=req.rid,
                            request_id=req.request_id, ttft_s=ttft)

    # -- legacy admission ------------------------------------------------
    def _bucket(self, n: int) -> int:
        """The prefill length of an n-token prompt: n rounded up to a
        multiple of ``prompt_pad``, clamped to the cache."""
        return min(-(-n // self.pad) * self.pad, self.S)

    def _admit_legacy(self) -> List[Request]:
        """≙ `_admit` :2472-2561: claim a slot per queued request, then
        one of three admissions (:2495-2514): a prefix-cache hit prefills
        only its suffix over the attached pages (`_admit_shared`); a
        paged prompt of at least ``prefill_chunk`` tokens prefills in
        fixed chunks (`_admit_chunked`); any other runs its own bucketed
        prefill dispatch, whose K/V rows go into its pages
        (`_paged_insert`) or its dense cache rows (`_dense_insert`). A
        failed page allocation backs the slot out and requeues the
        request (or starves it out). Any other failure (an armed
        ``serving.prefill``, a fault in the allocator after the prefill
        ran) fails the request alone (`_admission_failed`) while the
        admission has written nothing into the pools or caches
        (`_pool_writes`); a failure after a write began re-raises, as
        the JAX engine re-raises once a donating dispatch has consumed
        the pools."""
        finished: List[Request] = []
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        while free and self._queue:
            claim = self._claim_candidate(free)
            if claim is None:
                break                      # FIFO: wait for pages to free
            slot, req, prompt, shared = claim
            p_len = len(prompt)
            # the dispatch wall without capture time (counted apart)
            t0 = time.perf_counter() - self.graph_capture_seconds
            writes = self._pool_writes
            try:
                with telemetry.span("serving.prefill", rid=req.rid,
                                    request_id=req.request_id,
                                    prompt_len=p_len,
                                    shared_pages=len(shared)
                                    if shared else 0):
                    try:
                        fault_point("serving.prefill")
                        if shared:
                            tok = self._admit_shared(slot, req, prompt,
                                                     shared)
                        elif self.layout == "paged" and self._chunk \
                                and p_len >= self._chunk:
                            tok = self._admit_chunked(slot, req, prompt)
                        else:
                            bucket = self._bucket(p_len)
                            tok, rows = self._legacy_prefill(prompt, bucket)
                            if self.layout == "paged":
                                self._paged_insert(slot, req, p_len, bucket)
                            else:
                                self._dense_insert(slot, rows)
                            self.admission_tokens += p_len
                    finally:
                        for p in shared or ():
                            self._decref(p)  # unpin: the slot holds refs
            except PoolExhausted:
                self.admission_seconds += time.perf_counter() \
                    - self.graph_capture_seconds - t0
                if self._admission_pool_exhausted(slot, req, free,
                                                  finished):
                    continue               # starved out: try the next
                break
            except Exception as e:
                if self._pool_writes != writes:
                    raise
                self._admission_failed(slot, req, e, free, finished)
                continue
            self.admission_seconds += time.perf_counter() \
                - self.graph_capture_seconds - t0
            self._pos[slot] = p_len
            self._tok[slot] = tok
            req.output.append(tok)
            self._first_token(req)
            if (self.eos is not None and tok == self.eos) \
                    or len(req.output) >= req.max_new_tokens:
                self._finalize(req, RequestStatus.FINISHED, None, finished)
                self._release_slot(slot)
                free.insert(0, slot)
        return finished

    def _legacy_prefill(self, prompt: List[int], bucket: int):
        """≙ `_get_prefill` and its program's call: the prompt padded to
        ``bucket`` tokens through the bucket's program (`_build_prefill`).
        Returns the first token, read after the run (the step's sync
        point), and each layer's (k_rows, v_rows), (bucket, HK, D):
        views of `_legacy_rows`, which the next legacy program
        overwrites."""
        p_len = len(prompt)
        ids = np.zeros(bucket, np.int32)
        ids[:p_len] = prompt
        prog = self._program_lru(self._prefill_programs, bucket,
                                 lambda: self._build_prefill(bucket),
                                 "prefill")
        self._upload(ids, [p_len - 1], self._next_key(), dst=prog.flat)
        tok = int(self._run_program(prog)[0])
        self.num_admission_dispatches += 1
        return tok, [(k[0], v[0]) for k, v in self._rows_caches(0, bucket)]

    def _build_prefill(self, bucket: int) -> _Program:
        """≙ `_build_prefill`: a causal pass over a prompt padded to
        ``bucket`` tokens, with the padded tail masked out as keys, into
        per-layer (1, bucket, HK, D) caches (rows [0, bucket) of
        `_legacy_rows`), and the token of the last real row (`_picker`).
        Its flat input holds the ids (``bucket``), that row (1) and the
        sampling key (2)."""
        dev = self.device
        flat = torch.zeros(bucket + 3, dtype=torch.int32, device=dev)
        ids, row, key = flat[:bucket], flat[bucket:bucket + 1], \
            flat[bucket + 1:]
        caches = self._rows_caches(0, bucket)
        weights, model, pick = self._dispatch_weights(), self.model, \
            self._picker()

        def body():
            with torch.no_grad():
                valid = (torch.arange(bucket, device=dev) <= row)[None]
                logits = model(ids[None], caches, rows=row,
                               weights=weights, attention_mask=valid,
                               position_offset=0)
                return pick(logits, key)
        return _Program(flat, body)

    def _legacy_rows(self) -> list:
        """The K/V rows that every legacy program writes: per layer a
        (S + prompt_pad, HK, D) pair, made at first use. The prefill,
        suffix and chunk programs' caches are views of it (a suffix
        program's reach shared_len + its bucket, at most S + prompt_pad -
        2 rows), so the scatter program of a row count reads any of them
        from one address, at an offset in its input. One legacy program
        runs at a time and its rows are scattered or copied before the
        next one runs; rows past a program's reach (another program's,
        finite) are masked out of its attention as keys."""
        if self._rows is None:
            L, hk, hd, dt = self._kv_shape
            self._rows = [tuple(torch.zeros(self.S + self.pad, hk, hd,
                                            dtype=dt, device=self.device)
                                for _ in range(2)) for _ in range(L)]
        return self._rows

    def _rows_caches(self, start: int, n: int):
        """Rows [start, start + n) of `_legacy_rows` as each layer's
        (1, n, HK, D) cache pair."""
        return [tuple(r[start:start + n][None] for r in pair)
                for pair in self._legacy_rows()]

    def _paged_insert(self, slot: int, req: Request, p_len: int,
                      bucket: int):
        """≙ `_paged_insert`: reserve and allocate the slot's pages, then
        scatter its prefilled rows (rows [0, bucket) of `_legacy_rows`)
        into every layer's pools, the bucket's padding rows to trash page
        0."""
        self._reserve_and_alloc(slot, req, p_len)
        self._scatter(self._bt[slot], p_len, 0, bucket)

    def _scatter(self, bt_row, true_len: int, src: int, t: int):
        """≙ `_get_scatter` and its program's call: scatter rows [src,
        src + t) of `_legacy_rows`, positions 0..t-1 of the block-table row
        ``bt_row`` (host, (pps,)), into every layer's pools through the
        scatter program of ``t`` rows (`_build_scatter`); rows at or past
        ``true_len`` go to the trash page. Counted in `_pool_writes`
        before it runs."""
        # own LRU: suffix admissions reach row counts that never enter
        # the prefill family (≙ :3087)
        prog = self._program_lru(self._scatter_programs, t,
                                 lambda: self._build_scatter(t), "scatter")
        self._upload(bt_row, [true_len], [src], dst=prog.flat)
        self._pool_writes += 1
        self._run_program(prog)

    def _build_scatter(self, t: int) -> _Program:
        """≙ `_build_scatter` :3092-3102: the program that scatters ``t``
        rows of `_legacy_rows` into the pages (`paged_prefill_scatter` per
        layer). Its flat input holds the block-table row (pps), the true
        length (1) and the rows' offset in `_legacy_rows` (1): all three
        device values, so one capture serves every admission of ``t``
        rows."""
        pps, dev = self.pps, self.device
        flat = torch.zeros(pps + 2, dtype=torch.int32, device=dev)
        bt, true_len, off = flat[:pps], flat[pps:pps + 1], flat[pps + 1:]
        pools, rows = list(self._kv), self._legacy_rows()

        def body():
            with torch.no_grad():
                src = torch.arange(t, device=dev) + off.long()
                for (kp, vp), (rk, rv) in zip(pools, rows):
                    paged_prefill_scatter(kp, vp, rk[src], rv[src], bt,
                                          true_len)
                return true_len
        return _Program(flat, body)

    def _rebased_bt(self, slot: int, first_page: int) -> np.ndarray:
        """``slot``'s block-table row from page ``first_page`` on, zero
        padded to (pps,): the scatter of rows that start at a page
        boundary (a suffix after the shared pages, a chunk)."""
        sub = np.zeros(self.pps, np.int32)
        sub[:self.pps - first_page] = self._bt[slot, first_page:]
        return sub

    def _dense_insert(self, slot: int, rows):
        """≙ `_dense_insert` / `_build_insert`: write the prefilled rows
        (bucket, HK, D) of every layer into ``slot``'s dense cache rows
        from position 0, an eager index copy, counted in `_pool_writes`
        before it begins. Rows past the prompt hold the bucket's padding,
        which decode overwrites before it attends them."""
        self._pool_writes += 1
        with torch.no_grad():
            for (ck, cv), (rk, rv) in zip(self._caches, rows):
                ck[slot, :rk.shape[0]] = rk
                cv[slot, :rv.shape[0]] = rv

    def _admit_shared(self, slot: int, req: Request, prompt: List[int],
                      pages: List[int]) -> int:
        """≙ `_admit_shared` :2563-2592, a prefix-cache hit on the legacy
        path: attach the cached pages read-only, allocate the rest,
        prefill only the suffix at ``position_offset = shared_len`` over
        the shared rows (`_build_suffix_prefill`), then scatter its rows
        into the pages after the shared ones through a rebased
        block-table row (shared_len is page aligned). Returns the first
        token."""
        p_len = len(prompt)
        shared_len = self._attach_shared(slot, pages)
        self._reserve_and_alloc(slot, req, p_len)
        suffix = prompt[shared_len:]
        bucket = self._bucket(len(suffix))
        ids = np.zeros(bucket, np.int32)
        ids[:len(suffix)] = suffix
        prog = self._program_lru(
            self._suffix_programs, (shared_len, bucket),
            lambda: self._build_suffix_prefill(shared_len, bucket),
            "suffix", cap=2 * self._max_prefill)
        self._upload(ids, [len(suffix) - 1], pages, self._next_key(),
                     dst=prog.flat)
        tok = int(self._run_program(prog)[0])
        self.num_admission_dispatches += 1
        self._scatter(self._rebased_bt(slot, len(pages)), len(suffix),
                      shared_len, bucket)
        self.admission_tokens += len(suffix)
        self.prefix_hits += 1
        self.prefix_tokens_reused += shared_len
        return tok

    def _build_suffix_prefill(self, shared_len: int,
                              bucket: int) -> _Program:
        """≙ `_build_suffix_prefill` :3195-3239: the program of a suffix
        prefill after ``shared_len`` shared tokens. It gathers the
        shared pages of every layer to dense rows [0, shared_len) of its
        (1, shared_len + bucket, HK, D) caches (rows of `_legacy_rows`),
        prefills the suffix
        padded to ``bucket`` at ``position_offset = shared_len`` under
        the key-validity mask (keys past the real suffix masked out),
        and takes the token of the last real row (`_picker`). Its flat
        input holds the ids (``bucket``), that row (1), the shared pages
        (shared_len / page_size) and the sampling key (2)."""
        _, hk, hd, _ = self._kv_shape
        dev = self.device
        n_pp = shared_len // self.page_size
        flat = torch.zeros(bucket + 3 + n_pp, dtype=torch.int32, device=dev)
        ids, row = flat[:bucket], flat[bucket:bucket + 1]
        pages, key = flat[bucket + 1:bucket + 1 + n_pp], flat[-2:]
        n = shared_len + bucket
        caches = self._rows_caches(0, n)
        weights, model, pools = self._dispatch_weights(), self.model, \
            list(self._kv)
        pick = self._picker()

        def body():
            with torch.no_grad():
                idx = pages.long()
                for (kp, vp), (kc, vc) in zip(pools, caches):
                    # (HK, n_pp, page_size, D) -> (shared_len, HK, D)
                    kc[0, :shared_len] = kp[:, idx].permute(1, 2, 0, 3) \
                        .reshape(shared_len, hk, hd)
                    vc[0, :shared_len] = vp[:, idx].permute(1, 2, 0, 3) \
                        .reshape(shared_len, hk, hd)
                valid = (torch.arange(n, device=dev) <= shared_len + row)[None]
                logits = model(ids[None], caches, rows=row,
                               weights=weights, attention_mask=valid,
                               position_offset=shared_len)
                return pick(logits, key)
        return _Program(flat, body)

    def _admit_chunked(self, slot: int, req: Request,
                       prompt: List[int]) -> int:
        """≙ `_admit_chunked` :3112-3152: a long prompt in fixed chunks of
        ``prefill_chunk`` tokens, every chunk of every prompt through ONE
        program (`_build_chunk_prefill`) at the chunk's offset, each
        chunk's rows scattered into the pages after page ``off /
        page_size``; the token of the last real row of the last chunk
        (≙ `_build_sample`), the only chunk that takes a sampling key.
        The last chunk's padded
        rows leave garbage only at positions >= the prompt's length,
        which decode overwrites before it attends them; their scatter
        goes to the trash page."""
        C = self._chunk
        p_len = len(prompt)
        self._reserve_and_alloc(slot, req, p_len)
        n_chunks = -(-p_len // C)
        ids = np.zeros(n_chunks * C, np.int32)
        ids[:p_len] = prompt
        # its caches carry the earlier chunks' rows to the later chunks
        prog = self._program_singleton(
            "_chunk_program", lambda: self._build_chunk_prefill(C), "chunk")
        tok = None
        for ci in range(n_chunks):
            off = ci * C
            last = ci == n_chunks - 1
            self._upload(ids[off:off + C], [off],
                         [p_len - 1 - off if last else 0],
                         self._next_key() if last else self._NO_KEY,
                         dst=prog.flat)
            out = self._run_program(prog)
            self.num_admission_dispatches += 1
            if last:
                tok = int(out[0])
            self._scatter(self._rebased_bt(slot, off // self.page_size),
                          min(C, p_len - off), off, C)
        self.admission_tokens += p_len
        return tok

    def _build_chunk_prefill(self, C: int) -> _Program:
        """≙ `_build_chunk_prefill` :3162-3183: the program of one chunk
        of ``C`` tokens at a device offset, through the model's traced
        branch (attention over the whole (1, S, HK, D) working caches
        under a causal mask built on the device from the offset), then
        the token of one row (`_picker`). The working caches, rows [0, S)
        of `_legacy_rows`, keep the prompt's earlier chunks. Its flat
        input holds the ids (``C``), the offset (1), the row (1) and the
        sampling key (2)."""
        flat = torch.zeros(C + 4, dtype=torch.int32, device=self.device)
        ids, off, row, key = flat[:C], flat[C], flat[C + 1:C + 2], \
            flat[C + 2:]
        caches = self._rows_caches(0, self.S)
        weights, model, pick = self._dispatch_weights(), self.model, \
            self._picker()

        def body():
            with torch.no_grad():
                logits = model(ids[None], caches, rows=row,
                               weights=weights, position_offset=off)
                return pick(logits, key)
        return _Program(flat, body)

    def _build_legacy_decode(self) -> _Program:
        """≙ the paged `_build_decode`: ONE dispatch of (B, 1) tokens,
        each slot at its own position, through a `PagedKVCacheView` per
        layer (the attention appends the new K/V rows and launches the
        paged attention kernel), the tokens (`_picker`) left on the
        device. Its flat input holds the tokens and positions (B each),
        the block table (B x pps) and the sampling key (2)."""
        B, pps = self.B, self.pps
        flat = torch.zeros(2 * B + B * pps + 2, dtype=torch.int32,
                           device=self.device)
        tok, pos = flat[:2 * B].view(2, B)
        bt, key = flat[2 * B:-2].view(B, pps), flat[-2:]
        weights, model, pick = self._dispatch_weights(), self.model, \
            self._picker()
        pools = list(self._kv)

        def body():
            with torch.no_grad():
                views = [PagedKVCacheView(p[0], p[1], bt) for p in pools]
                logits = model(tok[:, None], views, weights=weights,
                               position_offset=pos)
                return pick(logits[:, 0], key)
        return _Program(flat, body)

    def _build_dense_decode(self) -> _Program:
        """≙ `_build_decode`'s tuple-cache arm :3241-3266: ONE dispatch
        of (B, 1) tokens over the dense (B, S, HK, D) caches, each slot
        at its own position (the attention writes the new K/V rows in
        place and attends in plain PyTorch, `masked_multihead_attention`,
        as in JAX), the tokens (`_picker`) left on the device. Its flat
        input holds the tokens and the positions (B each) and the
        sampling key (2)."""
        B = self.B
        flat = torch.zeros(2 * B + 2, dtype=torch.int32, device=self.device)
        tok, pos = flat[:2 * B].view(2, B)
        key = flat[2 * B:]
        weights, model, caches = self._dispatch_weights(), self.model, \
            list(self._caches)
        pick = self._picker()

        def body():
            with torch.no_grad():
                logits = model(tok[:, None], caches, weights=weights,
                               position_offset=pos)
                return pick(logits[:, 0], key)
        return _Program(flat, body)

    # -- token selection -------------------------------------------------
    # the key of a dispatch that draws nothing (a greedy engine's, an
    # earlier chunk's)
    _NO_KEY = np.zeros(2, np.int32)

    def _next_key(self) -> np.ndarray:
        """≙ `_next_keys`: the (seed, counter) key of the next sampling
        dispatch, the counter advanced once a dispatch; a greedy engine's
        programs read no key."""
        if self.strategy != "sampling":
            return self._NO_KEY
        key = np.array([self._seed_bits, self._sample_ctr], np.int32)
        self._sample_ctr = (self._sample_ctr + 1) & 0x7FFFFFFF
        return key

    def _picker(self):
        """The token selection of every program, ``pick(logits (R, V),
        key (2,) int32) -> (R,) int32``: the greedy argmax, or under
        ``do_sample`` `sample_tokens` with the engine's filter, its
        uniforms drawn from the key in the program's input (≙
        `_sample_token` with the dispatch's key)."""
        if self.strategy != "sampling":
            return lambda logits, key: _sample_token(logits)
        temp, top_k, top_p = self.temperature, self.top_k, self.top_p
        return lambda logits, key: sample_tokens(logits, key, temp, top_k,
                                                 top_p)

    # -- the ragged dispatch ---------------------------------------------
    def _build_ragged(self, t: int, block_q: int, pages_bound=None,
                      draft: bool = False,
                      select_rows: bool = True) -> _Program:
        """≙ `_build_ragged_step`: the program of a ragged dispatch over
        ``t`` packed rows. Its flat input holds, in this order, the ids,
        token_seq, positions and adapter rows (``t`` each), query_start,
        query_len, context_len and sample_rows (B each), the block table
        (B x pps) and the sampling key (2): the ids first, so that a
        pipelined window copies the previous dispatch's device tokens in
        alone. The body: packed ids -> per-token rope -> one KV scatter
        into the pages per layer -> ragged paged attention -> logits of
        each slot's sample row -> tokens (`_picker`), left on the device.
        Rows whose ``sample_rows`` entry is out of range are clamped and
        never read back. Nothing is read back from the device.

        ``draft=True`` runs the spec engine's draft model over the draft
        pools with its own weights (the draft cache's backfill prefill,
        whose tokens are never read); ``select_rows=False`` returns the
        pick of EVERY packed row and ignores ``sample_rows`` (the verify
        pass, whose acceptance needs the target's choice at all k + 1
        positions)."""
        B, pps = self.B, self.pps
        flat = torch.zeros(4 * t + 4 * B + B * pps + 2, dtype=torch.int32,
                           device=self.device)
        ids, seq, pos, ad = flat[:4 * t].view(4, t)
        qs, ql, cl, rows = flat[4 * t:4 * (t + B)].view(4, B)
        bt, key = flat[4 * (t + B):-2].view(B, pps), flat[-2:]
        pick = self._picker()
        if draft:
            weights, model = None, self._spec.draft_model
            pools = list(self._d_kv)
        else:
            # multi-LoRA: each packed row takes its owning slot's adapter
            # row
            weights, model = self._dispatch_weights(ad), self.model
            pools = list(self._kv)

        def body():
            with torch.no_grad():
                views = [RaggedKVCacheView(p[0], p[1], bt, seq, pos, qs, ql,
                                           cl, block_q, pages_bound, *p[2:])
                         for p in pools]
                if not select_rows:
                    return pick(model(ids[None], views, weights=weights)[0],
                                key)
                logits = model(ids[None], views, rows=rows.clamp(0, t - 1),
                               weights=weights)
                return pick(logits, key)
        return _Program(flat, body)

    def _ragged_step(self, prog: _Program, ids, token_seq, positions,
                     query_start, query_len, context_len,
                     sample_rows, bt=None) -> torch.Tensor:
        """ONE ragged dispatch: fill ``prog``'s input and run it. ``ids``
        is a host array, or in a pipelined window the previous decode
        dispatch's device tokens, copied in on the device; every other
        array goes up in one host-to-device copy, with the block table
        ``bt`` (default the target's; a draft dispatch passes the
        draft's) and the dispatch's sampling key. A padding row's adapter
        row is the last slot's (token_seq -1): inert, its output is never
        read and the epilogue sums across no tokens."""
        t = len(token_seq)
        adapter_rows = self._slot_adapter[np.asarray(token_seq, np.int64)]
        rest = (token_seq, positions, adapter_rows, query_start, query_len,
                context_len, sample_rows, self._bt if bt is None else bt,
                self._next_key())
        if torch.is_tensor(ids):
            prog.flat[:t].copy_(ids)
            self._upload(*rest, dst=prog.flat[t:])
        else:
            self._upload(ids, *rest, dst=prog.flat)
        return self._run_program(prog)

    def _upload(self, *arrays, dst=None):
        """Copy int32 host arrays to the device in ONE transfer, into
        ``dst`` (a program's flat input, exactly their size) or a new
        tensor; returns a device view of each, in its shape. On the card
        the copy goes from a pinned staging buffer and does not wait for
        the stream (a pageable copy would wait for every dispatch before
        it). The buffer comes from PyTorch's pinned-memory caching
        allocator, which hands it out again only after the copy that read
        it has completed, so a later dispatch never overwrites a buffer
        that an earlier one's copy still reads; and the copy into
        ``dst`` runs on the stream after every earlier dispatch, so it
        never changes the input of a replay in flight."""
        arrays = [np.asarray(a, np.int32) for a in arrays]
        cuda = self.device.type == "cuda"
        staged = torch.empty(sum(a.size for a in arrays), dtype=torch.int32,
                             pin_memory=cuda)
        np.concatenate([a.ravel() for a in arrays], out=staged.numpy())
        if dst is None:
            flat = staged.to(self.device, non_blocking=cuda)
        else:
            flat = dst.copy_(staged, non_blocking=cuda)
        out, at = [], 0
        for a in arrays:
            out.append(flat[at:at + a.size].view(a.shape))
            at += a.size
        return out

    # -- the program cache -------------------------------------------------
    def _program_lru(self, cache: "OrderedDict", key, build, family: str,
                     cap: Optional[int] = None) -> _Program:
        """≙ `_jit_lru`: the program of ``key`` in the keyed family
        ``cache``; on a miss it is built and the oldest programs past
        ``cap`` (default ``max_prefill_programs``) are evicted (each
        graph with its program: every admission dispatch ends in a host
        read, so none is in flight), on a hit it moves to the back.
        ``family`` is the JAX engine's name for the family: the label of
        the ``pdt_jit_*`` series, a miss's first run metered as its
        compile (`_run_program`) and the cache's size and evictions
        noted (`profile.note_cache`). Without graphs, a program built for
        this dispatch alone, and nothing metered."""
        if not self._graphs:
            return build()
        prog = cache.get(key)
        if prog is None:
            prog = cache[key] = build()
            prog.family, prog.key = family, key
            evicted = 0
            while len(cache) > (cap or self._max_prefill):
                cache.popitem(last=False)                  # LRU
                evicted += 1
            _profile.note_cache(family, len(cache), evicted)
        else:
            cache.move_to_end(key)
        return prog

    def _program_singleton(self, attr: str, build, family: str) -> _Program:
        """≙ `_jit_singleton`: the one program kept in attribute ``attr``
        (the decode program, the chunk program, the draft scan), built at
        first use and again after `_drop_programs`, its first run
        metered as a compile of ``family``. Without graphs, a program
        built for this dispatch (or admission) alone."""
        if not self._graphs:
            return build()
        prog = getattr(self, attr)
        if prog is None:
            prog = build()
            prog.family = family
            setattr(self, attr, prog)
        return prog

    def _programs(self) -> List[_Program]:
        progs = list(self._ragged_programs.values()) \
            + list(self._prefill_programs.values()) \
            + list(self._suffix_programs.values()) \
            + list(self._d_prefill_programs.values()) \
            + list(self._verify_programs.values()) \
            + list(self._scatter_programs.values()) \
            + list(self._install_programs.values())
        return progs + [p for p in (self._decode_program,
                                    self._chunk_program,
                                    self._draft_scan_program)
                        if p is not None]

    def _drop_programs(self):
        """Empty the program cache. A program binds the KV pools and the
        dispatch weights when it is built and its graph reads them by
        address, so after a weight or adapter change it would read the
        old values with no error (the JAX engine passes weights as
        arguments and needs no such step). Callers quiesce first, so no
        replay is in flight."""
        self._ragged_programs.clear()
        self._prefill_programs.clear()
        self._suffix_programs.clear()
        self._d_prefill_programs.clear()
        self._verify_programs.clear()
        self._scatter_programs.clear()
        self._install_programs.clear()
        self._decode_program = None
        self._chunk_program = None
        self._draft_scan_program = None

    def _run_program(self, prog: _Program) -> torch.Tensor:
        """Run ``prog`` on its filled input; returns its greedy tokens,
        which on the card and under graphs on the CPU are the program's
        static output, overwritten by its next run: a caller that keeps
        them past the next run copies them. Without graphs, the body
        eagerly. On the CPU, the body eagerly on the program's buffers.
        On the card: the first run is the warm-up (`_warm_up`), the
        second captures (`_capture`), and from then on the graph replays,
        adding the launches the capture recorded. A failed capture or
        replay raises: nothing falls back to the eager body. A program's
        first run is metered as its family's compile, and its capture
        under ``jit.compile`` without a count (`profile.compile_timed`)."""
        if not self._graphs:
            return prog.body()
        prog.runs += 1
        if self.device.type != "cuda":
            body = prog.body if prog.runs > 1 else _profile.compile_timed(
                prog.body, prog.family, prog.key)
            res = body()
            if prog.out is None:
                prog.out = torch.empty_like(res)
            return prog.out.copy_(res)
        if prog.graph is None:
            if prog.runs == 1:
                return _profile.compile_timed(
                    lambda: self._warm_up(prog), prog.family, prog.key)()
            _profile.compile_timed(lambda: self._capture(prog), prog.family,
                                   prog.key, count=False)()
        prog.graph.replay()
        for k, n in prog.launches.items():
            launch_counts[k] += n
        return prog.out

    def _warm_up(self, prog: _Program) -> torch.Tensor:
        """A program's first run on the card: its body, eagerly, on the
        engine's capture stream, joined to the current stream both ways,
        so that what the kernels make at first use on a stream (the split
        tickets) exists when the capture comes. Its result is the
        dispatch's: a key used once costs one eager run, no capture."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        side = self._capture_stream
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = prog.body()
        cur.wait_stream(side)
        out.record_stream(cur)
        return out

    def _capture(self, prog: _Program):
        """Capture ``prog``'s body into a CUDA graph on the capture stream.
        Every graph of the engine allocates from ONE shared pool (a new
        one when no captured graph is left), so the graphs take about
        the memory of the largest, not their sum. Sharing is safe here:
        the engine replays one graph at a time on one stream and copies
        or reads each replay's output before the next replay, since a
        graph's output may lie where another graph keeps its scratch.
        The wrappers count their launches while the body is captured,
        but a capture launches nothing: that count moves to
        ``prog.launches``, which each replay adds back. Timed into
        ``graph_capture_seconds``, apart from the dispatch walls."""
        t0 = time.perf_counter()
        if self._graph_pool is None \
                or not any(p.graph is not None for p in self._programs()):
            self._graph_pool = torch.cuda.graph_pool_handle()
        before = dict(launch_counts)
        graph = torch.cuda.CUDAGraph()
        # capture_begin / capture_end rather than `torch.cuda.graph`, which
        # synchronizes and empties the allocator's cache before each
        # capture: every later dispatch would then allocate anew
        try:
            with torch.cuda.stream(self._capture_stream):
                graph.capture_begin(pool=self._graph_pool)
                try:
                    out = prog.body()
                    held = stream_tickets(self.device)
                finally:
                    graph.capture_end()
        finally:
            counted = {k: n - before[k] for k, n in launch_counts.items()
                       if n != before[k]}
            for k, n in counted.items():
                launch_counts[k] -= n
        prog.graph, prog.out, prog.launches = graph, out, counted
        prog.held = (held,)
        self.num_graph_captures += 1
        self.graph_capture_seconds += time.perf_counter() - t0

    # -- decode ------------------------------------------------------------
    def _decode(self, finished: List[Request]):
        """One batched decode step for every slot: the decode program, a
        ragged dispatch at block_q = 1 with one query row per slot, the
        legacy (B, 1) dispatch through the paged attention, or the dense
        (B, 1) dispatch over the per-slot caches. Inactive slots decode
        garbage at a clamped position; their block-table rows are all
        trash page, so their KV lands in page 0 (never read), a dense
        slot's rows are overwritten at its next admission, and their
        tokens are never read back.

        Positions advance at dispatch and the dispatch joins the window
        that `_harvest_pending` commits, the one place where tokens are
        committed and EOS, budget and cap decided. At ``harvest_every``
        = 1 the window of one is harvested at once: the synchronous
        loop. At k > 1 the tokens stay on the device as the next
        dispatch's input until the window is due. Each pending dispatch
        keeps a copy of its tokens: the program's output is overwritten
        by its next run. A spec engine runs a speculative round instead
        (`_spec_decode`), which commits its own tokens, unless the round
        degrades (an armed ``speculative.*`` site fired): then this plain
        step runs.

        ``serving.decode`` fires after page growth and window
        reclamation and before the sampling key and the index upload (≙
        :3427), so a retried step replays the same dispatch with the same
        uniforms. With telemetry on, the step is split as the JAX
        engine's (≙ :3370-3535): "host" before the dispatch, "dispatch"
        (the replay), the bookkeeping after it; "device" and "harvest"
        at the harvest."""
        if self._spec is not None and self._spec_decode(finished):
            return
        prof = telemetry.enabled()
        d0 = time.perf_counter() if prof else 0.0
        for i, r in enumerate(self._slot_req):
            if r is None or self.layout != "paged":
                continue
            if not self._grow_slot(i, finished):
                continue              # slot i itself was preempted
            if self._window is not None:
                # reclaim pages that slid wholly below the attention
                # window [ctx - w, ctx): the kernel never reads them
                ws = int(self._pos[i]) + 1 - self._window
                while (self._slot_freed[i] + 1) * self.page_size <= ws:
                    j = int(self._slot_freed[i])
                    page = int(self._bt[i, j])
                    if page != 0:
                        self._slot_pages[i].remove(page)
                        self._decref(page)
                        self._bt[i, j] = 0
                    self._slot_freed[i] += 1
        act = tuple(i for i, r in enumerate(self._slot_req)
                    if r is not None)
        if not act:
            if prof:
                _profile.note_round("harvest", 0.0)   # nothing to commit
            return                    # every slot preempted away
        fault_point("serving.decode")
        rids = ([self._slot_req[i].request_id for i in act] if prof else ())
        with telemetry.span("serving.decode_step", slots=len(act),
                            rids=rids):
            t0 = time.perf_counter()
            if prof:
                _profile.note_round("host", t0 - d0)
            copied = self._decode_dispatch(act, t0)
            t2 = time.perf_counter() if prof else 0.0
        if copied is not None:
            # ≙ the JAX step's commit, outside the step's span
            if prof:
                _profile.note_round("host", time.perf_counter() - t2)
            self._harvest_commit(finished, *copied)

    def _decode_dispatch(self, act, t0: float):
        """The decode step's dispatch, timed from ``t0``; at
        ``harvest_every`` = 1 also the harvest's copy, which it returns
        (`_harvest_copy`)."""
        prof = telemetry.enabled()
        pos = np.clip(self._pos, 0, self.S - 1).astype(np.int32)
        idx = np.arange(self.B, dtype=np.int32)
        captured = self.graph_capture_seconds
        if self.attn_impl == "ragged":
            prog = self._program_singleton(
                "_decode_program", lambda: self._build_ragged(self.B, 1),
                "decode")
            # mid-window the input is the previous dispatch's device
            # output: the greedy feedback makes no host round trip
            tok = self._tok_dev if self._tok_dev is not None else self._tok
            out = self._ragged_step(prog, tok, idx, pos, idx,
                                    np.ones(self.B, np.int32), pos + 1, idx)
        elif self.layout == "paged":
            prog = self._program_singleton("_decode_program",
                                           self._build_legacy_decode,
                                           "decode")
            self._upload(self._tok, pos, self._bt, self._next_key(),
                         dst=prog.flat)
            out = self._run_program(prog)
        else:
            prog = self._program_singleton("_decode_program",
                                           self._build_dense_decode,
                                           "decode")
            self._upload(self._tok, pos, self._next_key(), dst=prog.flat)
            out = self._run_program(prog)
        nxt = out.clone()
        t1 = time.perf_counter()
        self.num_decode_dispatches += 1
        self._window_wall += t1 - t0 - (self.graph_capture_seconds - captured)
        if prof:
            _M_DECODE_DISPATCH.observe(t1 - t0)
            _profile.note_round("dispatch", t1 - t0)
        for i in act:
            r = self._slot_req[i]
            r.device_len = max(r.device_len, len(r.output)) + 1
            self._pos[i] += 1
        self._pending.append({"nxt": nxt, "act": act,
                              "pos": self._pos.copy()})
        self._tok_dev = nxt
        if prof:
            _profile.note_round("host", time.perf_counter() - t1)
        if self.harvest_every == 1:
            return self._harvest_copy()
        return None

    # -- speculative decoding ----------------------------------------------
    def _spec_decode(self, finished: List[Request]) -> bool:
        """≙ `_spec_decode` :3776-3839: one speculative round, the draft
        half (`_spec_draft`, behind ``speculative.draft``), then ONE
        verify dispatch of every slot and its commit (`_spec_verify`,
        behind ``speculative.verify``). The round makes two host reads,
        the proposals and the verify picks. Its host wall, capture time
        excluded, goes to ``decode_seconds`` and its tokens to
        ``decode_tokens``, as a decode step's. Returns True when the
        round handled the step; False when a fault at one of its two
        sites degraded it (`_spec_degrade`): the caller then decodes the
        step plainly. A `FaultError` of another site (``serving.
        alloc_page`` in the page growth) keeps its own meaning, the
        step's decode retry."""
        rids = ([r.request_id for r in self._slot_req if r is not None]
                if telemetry.enabled() else ())
        t0 = time.perf_counter()
        captured = self.graph_capture_seconds
        try:
            with telemetry.span("serving.draft", k=self._spec_k, rids=rids):
                fault_point("speculative.draft")
                props, kuse = self._spec_draft(finished)
        except FaultError as e:
            if getattr(e, "site", "") != "speculative.draft":
                raise
            self._spec_degrade("draft", e)
            return False
        t1 = time.perf_counter()
        draft_capture = self.graph_capture_seconds - captured
        active = [i for i, r in enumerate(self._slot_req) if r is not None]
        if not active:
            return True               # growth preempted everything
        try:
            emitted, proposed, accepted = self._spec_verify(
                active, props, kuse, finished)
        except FaultError as e:
            if getattr(e, "site", "") != "speculative.verify":
                raise
            self._spec_degrade("verify", e)
            return False
        t2 = time.perf_counter()
        capture = self.graph_capture_seconds - captured
        self.num_spec_rounds += 1
        self.num_spec_proposed += proposed
        self.num_spec_accepted += accepted
        self.spec_draft_seconds += t1 - t0 - draft_capture
        self.spec_verify_seconds += t2 - t1 - (capture - draft_capture)
        self.decode_seconds += t2 - t0 - capture
        self.decode_tokens += emitted
        _M_SPEC_ROUNDS.inc()
        _M_SPEC_PROPOSED.inc(proposed)
        _M_SPEC_ACCEPTED.inc(accepted)
        if telemetry.enabled():
            _M_SPEC_DRAFT_SECONDS.observe(t1 - t0)
            # the round IS this step's decode dispatch
            _M_DECODE_STEP.observe(t2 - t0)
            _M_DECODE_TOKENS.inc(emitted)
            if t2 > t0:
                _M_TOKENS_PER_SEC.set(emitted / (t2 - t0))
            if self.num_spec_proposed:
                _M_SPEC_ACCEPT_RATE.set(self.num_spec_accepted
                                        / self.num_spec_proposed)
        return True

    def _spec_degrade(self, site: str, err: BaseException):
        """≙ :3841: an armed spec fault site fired: count it, drop every
        draft cache's validity (what the draft pass wrote is unverified
        relative to the stream plain decode now extends; the next round
        backfills), and let the caller decode this step plainly. No
        request fails."""
        self.num_spec_degraded += 1
        _M_SPEC_DEGRADED.inc(site=site)
        telemetry.event("serving.spec_degraded", site=site,
                        error=f"{type(err).__name__}: {err}")
        self._d_valid[:] = False

    def _spec_draft(self, finished: List[Request]):
        """≙ `_spec_draft` :3853: each slot's verify budget ``k_i =
        min(k, remaining tokens - 1, cache room)`` (a round never emits
        past ``max_new_tokens`` or the cache end), the target's pages
        grown to cover the verify scatter at ``pos..pos+k_i``, the draft's
        pages grown through ``pos + k_i`` (the scan's catch-up row) and
        backfilled where the draft cache was dropped, then the draft
        scan. A slot the draft pool cannot grow rides the round as a
        plain one-row verify (k_i = 0) with its draft cache dropped.
        Returns (proposals (B, K), verify budgets (B,))."""
        K = self._spec_k
        kuse = np.zeros(self.B, np.int32)
        for i, r in enumerate(self._slot_req):
            if r is None:
                continue
            ki = max(min(K, r.max_new_tokens - len(r.output) - 1,
                         self.S - 1 - int(self._pos[i])), 0)
            if not self._grow_slot(i, finished, extra=ki):
                continue              # preempted away mid-growth
            kuse[i] = ki
        backfill = []
        for i, r in enumerate(self._slot_req):
            if r is None or kuse[i] < 1:
                continue
            try:
                self._d_grow(i, int(self._pos[i]) + int(kuse[i]))
            except PoolExhausted:
                self._d_release(i)
                kuse[i] = 0
                continue
            if not self._d_valid[i]:
                backfill.append(i)
        if backfill:
            self._spec_backfill(backfill)
        return self._spec_scan(kuse), kuse

    def _d_grow(self, slot: int, last_pos: int):
        """≙ `_d_grow` :3896: draft pages until the slot's draft block
        table covers writes through ``last_pos``."""
        while self._d_next_idx[slot] * self.page_size <= last_pos:
            if not self._d_free:
                raise PoolExhausted(f"draft page pool exhausted "
                                    f"({self._d_num_pages - 1} usable "
                                    "pages)")
            page = self._d_free.pop()
            self._d_slot_pages[slot].append(page)
            self._d_bt[slot, self._d_next_idx[slot]] = page
            self._d_next_idx[slot] += 1

    def _d_release(self, slot: int):
        """≙ `_d_release` :3909: a slot's draft pages back to the free
        list (owned by one slot, so no refcounts), its draft block table
        to the trash page, its draft cache invalid."""
        self._d_free.extend(self._d_slot_pages[slot])
        self._d_slot_pages[slot] = []
        self._d_bt[slot] = 0
        self._d_next_idx[slot] = 0
        self._d_valid[slot] = False

    def _spec_backfill(self, slots: List[int]):
        """≙ `_spec_backfill` :3919: rebuild dropped draft caches by
        prefilling each slot's stream but its pending last token (the
        rows the next draft scan attends) through the draft's ragged
        program, packed like an admission batch and cut by
        ``prefill_chunk``."""
        entries = []
        for i in slots:
            r = self._slot_req[i]
            entries.append({"slot": i, "req": r, "offset": 0,
                            "tokens": self._effective_prompt(r)[:-1]})
        for batch in self._ragged_batches(entries):
            self._dispatch_draft_prefill(batch)
        for i in slots:
            self._d_valid[i] = True

    def _dispatch_draft_prefill(self, batch):
        """≙ `_dispatch_draft_prefill` :3938: one backfill batch through
        the draft prefill program of its (padded tokens, pages bound)
        (≙ `_get_draft_prefill` :3962). Nothing is read back."""
        bq = self._ragged_block_q
        grid = -(-self.pad // bq) * bq
        pk = pack_ragged_batch(
            [{"seq": p["slot"], "tokens": p["tokens"], "offset": p["offset"]}
             for p in batch], self.B, block_q=bq, pad_to=grid)
        bound = self._pages_bound(int(pk["context_len"][p["slot"]])
                                  for p in batch)
        t_pad = int(pk["t_pad"])
        prog = self._program_lru(
            self._d_prefill_programs, (t_pad, bound),
            lambda: self._build_ragged(t_pad, bq, bound, draft=True),
            "draft")
        self._ragged_step(prog, pk["ids"], pk["token_seq"], pk["positions"],
                          pk["query_start"], pk["query_len"],
                          pk["context_len"], pk["sample_rows"],
                          bt=self._d_bt)
        self.num_draft_prefills += 1

    def _spec_scan(self, kuse) -> np.ndarray:
        """≙ `_spec_scan` :3969: K greedy draft tokens for every live slot
        (a draft cache to extend and k_i >= 1) by ONE run of the draft
        scan program, then the round's first host read: the proposals
        (B, K)."""
        live = np.array([r is not None and kuse[i] >= 1
                         and bool(self._d_valid[i])
                         for i, r in enumerate(self._slot_req)], np.int32)
        if not live.any():
            return np.zeros((self.B, self._spec_k), np.int32)
        prog = self._program_singleton("_draft_scan_program",
                                       self._build_draft_scan, "draft_scan")
        self._upload(self._tok, self._pos, live, self._d_bt, dst=prog.flat)
        props = self._harvest_sync(self._run_program(prog))
        self.num_draft_scans += 1
        return props

    def _build_draft_scan(self, catch_up: bool = True) -> _Program:
        """≙ `_build_draft_scan` :3991-4047: K + 1 single-token draft
        forwards as one program (one CUDA graph on the card, as
        `lax.scan` is one program), each step's argmax feeding the next
        at the next position through the draft pools at block_q 1. Dead
        rows (no live draft, or a position past the cache) have
        query_len 0: their attention rows are zero and their K/V goes to
        the trash page. The (K+1)-th step is the catch-up: K steps alone
        never feed the last proposal, so a full accept would leave a
        hole at pos + K that the next round attends (self-draft
        acceptance 0.67 instead of 1.0); its token is dropped
        (``catch_up=False`` leaves the step out: the planted fault that
        the checks of self-draft acceptance must catch). Its flat input
        holds the last tokens, the positions and the live flags (B each)
        and the draft block table (B x pps); its output the proposals
        (B, K)."""
        B, pps, K, S = self.B, self.pps, self._spec_k, self.S
        dev = self.device
        flat = torch.zeros(3 * B + B * pps, dtype=torch.int32, device=dev)
        tok0, pos0, live = flat[:3 * B].view(3, B)
        bt = flat[3 * B:].view(B, pps)
        model, pools = self._spec.draft_model, list(self._d_kv)

        def body():
            with torch.no_grad():
                bidx = torch.arange(B, dtype=torch.int32, device=dev)
                tok, props = tok0, []
                for step in range(K + int(catch_up)):
                    ok = (live != 0) & (pos0 + step <= S - 1)
                    posv = torch.clamp(pos0 + step, max=S - 1)
                    seq = torch.where(ok, bidx, -1)
                    qlen = ok.to(torch.int32)
                    views = [RaggedKVCacheView(p[0], p[1], bt, seq, posv,
                                               bidx, qlen, posv + 1, 1, None,
                                               *p[2:])
                             for p in pools]
                    tok = _sample_token(model(tok[None], views)[0])
                    props.append(tok)
                return torch.stack(props[:K], 1)
        return _Program(flat, body)

    def _spec_verify(self, active, props, kuse, finished):
        """≙ `_spec_verify` :4049: ONE target dispatch over every slot's
        packed rows ``[last token, d_1..d_{k_i}]`` at ``pos..pos+k_i``
        through the verify program of its (padded tokens, pages bound)
        (≙ `_get_spec_verify` :4140), the round's second host read (every
        row's greedy pick), acceptance by `spec_accept_greedy` on
        sentinel-padded rows, then the commit: the accepted prefix and
        the bonus token, cut after an EOS, with the position advanced by
        what was committed. The rows scattered past it are stale and are
        overwritten before any causal mask admits them. Returns
        (emitted, proposed, accepted)."""
        K = self._spec_k
        pieces = [{"seq": i, "offset": int(self._pos[i]),
                   "tokens": [int(self._tok[i])]
                   + [int(t) for t in props[i, :int(kuse[i])]]}
                  for i in active]
        bq = self._verify_block_q
        pk = pack_ragged_batch(pieces, self.B, block_q=bq, pad_to=bq)
        bound = self._pages_bound(int(pk["context_len"][i]) for i in active)
        t_pad = int(pk["t_pad"])
        rids = ([self._slot_req[i].request_id for i in active]
                if telemetry.enabled() else ())
        with telemetry.span("serving.verify", slots=len(active),
                            tokens=int(pk["tokens"]), rids=rids):
            fault_point("speculative.verify")
            t0 = time.perf_counter()
            prog = self._program_lru(
                self._verify_programs, (t_pad, bound),
                lambda: self._build_ragged(t_pad, bq, bound,
                                           select_rows=False),
                "verify")
            g_all = self._harvest_sync(self._ragged_step(
                prog, pk["ids"], pk["token_seq"], pk["positions"],
                pk["query_start"], pk["query_len"], pk["context_len"],
                pk["sample_rows"]))
            vdt = time.perf_counter() - t0
        if telemetry.enabled():
            _M_SPEC_VERIFY_SECONDS.observe(vdt)
        self.num_decode_dispatches += 1
        # ragged acceptance through the one shared core: sentinels that
        # never match cap each row's j at its real proposal count
        n = len(active)
        gm = np.full((n, K + 1), -2, np.int32)
        pm = np.full((n, K), -1, np.int32)
        for idx, i in enumerate(active):
            r0, ki = int(pk["query_start"][i]), int(kuse[i])
            gm[idx, :ki + 1] = g_all[r0:r0 + ki + 1]
            pm[idx, :ki] = props[i, :ki]
        j_arr = spec_accept_greedy(gm, pm)[0]
        emitted = proposed = accepted = 0
        for idx, i in enumerate(active):
            r = self._slot_req[i]
            ki, j = int(kuse[i]), int(j_arr[idx])
            toks = [int(t) for t in gm[idx, :j + 1]]
            if self.eos is not None and self.eos in toks:
                toks = toks[:toks.index(self.eos) + 1]
            r.output.extend(toks)
            r.device_len = len(r.output)
            self._pos[i] += len(toks)
            self._tok[i] = toks[-1]
            proposed += ki
            accepted += j
            emitted += len(toks)
            if (self.eos is not None and toks[-1] == self.eos) \
                    or len(r.output) >= r.max_new_tokens \
                    or int(self._pos[i]) >= self.S - 1:
                self._finalize(r, RequestStatus.FINISHED, None, finished)
                self._release_slot(i)
        return emitted, proposed, accepted

    @property
    def spec_enabled(self) -> bool:
        return self._spec is not None

    def spec_info(self) -> Dict[str, float]:
        """Speculation counters, keyed as the JAX engine's (zeros on an
        engine without ``spec_decode``); ``degraded`` counts the rounds a
        ``speculative.*`` fault turned into plain decode steps."""
        return {"rounds": self.num_spec_rounds,
                "proposed": self.num_spec_proposed,
                "accepted": self.num_spec_accepted,
                "degraded": self.num_spec_degraded,
                "acceptance_rate": self.num_spec_accepted
                / max(self.num_spec_proposed, 1)}

    # -- the harvest: the decode path's only reads from the device --------
    def _harvest_sync(self, nxt: torch.Tensor) -> np.ndarray:
        """Device tokens copied to the host: the decode path's one wait
        for the device (and admission's, for its first tokens)."""
        return nxt.cpu().numpy()

    def _harvest_due(self) -> bool:
        """≙ :3609: must the window be harvested before this step's
        expiry, admission and dispatch? Yes when it is full, when a
        request waits for admission, when a running request's deadline
        has passed (expiry must see committed tokens), or when the next
        dispatch could run past a request's token budget or the
        sequence cap (the synchronous loop would have finalized it)."""
        if len(self._pending) >= self.harvest_every or self._queue:
            return True
        now = self._clock()
        depth = len(self._pending)
        for i, r in enumerate(self._slot_req):
            if r is None:
                continue
            if r.deadline is not None and now >= r.deadline:
                return True
            if len(r.output) + depth >= r.max_new_tokens:
                return True
            if int(self._pos[i]) >= self.S - 1:
                return True
        return False

    def _harvest_pending(self, finished: List[Request]):
        """≙ :3636: drain the window. ONE copy of every pending
        dispatch's tokens to the host (a window of one, at k = 1, is
        copied without a stack), then the commits, dispatch by dispatch
        in order, with EOS, budget and cap finalization at the dispatch
        where it fired; a finalized slot's later tokens in the window
        (the device ran past an EOS it could not see, at most k - 1
        tokens) are discarded.
        ``decode_seconds`` takes the window's dispatch walls plus this
        copy's wait. With telemetry on, the copy's wait is the round's
        "device" component (the tokens' device time surfaces there on
        the host clock) and the commits its "harvest" (≙ :3650-3712); a
        window of k > 1 dispatches is a ``serving.harvest`` span."""
        copied = self._harvest_copy()
        if copied is not None:
            self._harvest_commit(finished, *copied)

    def _harvest_copy(self):
        """The harvest's copy: every pending dispatch's tokens to the
        host in one copy. Returns (entries, tokens, dispatch wall, copy
        wait), or None when the window is empty."""
        entries, self._pending = self._pending, []
        self._tok_dev = None
        wall, self._window_wall = self._window_wall, 0.0
        if not entries:
            return None
        prof = telemetry.enabled()
        with telemetry.span("serving.harvest", window=len(entries)) \
                if self.harvest_every > 1 else contextlib.nullcontext():
            t0 = time.perf_counter()
            toks = [e["nxt"] for e in entries]
            stacked = self._harvest_sync(
                toks[0][None] if len(toks) == 1 else torch.stack(toks))
            sync = time.perf_counter() - t0
        self.decode_seconds += wall + sync
        self.decode_dispatch_seconds += wall
        if prof:
            _M_HARVEST.observe(sync)
            _profile.note_round("device", sync)
        return entries, stacked, wall, sync

    def _harvest_commit(self, finished, entries, stacked, wall, sync):
        """The harvest's commits, dispatch by dispatch (`_harvest_pending`)."""
        prof = telemetry.enabled()
        c0 = time.perf_counter() if prof else 0.0
        committed = 0
        done_slots: set = set()
        live_last: Dict[int, int] = {}
        for e, nxt in zip(entries, stacked):
            for i in e["act"]:
                r = self._slot_req[i]
                if i in done_slots or r is None:
                    continue
                tok = int(nxt[i])
                r.output.append(tok)
                committed += 1
                live_last[i] = tok
                if (self.eos is not None and tok == self.eos) \
                        or len(r.output) >= r.max_new_tokens \
                        or int(e["pos"][i]) >= self.S - 1:
                    r.device_len = len(r.output)
                    self._finalize(r, RequestStatus.FINISHED, None,
                                   finished)
                    self._release_slot(i)
                    done_slots.add(i)
                    live_last.pop(i, None)
        for i, tok in live_last.items():
            self._tok[i] = tok
        for r in self._slot_req:
            if r is not None:
                r.device_len = len(r.output)        # staleness resync
        self.decode_tokens += committed
        if prof:
            _profile.note_round("harvest", time.perf_counter() - c0)
            _M_DECODE_TOKENS.inc(committed)
            if self.harvest_every == 1:
                _M_DECODE_STEP.observe(wall + sync)
            if wall + sync > 0:
                _M_TOKENS_PER_SEC.set(committed / (wall + sync))

    def quiesce(self) -> int:
        """Harvest the pipelined window NOW, so that host request state
        (``output``, ``_tok``, ``_pos``) is committed and consistent;
        every path that touches slot state from outside the step loop
        calls it first. Returns the dispatches drained: 0 when the
        window is empty, and always at ``harvest_every=1``.
        Finalizations go to the backlog that the next step() returns."""
        n = len(self._pending)
        if n:
            self._harvest_pending(self._finished_backlog)
        return n

    def profile_round(self) -> List[Dict[str, object]]:
        """≙ :3730-3775: a dispatch-gap sample of ONE decode step. The
        decode body runs eagerly — a fresh program, never cached,
        captured or replayed — twice: once untimed, then under
        `profile.gap_sampler`, whose `profile.fence` hooks in the model
        synchronize the card at every op-family boundary
        (`models/llama.py`). Returns the ranked gap table (rows of
        {op_pair, gap_s, device_s, count}, summed over layers) and sets
        ``pdt_profile_gap_seconds{op_pair}``.

        Observation only: the window is quiesced first (k > 1), the
        passes draw with a constant key (the sampling counter does not
        move), and their tokens are discarded. The body scatters K/V in
        place: each active slot's row at its next position, the row the
        next decode step (or a spec round's verify) writes again before
        any attention reads it, and the inactive slots' rows into the
        trash page; so every later stream is bitwise what it would have
        been. Paged ragged engines only."""
        if self.layout != "paged" or self.attn_impl != "ragged":
            raise RuntimeError(
                "profile_round requires the paged+ragged decode path "
                f"(layout={self.layout!r}, attn_impl={self.attn_impl!r})")
        self.quiesce()
        if not any(r is not None for r in self._slot_req):
            raise RuntimeError("profile_round needs >= 1 active slot")
        prog = self._build_ragged(self.B, 1)
        pos = np.clip(self._pos, 0, self.S - 1).astype(np.int32)
        idx = np.arange(self.B, dtype=np.int32)
        self._upload(self._tok, idx, pos, self._slot_adapter, idx,
                     np.ones(self.B, np.int32), pos + 1, idx, self._bt,
                     self._NO_KEY, dst=prog.flat)
        prog.body()            # untimed: first-use work stays out of the gaps
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with _profile.gap_sampler() as sampler:
            prog.body()
        return sampler.table()
