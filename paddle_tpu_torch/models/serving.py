"""Continuous-batching greedy serving over a paged KV cache.

≙ `paddle_tpu/models/serving.py`: `EngineOverloaded` / `PoolExhausted` /
`EngineInvariantError` / `ModelMismatch` :322-369, `Request` :457, and
the parts of `ContinuousBatchingEngine` that serve greedy requests over
``kv_layout="paged"``: construction :502-931 (paged subset),
`add_request` / `run` / `step` :1307-1488, the paged `check_invariants`
:2069-2176 with its adapter checks, `_finalize` / `_release_slot`
:2284-2350, admission :2394-2470 and :2594-2763 (one packed ragged
dispatch per batch, with `prefill_chunk` chunk continuations), the page
allocator :2852-3110 (trash page 0, refcounts, worst-case reservation)
and the synchronous decode step with lazy page growth and preemption
:3268-3565. Quantized serving (≙ `QUANT_MATMULS` / `QuantServingConfig`
:401-453, the ``quant=`` check :561-571, the int8 page and scale pools
:668-693, `_build_quant_weights` :930-964 without tensor parallelism,
and the paged part of `cache_memory_info` :2034-2060 without the prefix
fields). Multi-model serving (≙ `install_adapter` / `evict_adapter` /
`install_weights` / `reset_weights` / `_adapter_row` / `_lora_pv`
:972-1304, `add_request(adapter=)` :1334-1339 and the slot-to-adapter
map). The legacy paged path, ``attention_impl="legacy"`` (≙ `_bucket` /
`_build_prefill` :2347-2392, the `_admit` loop :2472-2561 without its
prefix-cache branch, `_paged_insert` / `_build_scatter` :3079-3102 and
the paged `_build_decode` :3241-3266).

With ``attention_impl="ragged"`` (the default) each admission batch and
each decode step is ONE ragged dispatch: the packed token axis runs
through `LlamaForCausalLM.forward` with one `RaggedKVCacheView` per
layer, whose attention writes the new K/V rows into the page pools in
place and launches the ragged paged attention kernel. With
``"legacy"`` each admitted request gets its own prefill dispatch over
its prompt padded to a ``prompt_pad`` bucket, whose K/V rows are then
scattered into its pages, and a decode step is one dispatch of (B, 1)
tokens whose attention launches the q = 1 paged attention kernel.
PyTorch runs eagerly, so there is no program cache: the JAX engine's
jit families keyed on (padded tokens, pages bound) and its prefill and
scatter buckets have no counterpart here.

Every constructor option outside this subset raises NotImplementedError
naming the ROADMAP.md item that will port it.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ops import resolve_device
from ..ops.lora_epilogue import LoraWeight
from ..ops.paged_attention import paged_prefill_scatter
from ..ops.quant_matmul import QuantizedWeight, quantize_weight_values
from ..ops.ragged_paged_attention import pack_ragged_batch
from .generation import RequestStatus, _sample_token
from .llama import PagedKVCacheView, RaggedKVCacheView


class EngineOverloaded(RuntimeError):
    """add_request refused: the bounded admission queue is full or the
    admission policy rejected the request."""


class PoolExhausted(RuntimeError):
    """A KV page allocation could not be satisfied. Admission
    reservation makes this unreachable on the healthy path; decode-time
    growth turns it into preemption."""


class EngineInvariantError(AssertionError):
    """check_invariants() found inconsistent page accounting."""


class ModelMismatch(ValueError):
    """A request names a LoRA adapter that is not resident in this
    engine's stacks. Raised by `add_request` before the request is
    queued; the fleet model store (`serving.model_store`) installs the
    adapter before it routes a request there."""


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


# constructor options of the JAX engine that this port does not have
# yet: (argument, the value that means "off", ROADMAP.md queue A item)
_UNPORTED_OPTIONS = (
    ("do_sample", False, "9 (sampling)"),
    ("enable_prefix_caching", False, "6a (prefix caching)"),
    ("max_prefix_entries", 32, "6a (prefix caching)"),
    ("request_timeout", None, "6b (deadlines and timeouts)"),
    ("max_queue_time", None, "6b (deadlines and timeouts)"),
    ("harvest_every", 1, "6c (pipelined decode)"),
    ("max_prefill_programs", 8, "6d (CUDA-graph dispatch cache)"),
    ("max_decode_retries", 3, "5 (fault points and telemetry)"),
    ("spec_decode", None, "9 (speculative decoding)"),
    ("submesh", None, "12 (tensor parallelism)"),
)


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


class ContinuousBatchingEngine:
    """In-flight batched greedy serving for `LlamaForCausalLM`.

    Runs on the CUDA card unless ``device`` names another device; the
    model must live on that device. The KV page pools take the model's
    parameter dtype, or int8 with f32 scale pools under
    ``quant=QuantServingConfig(kv="int8")``. ``attention_impl`` picks
    the ragged dispatch (default) or the legacy paged path (module
    docstring); ``prompt_pad`` is the legacy prefill's bucket step and
    the ragged admission's pad. ``temperature`` / ``top_k`` / ``top_p``
    / ``seed`` act only with sampling, which is not ported, so a greedy
    engine ignores them as the JAX engine does."""

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
                 device=None):
        given = dict(locals())
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
        if kv_layout != "paged":
            _not_ported(f"kv_layout={kv_layout!r}",
                        "3b (dense and legacy attention paths)")
        if attention_impl == "legacy" and prefill_chunk:
            _not_ported("attention_impl='legacy' with prefill_chunk",
                        "3b (dense and legacy attention paths)")
        for name, off, item in _UNPORTED_OPTIONS:
            if given[name] != off:
                _not_ported(f"{name}={given[name]!r}", item)
        cfg = model.config
        dev = resolve_device(device)
        mdev = model.device
        if dev.type != mdev.type or (dev.index is not None
                                     and dev.index != mdev.index):
            raise ValueError(f"engine device {dev} but the model lives "
                             f"on {mdev}")
        self.device = mdev
        self.model = model
        self._params = dict(model.named_parameters())
        self.attn_impl = attention_impl
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
        self.page_size = int(page_size)
        self.pps = -(-self.S // self.page_size)
        # +1: page 0 is the reserved trash page
        self.num_pages = int(num_pages or self.B * self.pps + 1)
        if self.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        hk, hd = cfg.num_key_value_heads, cfg.head_dim
        dt = next(model.parameters()).dtype
        self._qw_mode = quant.weights if quant is not None else None
        self._qkv = quant.kv if quant is not None else None
        self._kv_shape = (cfg.num_hidden_layers, hk, hd, dt)
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
        self._kv = [pools() for _ in range(cfg.num_hidden_layers)]
        # the quantized weights handed to every dispatch, and their count
        # and bytes (the JAX engine's ``pdt_quant_weight_*`` gauges;
        # telemetry is not ported yet)
        self._qweights = self._build_quant_weights() if self._qw_mode \
            else None
        qws = (self._qweights or {}).values()
        self.quant_weight_layers = len(qws)
        self.quant_weight_bytes = sum(w.nbytes for w in qws)
        self._bt = np.zeros((self.B, self.pps), np.int32)
        self._free: List[int] = list(range(1, self.num_pages))
        self._slot_pages: List[List[int]] = [[] for _ in range(self.B)]
        self._slot_reserved = np.zeros(self.B, np.int64)
        # pages ever attached: the next block-table index to fill; stays
        # monotonic after window reclamation frees leading pages
        self._slot_next_idx = np.zeros(self.B, np.int64)
        self._slot_freed = np.zeros(self.B, np.int64)
        self._page_rc = np.zeros(self.num_pages, np.int32)
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
        # host-side slot state
        self._pos = np.zeros(self.B, np.int32)       # next write position
        self._tok = np.zeros(self.B, np.int32)       # last emitted token
        self._slot_req: List[Optional[Request]] = [None] * self.B
        self._queue: List[Request] = []
        self._next_rid = 0
        self.max_waiting = None if max_waiting is None else int(max_waiting)
        self.max_preemptions = int(max_preemptions)
        self.admission_policy = admission_policy
        self._clock = clock if clock is not None else time.monotonic
        self.num_preemptions = 0
        self._finished_backlog: List[Request] = []
        self._admit_seq = 0
        self._slot_seq = np.zeros(self.B, np.int64)
        self._ragged_block_q = 8
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
        # the JAX engine's ``pdt_lora_*`` counters (telemetry is not
        # ported yet; the two gauges are the properties below)
        self.lora_installs = 0
        self.lora_evictions = 0
        # dispatch accounting: every dispatch runs each layer's attention
        # once and every RMSNorm once
        self.num_admission_dispatches = 0
        self.num_decode_dispatches = 0
        self.decode_seconds = 0.0      # host wall of decode dispatches,
        self.decode_tokens = 0         # each ending in its D2H token copy
        self.admission_seconds = 0.0   # host wall of admission dispatches
        self.admission_tokens = 0      # prompt tokens they prefilled

    # -- public API ----------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int = 32,
                    deadline: Optional[float] = None,
                    max_queue_time: Optional[float] = None,
                    request_id: Optional[str] = None,
                    priority: int = 0, adapter: Optional[str] = None
                    ) -> int:
        """Queue a request; returns its engine-local id. ``priority`` is
        the queue class (lower admits first, FIFO within a class).
        ``adapter`` decodes the request under a resident LoRA adapter
        (`install_adapter`); one that is not resident raises
        ModelMismatch before anything is queued. Raises
        EngineOverloaded when the bounded queue is full (`max_waiting`)
        or the admission policy rejects the request."""
        if deadline is not None or max_queue_time is not None:
            _not_ported("per-request deadlines", "6b (deadlines and "
                        "timeouts)")
        toks = [int(t) for t in np.asarray(prompt).ravel()]
        if not toks:
            raise ValueError("empty prompt")
        if adapter is not None and adapter not in self._adapter_rows:
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
            raise EngineOverloaded(
                f"admission queue full ({self.max_waiting} waiting) — "
                "shed load or retry after in-flight requests drain")
        now = self._clock()
        r = Request(self._next_rid, toks, int(max_new_tokens),
                    enqueue_time=now, arrival_time=now,
                    request_id=request_id if request_id is not None
                    else str(self._next_rid), priority=int(priority),
                    adapter=adapter)
        need = self._worst_pages(r)
        if need > self.num_pages - 1:
            raise ValueError(
                f"request needs up to {need} KV pages (prompt {len(toks)} "
                f"+ max_new_tokens {max_new_tokens} at page_size "
                f"{self.page_size}) but the pool has only "
                f"{self.num_pages - 1} usable pages; raise num_pages")
        if self.admission_policy is not None \
                and not self.admission_policy(self, r):
            raise EngineOverloaded(
                f"admission policy rejected request (prompt {len(toks)} "
                f"tokens, max_new_tokens {max_new_tokens})")
        self._next_rid += 1
        idx = len(self._queue)
        while idx > 0 and self._queue[idx - 1].priority > r.priority:
            idx -= 1
        self._queue.insert(idx, r)
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
        """Admit waiting requests into free slots (one ragged dispatch
        per admission batch; legacy: one prefill dispatch per request),
        decode ONE token for every active slot (one dispatch), release
        finished slots. Returns the requests that reached a terminal
        state this step."""
        finished = self._finished_backlog
        self._finished_backlog = []
        try:
            finished += self._admit_ragged() if self.attn_impl == "ragged" \
                else self._admit_legacy()
            active = [i for i, r in enumerate(self._slot_req)
                      if r is not None]
            if active:
                self._decode(finished)
                for i in active:
                    r = self._slot_req[i]
                    if r is None:
                        continue        # preempted during decode
                    tok = int(self._tok[i])
                    r.output.append(tok)
                    if (self.eos is not None and tok == self.eos) \
                            or len(r.output) >= r.max_new_tokens \
                            or int(self._pos[i]) >= self.S - 1:
                        self._finalize(r, RequestStatus.FINISHED, None,
                                       finished)
                        self._release_slot(i)
        except BaseException:
            # requests finalized this step are delivered by the next one
            self._finished_backlog = finished
            raise
        if _invariants_enabled():
            self.check_invariants()
        return finished

    @property
    def num_dispatches(self) -> int:
        return self.num_admission_dispatches + self.num_decode_dispatches

    def cache_memory_info(self) -> Dict[str, object]:
        """KV-cache device-memory accounting of the page pools:
        ``bytes_in_use`` is proportional to the pages allocated. With
        int8 pages ``page_bytes`` is the honest bill of one page across
        all layers: int8 storage plus the f32 scale rows of both
        pools."""
        L, hk, hd, dt = self._kv_shape
        if self._qkv:
            page_bytes = self.page_size * hk * hd * 2 * L \
                + self.page_size * 4 * 2 * L
        else:
            itemsize = torch.empty((), dtype=dt).element_size()
            page_bytes = self.page_size * hk * hd * itemsize * 2 * L
        usable = self.num_pages - 1
        in_use = usable - len(self._free)
        return {"layout": "paged", "page_bytes": page_bytes,
                "kv_quant": self._qkv,
                "total_pages": usable, "pages_in_use": in_use,
                "bytes_pool": self.num_pages * page_bytes,
                "bytes_in_use": in_use * page_bytes,
                "utilization": in_use / max(usable, 1)}

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
        with ``prefill_chunk``, as the JAX engine does (its prefix
        caching and spec decode, which it also refuses, are not ported:
        the constructor refuses them)."""
        if self.attn_impl != "ragged":
            raise ValueError(
                "install_adapter requires kv_layout='paged' with "
                "attention_impl='ragged' — the per-token adapter-row "
                "vector threads through the ragged dispatch family only")
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
        if _invariants_enabled():
            self.check_invariants()

    def evict_adapter(self, adapter_id: str) -> None:
        """Evict a resident adapter: its stack row is zeroed in place
        and returns to the free-row list (stacks never shrink; a zeroed
        row is inert by the row-0 argument). REFUSES while any queued or
        running request decodes under the adapter, so an eviction never
        strands a request. Dropping the last adapter drops the stacks,
        and dispatches return to the unadapted weights."""
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
        weights. Resident adapters drop with the base they adapted."""
        self._require_idle("install_weights")
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

    def reset_weights(self) -> None:
        """Drop an install_weights override: dispatches return to the
        build-time weights (``model_tag`` None). Idle-only, like
        install_weights, and for the same reason."""
        self._require_idle("reset_weights")
        self._mpv = None
        self.model_tag = None
        self._drop_adapters()

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

    # -- invariants ----------------------------------------------------
    def check_invariants(self):
        """Page accounting: every page's refcount equals its holder
        count, the free list is duplicate-free and is exactly the rc==0
        pages, released slots hold nothing, and each active slot's live
        block-table window points only at allocated pages while all else
        trash-routes to page 0. Raises EngineInvariantError listing
        every violation."""
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
                              or np.any(self._bt[i] != 0)):
                errs.append(f"released slot {i} still holds pages "
                            f"{self._slot_pages[i]} or a nonzero "
                            "block-table row")
            for p in self._slot_pages[i]:
                expected[p] += 1
        for p in range(1, self.num_pages):
            rc = int(self._page_rc[p])
            if rc != int(expected[p]):
                errs.append(f"page {p}: refcount {rc} != "
                            f"{int(expected[p])} holders")
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

    # -- request lifecycle ---------------------------------------------
    def _finalize(self, req: Request, status: str, error: Optional[str],
                  finished: List[Request]):
        """The one place a request enters a terminal state."""
        req.done = True
        req.status = status
        req.error = error
        finished.append(req)

    def _effective_prompt(self, req: Request) -> List[int]:
        """What admission prefills: the prompt plus everything already
        generated (a preempted request resumes by re-prefilling)."""
        return req.prompt + req.output if req.output else req.prompt

    def _release_slot(self, slot: int):
        self._slot_req[slot] = None
        self._slot_adapter[slot] = 0
        for p in self._slot_pages[slot]:
            self._decref(p)
        self._slot_pages[slot] = []
        self._slot_reserved[slot] = 0
        self._slot_next_idx[slot] = 0
        self._slot_freed[slot] = 0
        # inactive slots keep decoding garbage; their block-table row
        # must point at the trash page, not at reclaimed pages
        self._bt[slot] = 0

    def _requeue_or_starve(self, req: Request, finished: List[Request]):
        """Requeue a preempted request at the head of its priority
        class, or finalize it PREEMPTED past `max_preemptions`."""
        self.num_preemptions += 1
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
        re-enters the queue with its tokens folded into the prompt.
        Returns the released slot, or None if nothing runs."""
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

    def _reserve_ok(self, req: Request) -> bool:
        """Admit only if the request's worst-case page demand fits the
        pool net of the other slots' reserved-but-unallocated pages, so
        lazy growth can never fail mid-flight."""
        outstanding = int(sum(
            self._slot_reserved[i] - self._slot_next_idx[i]
            for i, r in enumerate(self._slot_req) if r is not None))
        return len(self._free) >= self._worst_pages(req) + outstanding

    def _incref(self, page: int):
        self._page_rc[page] += 1

    def _decref(self, page: int):
        self._page_rc[page] -= 1
        if self._page_rc[page] == 0:
            self._free.append(page)

    def _alloc_page(self, slot: int) -> int:
        if not self._free:
            raise PoolExhausted(
                f"KV page pool exhausted ({self.num_pages - 1} usable "
                "pages, none free)")
        page = self._free.pop()
        self._page_rc[page] = 1
        self._slot_pages[slot].append(page)
        self._bt[slot, self._slot_next_idx[slot]] = page
        self._slot_next_idx[slot] += 1
        return page

    def _reserve_and_alloc(self, slot: int, req: Request, p_len: int):
        """Record the slot's worst-case reservation and allocate the
        pages covering the prompt."""
        self._slot_reserved[slot] = self._worst_pages(req)
        while self._slot_next_idx[slot] * self.page_size < p_len:
            self._alloc_page(slot)

    def _pages_bound(self, contexts) -> int:
        """Power-of-two bucketed bound on the pages a dispatch reads:
        the plain attention's gather trim."""
        need = max(-(-int(c) // self.page_size) for c in contexts)
        return min(1 << max(need - 1, 0).bit_length(), self.pps)

    def _grow_slot(self, slot: int, finished: List[Request]) -> bool:
        """Lazy page growth for `slot`'s next decode write. On pool
        exhaustion (reachable only through an accounting fault, since
        admission reserves the worst case) preempt the youngest running
        request and retry. Returns False if `slot` itself was
        preempted."""
        while self._slot_next_idx[slot] * self.page_size \
                <= int(self._pos[slot]):
            try:
                self._alloc_page(slot)
            except PoolExhausted:
                victim = self._preempt_youngest(finished)
                if victim is None:
                    raise
                if victim == slot:
                    return False
        return True

    # -- admission -------------------------------------------------------
    def _claim_candidate(self, free):
        """Peek the queue head, check its worst-case reservation, claim
        a slot. Returns (slot, req, prompt), or None when the head must
        wait for pages (FIFO: stop admitting)."""
        req = self._queue[0]
        if not self._reserve_ok(req):
            return None
        slot = free.pop(0)
        self._queue.pop(0)
        self._slot_req[slot] = req
        req.status = RequestStatus.RUNNING
        self._slot_adapter[slot] = self._adapter_row(req)
        self._slot_seq[slot] = self._admit_seq
        self._admit_seq += 1
        return slot, req, self._effective_prompt(req)

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
        """Host half of admission: reservation, slot and page
        allocation. Returns the entries to pack."""
        entries = []
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        while free and self._queue:
            claim = self._claim_candidate(free)
            if claim is None:
                break
            slot, req, prompt = claim
            try:
                self._reserve_and_alloc(slot, req, len(prompt))
            except PoolExhausted:
                self._release_slot(slot)
                free.insert(0, slot)
                self._requeue_or_starve(req, finished)
                if req.done:
                    continue        # starved out: try the next request
                break
            entries.append({"slot": slot, "req": req, "tokens": prompt,
                            "offset": 0})
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
        nxt = self._ragged_step(pk["ids"], pk["token_seq"],
                                pk["positions"], pk["query_start"],
                                pk["query_len"], pk["context_len"],
                                pk["sample_rows"], bq, bound)
        self.admission_seconds += time.perf_counter() - t0
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
            if req.first_token_time is None:
                req.first_token_time = self._clock()
            if (self.eos is not None and tok == self.eos) \
                    or len(req.output) >= req.max_new_tokens:
                self._finalize(req, RequestStatus.FINISHED, None,
                               finished)
                self._release_slot(s)
                freed = True
        return freed

    # -- legacy admission ------------------------------------------------
    def _bucket(self, n: int) -> int:
        """The prefill length of an n-token prompt: n rounded up to a
        multiple of ``prompt_pad``, clamped to the cache."""
        return min(-(-n // self.pad) * self.pad, self.S)

    def _admit_legacy(self) -> List[Request]:
        """≙ `_admit` :2472-2561 without its prefix-cache branch: claim a
        slot per queued request, run its own bucketed prefill dispatch,
        reserve and allocate its pages and scatter its K/V rows into
        them. A failed page allocation backs the slot out and requeues
        the request (or starves it out)."""
        finished: List[Request] = []
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        while free and self._queue:
            claim = self._claim_candidate(free)
            if claim is None:
                break                      # FIFO: wait for pages to free
            slot, req, prompt = claim
            p_len = len(prompt)
            t0 = time.perf_counter()
            tok, rows = self._legacy_prefill(prompt, self._bucket(p_len))
            self.num_admission_dispatches += 1
            try:
                self._paged_insert(slot, req, p_len, rows)
            except PoolExhausted:
                self.admission_seconds += time.perf_counter() - t0
                self._release_slot(slot)
                free.insert(0, slot)
                self._requeue_or_starve(req, finished)
                if req.done:
                    continue               # starved out: try the next
                break
            self.admission_seconds += time.perf_counter() - t0
            self.admission_tokens += p_len
            self._pos[slot] = p_len
            self._tok[slot] = tok
            req.output.append(tok)
            if req.first_token_time is None:
                req.first_token_time = self._clock()
            if (self.eos is not None and tok == self.eos) \
                    or len(req.output) >= req.max_new_tokens:
                self._finalize(req, RequestStatus.FINISHED, None, finished)
                self._release_slot(slot)
                free.insert(0, slot)
        return finished

    def _legacy_prefill(self, prompt: List[int], bucket: int):
        """≙ `_build_prefill`: a causal pass over the prompt padded to
        ``bucket`` tokens, with the padded tail masked out as keys,
        into per-layer (1, bucket, HK, D) caches. Returns the first
        token (greedy, from the last real row; the step's sync point)
        and each layer's (k_rows, v_rows), (bucket, HK, D)."""
        p_len = len(prompt)
        L, hk, hd, dt = self._kv_shape
        ids = np.zeros(bucket, np.int32)
        ids[:p_len] = prompt
        ids_d, row_d = self._upload(ids, [p_len - 1])
        with torch.no_grad():
            caches = [tuple(torch.zeros(1, bucket, hk, hd, dtype=dt,
                                        device=self.device)
                            for _ in range(2)) for _ in range(L)]
            valid = (torch.arange(bucket, device=self.device) < p_len)[None]
            logits = self.model(ids_d[None], caches, rows=row_d,
                                weights=self._dispatch_weights(),
                                attention_mask=valid, position_offset=0)
            tok = int(_sample_token(logits)[0])
        return tok, [(k[0], v[0]) for k, v in caches]

    def _paged_insert(self, slot: int, req: Request, p_len: int, rows):
        """≙ `_paged_insert` / `_build_scatter`: reserve and allocate the
        slot's pages, then scatter its prefilled rows into every layer's
        pools (the bucket's padding rows to trash page 0)."""
        self._reserve_and_alloc(slot, req, p_len)
        (bt_row,) = self._upload(self._bt[slot])
        with torch.no_grad():
            for pools, (rk, rv) in zip(self._kv, rows):
                paged_prefill_scatter(pools[0], pools[1], rk, rv, bt_row,
                                      p_len)

    def _legacy_decode_step(self, tok, pos) -> np.ndarray:
        """≙ the paged `_build_decode`: ONE dispatch of (B, 1) tokens, each
        slot at its own position, through a `PagedKVCacheView` per layer
        (the attention appends the new K/V rows and launches the paged
        attention kernel), greedy tokens copied to the host."""
        tok_d, pos_d, bt_d = self._upload(tok, pos, self._bt)
        with torch.no_grad():
            views = [PagedKVCacheView(pools[0], pools[1], bt_d)
                     for pools in self._kv]
            logits = self.model(tok_d[:, None], views,
                                weights=self._dispatch_weights(),
                                position_offset=pos_d)
            return _sample_token(logits[:, 0]).cpu().numpy()

    # -- the ragged dispatch ---------------------------------------------
    def _ragged_step(self, ids, token_seq, positions, query_start,
                     query_len, context_len, sample_rows, block_q,
                     pages_bound=None) -> np.ndarray:
        """ONE ragged dispatch: packed ids -> per-token rope -> one KV
        scatter into the pages per layer -> ragged paged attention ->
        logits of each slot's sample row -> greedy tokens, copied to
        the host (the step's sync point). Rows whose ``sample_rows``
        entry is out of range are clamped and never read back."""
        t = len(ids)
        # multi-LoRA: each packed row takes its owning slot's adapter row
        # (a padding row's token_seq -1 takes the last slot's: inert, its
        # output is never read and the epilogue sums across no tokens)
        adapter_rows = self._slot_adapter[np.asarray(token_seq, np.int64)]
        # one host-to-device copy for every index array of the dispatch
        ids_d, seq_d, pos_d, qs_d, ql_d, cl_d, rows_d, ad_d, bt_d = \
            self._upload(ids, token_seq, positions, query_start, query_len,
                         context_len, sample_rows, adapter_rows, self._bt)
        with torch.no_grad():
            views = [RaggedKVCacheView(pools[0], pools[1], bt_d, seq_d,
                                       pos_d, qs_d, ql_d, cl_d, block_q,
                                       pages_bound, *pools[2:])
                     for pools in self._kv]
            logits = self.model(ids_d[None], views,
                                rows=rows_d.clamp(0, t - 1),
                                weights=self._dispatch_weights(ad_d))
            return _sample_token(logits).cpu().numpy()

    def _upload(self, *arrays):
        """Copy int32 host arrays to the device in ONE transfer; returns
        a device view of each, in its shape."""
        arrays = [np.asarray(a, np.int32) for a in arrays]
        flat = torch.from_numpy(np.concatenate(
            [a.ravel() for a in arrays])).to(self.device)
        out, at = [], 0
        for a in arrays:
            out.append(flat[at:at + a.size].view(a.shape))
            at += a.size
        return out

    # -- decode ------------------------------------------------------------
    def _decode(self, finished: List[Request]):
        """One batched decode step for every slot: the same ragged
        dispatch at block_q = 1, one query row per slot, or the legacy
        (B, 1) dispatch through the paged attention. Inactive slots
        decode garbage at a clamped position; their block-table rows are
        all trash page, so their KV lands in page 0 (never read) and
        their tokens are never read back."""
        for i, r in enumerate(self._slot_req):
            if r is None:
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
        n_active = sum(r is not None for r in self._slot_req)
        if not n_active:
            return                    # every slot preempted away
        pos = np.clip(self._pos, 0, self.S - 1).astype(np.int32)
        idx = np.arange(self.B, dtype=np.int32)
        t0 = time.perf_counter()
        if self.attn_impl == "ragged":
            nxt = self._ragged_step(self._tok, idx, pos, idx,
                                    np.ones(self.B, np.int32), pos + 1, idx,
                                    1)
        else:
            nxt = self._legacy_decode_step(self._tok, pos)
        self.decode_seconds += time.perf_counter() - t0
        self.decode_tokens += n_active
        self.num_decode_dispatches += 1
        for i, r in enumerate(self._slot_req):
            if r is not None:
                self._tok[i] = nxt[i]
                self._pos[i] += 1
