"""Continuous-batching greedy serving over a paged KV cache, ragged path.

≙ `paddle_tpu/models/serving.py`: `EngineOverloaded` / `PoolExhausted` /
`EngineInvariantError` :322-336, `Request` :457, and the parts of
`ContinuousBatchingEngine` that serve greedy requests with its defaults,
``kv_layout="paged"`` and ``attention_impl="ragged"``: construction
:502-931 (paged subset), `add_request` / `run` / `step` :1307-1488, the
paged `check_invariants` :2069-2176, `_finalize` / `_release_slot`
:2284-2350, admission :2394-2470 and :2594-2763 (one packed ragged
dispatch per batch, with `prefill_chunk` chunk continuations), the page
allocator :2852-3110 (trash page 0, refcounts, worst-case reservation)
and the synchronous ragged decode step with lazy page growth and
preemption :3268-3565. Quantized serving (≙ `QUANT_MATMULS` /
`QuantServingConfig` :401-453, the ``quant=`` check :561-571, the int8
page and scale pools :668-693, `_build_quant_weights` :930-964 without
tensor parallelism, and the paged part of `cache_memory_info`
:2034-2060 without the prefix fields).

Each admission batch and each decode step is ONE ragged dispatch: the
packed token axis runs through `LlamaForCausalLM.forward` with one
`RaggedKVCacheView` per layer, whose attention writes the new K/V rows
into the page pools in place and launches the ragged paged attention
kernel. PyTorch runs eagerly, so there is no program cache: the JAX
engine's jit families keyed on (padded tokens, pages bound) have no
counterpart here.

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
from ..ops.quant_matmul import QuantizedWeight, quantize_weight_values
from ..ops.ragged_paged_attention import pack_ragged_batch
from .generation import RequestStatus, _sample_token
from .llama import RaggedKVCacheView


class EngineOverloaded(RuntimeError):
    """add_request refused: the bounded admission queue is full or the
    admission policy rejected the request."""


class PoolExhausted(RuntimeError):
    """A KV page allocation could not be satisfied. Admission
    reservation makes this unreachable on the healthy path; decode-time
    growth turns it into preemption."""


class EngineInvariantError(AssertionError):
    """check_invariants() found inconsistent page accounting."""


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


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A, item {item})")


class ContinuousBatchingEngine:
    """In-flight batched greedy serving for `LlamaForCausalLM`.

    Runs on the CUDA card unless ``device`` names another device; the
    model must live on that device. The KV page pools take the model's
    parameter dtype, or int8 with f32 scale pools under
    ``quant=QuantServingConfig(kv="int8")``. ``temperature`` /
    ``top_k`` / ``top_p`` / ``seed`` act only with sampling, which is
    not ported, so a greedy engine ignores them as the JAX engine
    does."""

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
        if kv_layout != "paged" or attention_impl != "ragged":
            _not_ported(f"kv_layout={kv_layout!r} with attention_impl="
                        f"{attention_impl!r}",
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
        # dispatch accounting: every ragged dispatch runs each layer's
        # attention once and every RMSNorm once
        self.num_admission_dispatches = 0
        self.num_decode_dispatches = 0
        self.decode_seconds = 0.0      # host wall of decode dispatches,
        self.decode_tokens = 0         # each ending in its D2H token copy

    # -- public API ----------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int = 32,
                    deadline: Optional[float] = None,
                    max_queue_time: Optional[float] = None,
                    request_id: Optional[str] = None,
                    priority: int = 0, adapter: Optional[str] = None
                    ) -> int:
        """Queue a request; returns its engine-local id. ``priority`` is
        the queue class (lower admits first, FIFO within a class).
        Raises EngineOverloaded when the bounded queue is full
        (`max_waiting`) or the admission policy rejects the request."""
        if deadline is not None or max_queue_time is not None:
            _not_ported("per-request deadlines", "6b (deadlines and "
                        "timeouts)")
        if adapter is not None:
            _not_ported("LoRA adapters", "8 (multi-LoRA)")
        toks = [int(t) for t in np.asarray(prompt).ravel()]
        if not toks:
            raise ValueError("empty prompt")
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
                    else str(self._next_rid), priority=int(priority))
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
        per admission batch), decode ONE token for every active slot
        (one ragged dispatch), release finished slots. Returns the
        requests that reached a terminal state this step."""
        finished = self._finished_backlog
        self._finished_backlog = []
        try:
            finished += self._admit_ragged()
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
        if os.environ.get("PDT_CHECK_INVARIANTS") == "1":
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
        if errs:
            raise EngineInvariantError(
                "engine invariant violations:\n  " + "\n  ".join(errs))

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
        nxt = self._ragged_step(pk["ids"], pk["token_seq"],
                                pk["positions"], pk["query_start"],
                                pk["query_len"], pk["context_len"],
                                pk["sample_rows"], bq, bound)
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
        # one host-to-device copy for every index array of the dispatch
        parts = [ids, token_seq, positions, query_start, query_len,
                 context_len, sample_rows, self._bt.ravel()]
        flat = torch.from_numpy(np.concatenate(
            [np.asarray(a, np.int32) for a in parts])).to(self.device)
        cut = np.cumsum([0] + [len(a) for a in parts[:-1]])
        (ids_d, seq_d, pos_d, qs_d, ql_d, cl_d, rows_d) = (
            flat[a:b] for a, b in zip(cut[:-1], cut[1:]))
        bt_d = flat[cut[-1]:].view(self.B, self.pps)
        with torch.no_grad():
            views = [RaggedKVCacheView(pools[0], pools[1], bt_d, seq_d,
                                       pos_d, qs_d, ql_d, cl_d, block_q,
                                       pages_bound, *pools[2:])
                     for pools in self._kv]
            logits = self.model(ids_d[None], views,
                                rows=rows_d.clamp(0, t - 1),
                                weights=self._qweights)
            return _sample_token(logits).cpu().numpy()

    # -- decode ------------------------------------------------------------
    def _decode(self, finished: List[Request]):
        """One batched decode step for every slot: the same ragged
        dispatch at block_q = 1, one query row per slot. Inactive slots
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
        nxt = self._ragged_step(self._tok, idx, pos, idx,
                                np.ones(self.B, np.int32), pos + 1, idx, 1)
        self.decode_seconds += time.perf_counter() - t0
        self.decode_tokens += n_active
        self.num_decode_dispatches += 1
        for i, r in enumerate(self._slot_req):
            if r is not None:
                self._tok[i] = nxt[i]
                self._pos[i] += 1
