"""Fleet-wide prefix store: shared warmth and a host-RAM spill tier for
KV chains.

≙ `paddle_tpu/serving/prefix_store.py`, whole. The engines cache
PAGE-ALIGNED token prefixes (`models.serving`); the store keeps the
fleet's view of them:

* **Warmth**: every chain hash (a rolling hash per FULL page, h_f =
  hash((h_{f-1}, page f's tokens)), the engine trie's shape) maps to the
  replicas believed to hold it warm.
* **Host-RAM spill**: cold chains keep their KV page content in host
  memory under a byte budget. A migration already serializes a
  request's prompt pages to the host (`serving.transfer`), so spilling
  them is bookkeeping; the next request with that prefix re-installs
  the spilled pages (`engine.import_prefix`) instead of prefilling
  them again. Spill entries are LRU-bounded by ``spill_budget_bytes``
  (content dropped, warmth records kept).

The store is host state: no device memory, no threads, deterministic
given the call sequence; it needs nothing of a router. Spilled content
is held as CPU torch tensors (views of the payload's). Telemetry rides
the ``pdt_prefix_store_*`` series, and
`observability.profile.memory_ledger(prefix_store=)` reads `stats()`.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import torch

from .. import observability as telemetry
from ..models.serving import _host_tensor, assemble_payload_kv

__all__ = ["FleetPrefixStore", "chain_hashes"]


_M_CHAINS = telemetry.gauge(
    "pdt_prefix_store_chains",
    "Chains tracked by the fleet prefix store.")
_M_SPILL_BYTES = telemetry.gauge(
    "pdt_prefix_store_spilled_bytes",
    "Host-RAM bytes held by spilled chain KV content.")
_M_HITS = telemetry.counter(
    "pdt_prefix_store_hits_total",
    "Store lookups that found the prefix warm, by source "
    "(replica = routed to a warm replica, spill = re-installed from "
    "host RAM).", ("source",))
_M_MISSES = telemetry.counter(
    "pdt_prefix_store_misses_total",
    "Store lookups that found the prefix nowhere in the fleet.")
_M_EVICTIONS = telemetry.counter(
    "pdt_prefix_store_evictions_total",
    "Chain records or spill payloads evicted under the store bounds.")


def chain_hashes(prompt: Sequence[int], page_size: int) -> List[int]:
    """Rolling hash per FULL page of ``prompt``, capped one page short of
    the whole prompt (the engine never shares the final token: its
    logits give the first token), as the engine trie and
    `ContinuousBatchingEngine._match_prefix` cap it. Hashes of tuples of
    ints, so equal to the JAX package's for the same tokens."""
    ps = int(page_size)
    n = (len(prompt) - 1) // ps
    hashes, h = [], 0
    for f in range(n):
        h = hash((h, tuple(int(t) for t in prompt[f * ps:(f + 1) * ps])))
        hashes.append(h)
    return hashes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class FleetPrefixStore:
    """Fleet-wide chain warmth and host-RAM spill (module docstring).

    One entry per chain hash, LRU-ordered: ``replicas`` is the set of
    replica indices believed warm; a spilled entry also carries its
    page's token tuple and per-layer KV content (host tensors).
    ``max_chains`` bounds the entries; ``spill_budget_bytes`` bounds the
    content bytes (evicting content keeps the warmth record)."""

    def __init__(self, page_size: int, max_chains: int = 4096,
                 spill_budget_bytes: int = 32 << 20):
        self.page_size = int(page_size)
        self.max_chains = int(max_chains)
        self.spill_budget_bytes = int(spill_budget_bytes)
        # hash -> {"parent": hash|None, "replicas": set, "tokens":
        # tuple|None, "kv": [(k, v)]|None, "bytes": int, "scales":
        # [(ks, vs)]|None, "quant": str|None}
        self._chains: "OrderedDict[int, dict]" = OrderedDict()
        self.spilled_bytes = 0
        # the counts of the series, so stats() works without telemetry
        self.hits = 0
        self.spill_hits = 0
        self.misses = 0
        self.evictions = 0

    # -- warmth ----------------------------------------------------------
    def _touch(self, h: int, parent: Optional[int]) -> dict:
        entry = self._chains.get(h)
        if entry is None:
            entry = {"parent": parent, "replicas": set(),
                     "tokens": None, "kv": None, "bytes": 0,
                     "scales": None, "quant": None}
            self._chains[h] = entry
            self._cap_chains()
        else:
            self._chains.move_to_end(h)
        return entry

    def record(self, replica_index: int, prompt: Sequence[int]):
        """Replica ``replica_index`` now holds this prompt's chain warm."""
        parent = None
        for h in chain_hashes(prompt, self.page_size):
            self._touch(h, parent)["replicas"].add(int(replica_index))
            parent = h
        _M_CHAINS.set(len(self._chains))

    def longest_warm(self, replica_index: int,
                     hashes: Sequence[int]) -> int:
        """Pages of ``hashes`` warm on ``replica_index``, from the
        front."""
        depth = 0
        for h in hashes:
            entry = self._chains.get(h)
            if entry is None or replica_index not in entry["replicas"]:
                break
            depth += 1
        return depth

    def forget_replica(self, replica_index: int):
        """The replica died: its warmth is gone (its pools with it), but
        spilled content lives in host memory and survives."""
        for entry in self._chains.values():
            entry["replicas"].discard(int(replica_index))

    # -- host-RAM spill --------------------------------------------------
    def spill_payload(self, payload: dict) -> int:
        """Spill the prompt chain of one transfer payload (the
        `serving.transfer.serialize_request` dict: ``prompt``,
        ``page_size``, ``freed`` and each layer's ``kv`` pages, (HK,
        n_pages, page_size, D)). The content is on the host already, so
        this is bookkeeping. Returns the pages spilled (0 for a window
        engine's payload, whose slid-out pages make the prompt KV
        unstable, or another page size)."""
        if payload.get("freed") or payload["page_size"] != self.page_size:
            return 0
        kv_layers = None        # assembled when a page needs spilling
        quant = payload.get("kv_quant")
        kv_scales = payload.get("kv_scales")
        prompt = payload["prompt"]
        ps = self.page_size
        spilled, parent = 0, None
        for f, h in enumerate(chain_hashes(prompt, ps)):
            entry = self._touch(h, parent)
            parent = h
            if entry["kv"] is not None:
                continue                       # already spilled
            if kv_layers is None:
                kv_layers = [(_host_tensor(k), _host_tensor(v))
                             for k, v in assemble_payload_kv(payload)]
            kv = [(kp[:, f], vp[:, f]) for kp, vp in kv_layers]
            nbytes = sum(_nbytes(a) + _nbytes(b) for a, b in kv)
            if kv_scales is not None:
                # int8 chains spill their page bytes with one (page_size,)
                # f32 scale row pair a layer
                scales = [(_host_tensor(ks)[f], _host_tensor(vs)[f])
                          for ks, vs in kv_scales]
                nbytes += sum(_nbytes(a) + _nbytes(b) for a, b in scales)
                entry["scales"] = scales
            entry["quant"] = quant
            entry["tokens"] = tuple(int(t) for t in prompt[f * ps:
                                                           (f + 1) * ps])
            entry["kv"] = kv
            entry["bytes"] = nbytes
            self.spilled_bytes += nbytes
            spilled += 1
        self._cap_spill()
        _M_CHAINS.set(len(self._chains))
        _M_SPILL_BYTES.set(self.spilled_bytes)
        return spilled

    def fetch(self, prompt: Sequence[int]):
        """The longest spilled chain prefix of ``prompt``, ready for
        `engine.import_prefix`: (page token lists, each layer's (k, v)
        rows (HK, n, page_size, D)), and for an int8 chain a third
        element, each layer's (k_scale, v_scale) rows (n, page_size); None
        when nothing of the prefix is spilled. The walk stops at an entry
        of another quant mode than the chain's head."""
        chain = []
        for h in chain_hashes(prompt, self.page_size):
            entry = self._chains.get(h)
            if entry is None or entry["kv"] is None:
                break
            if chain and entry.get("quant") != chain[0].get("quant"):
                break
            self._chains.move_to_end(h)
            chain.append(entry)
        if not chain:
            return None
        tokens = [list(e["tokens"]) for e in chain]
        layers = len(chain[0]["kv"])
        kv_rows = [(torch.stack([e["kv"][li][0] for e in chain], dim=1),
                    torch.stack([e["kv"][li][1] for e in chain], dim=1))
                   for li in range(layers)]
        if chain[0].get("scales") is not None:
            kv_scales = [
                (torch.stack([e["scales"][li][0] for e in chain]),
                 torch.stack([e["scales"][li][1] for e in chain]))
                for li in range(layers)]
            return tokens, kv_rows, kv_scales
        return tokens, kv_rows

    # -- accounting ------------------------------------------------------
    def note_lookup(self, source: str):
        """One routing decision's outcome: ``replica`` (warm replica
        found), ``spill`` (restored from host memory) or a miss."""
        if source == "replica":
            self.hits += 1
            _M_HITS.inc(source="replica")
        elif source == "spill":
            self.spill_hits += 1
            _M_HITS.inc(source="spill")
        else:
            self.misses += 1
            _M_MISSES.inc()

    def stats(self) -> Dict[str, object]:
        lookups = self.hits + self.spill_hits + self.misses
        return {
            "chains": len(self._chains),
            "spilled_chains": sum(1 for e in self._chains.values()
                                  if e["kv"] is not None),
            "spilled_bytes": self.spilled_bytes,
            "hits": self.hits,
            "spill_hits": self.spill_hits,
            "misses": self.misses,
            "hit_rate": round((self.hits + self.spill_hits) / lookups, 4)
            if lookups else None,
        }

    # -- bounds ----------------------------------------------------------
    def _drop_content(self, entry: dict):
        if entry["kv"] is not None:
            self.spilled_bytes -= entry["bytes"]
            entry["kv"] = None
            entry["tokens"] = None
            entry["scales"] = None
            entry["bytes"] = 0
            self.evictions += 1
            _M_EVICTIONS.inc()

    def _cap_chains(self):
        while len(self._chains) > self.max_chains:
            _, entry = self._chains.popitem(last=False)     # LRU
            if entry["kv"] is not None:
                self._drop_content(entry)   # counts the eviction
            else:
                self.evictions += 1
                _M_EVICTIONS.inc()
        _M_SPILL_BYTES.set(self.spilled_bytes)

    def _cap_spill(self):
        if self.spilled_bytes <= self.spill_budget_bytes:
            return
        for entry in self._chains.values():                 # LRU order
            if self.spilled_bytes <= self.spill_budget_bytes:
                break
            self._drop_content(entry)
        _M_SPILL_BYTES.set(self.spilled_bytes)
