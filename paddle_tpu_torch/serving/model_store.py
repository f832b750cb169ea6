"""Fleet-wide model store: model identity as a fleet dimension.

≙ `paddle_tpu/serving/model_store.py`, whole: `model_id`,
`split_model_id` and `FleetModelStore`. Its ``pdt_model_store_*``
telemetry is not ported yet (ROADMAP.md queue A, item 5); the counters
it keeps are plain attributes and `stats()`.

Registered artifacts are full checkpoints (``register_model``) and LoRA
adapters over a registered checkpoint (``register_adapter``). Every
replica has a RESIDENT SET, the artifacts its engine can decode under
now, kept by ``ensure()`` through the engine:

* a full checkpoint installs with ``engine.install_weights`` (idle
  only, stamps ``model_tag``); with ``quant_weights`` set the store
  quantizes its matmul weights at registration
  (`ops.quant_matmul.QuantizedWeight`), so it holds and installs the
  smaller footprint;
* a LoRA adapter installs with ``engine.install_adapter`` into the
  stacked epilogue tensors (`ops.lora_epilogue`), safe mid-flight.

Residency is byte-budgeted per replica (``byte_budget_per_replica``): a
cold install first evicts unpinned adapters, least recently used first.
``pin`` / ``unpin`` bracket each in-flight request, and
``engine.evict_adapter`` itself refuses while a request is queued or
decoding under the adapter, so an eviction never strands a request.
Installs are transactional on the engine side, so a raise anywhere
leaves the engine and the store's accounting unchanged.

Adapter ranks are PADDED to the store constant ``max_rank`` at
registration: padded rank columns contribute exact zeros, so replicas
hosting different adapter subsets give the same streams as a dedicated
engine.

The store only needs a replica to be a hashable key (no router is
ported yet). It is host state, deterministic given the call sequence.
Checkpoint values are in the port's layout (`models.convert.
llama_state_from_numpy`); adapter deltas keep the JAX convention, A
(K, r) and B (r, N), and are held as float32 numpy arrays, as in JAX.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["FleetModelStore", "model_id", "split_model_id"]


# the id separator: base and adapter names must not contain it, so the
# canonical spelling parses back losslessly
_SEP = "+"


def model_id(base: str, adapter: Optional[str] = None) -> str:
    """The canonical model-identity key: ``base`` for a bare checkpoint,
    ``base+adapter`` for a LoRA fine-tune over it."""
    base = str(base)
    if not base or _SEP in base:
        raise ValueError(f"model base name {base!r} must be non-empty "
                         f"and must not contain {_SEP!r}")
    if adapter is None:
        return base
    adapter = str(adapter)
    if not adapter or _SEP in adapter:
        raise ValueError(f"adapter name {adapter!r} must be non-empty "
                         f"and must not contain {_SEP!r}")
    return base + _SEP + adapter


def split_model_id(mid: str) -> Tuple[str, Optional[str]]:
    """Inverse of `model_id`: ``(base, adapter-or-None)``."""
    base, sep, adapter = str(mid).partition(_SEP)
    if not base or (sep and not adapter):
        raise ValueError(f"malformed model id {mid!r}")
    return base, (adapter if sep else None)


def _values_nbytes(values: dict) -> int:
    return sum(int(getattr(v, "nbytes", 0)) for v in values.values())


def _f32(x) -> np.ndarray:
    """A delta factor as a float32 numpy array (tensors leave the
    device)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


class FleetModelStore:
    """Registered model/adapter artifacts and per-replica resident sets
    (module docstring). ``base_model`` names the checkpoint every engine
    is BUILT with (an engine whose ``model_tag`` is None hosts it); it
    is registered implicitly with no stored values.
    ``byte_budget_per_replica`` bounds each replica's resident artifact
    bytes (None: unbounded); ``max_rank`` is the rank every adapter pads
    to; ``quant_weights`` ('int8'|'fp8') quantizes full checkpoints'
    matmul weights at registration."""

    def __init__(self, base_model: str = "base",
                 byte_budget_per_replica: Optional[int] = None,
                 max_rank: int = 8,
                 quant_weights: Optional[str] = None):
        self.base_model = model_id(base_model)
        self.byte_budget_per_replica = \
            None if byte_budget_per_replica is None \
            else int(byte_budget_per_replica)
        self.max_rank = int(max_rank)
        if self.max_rank < 1:
            raise ValueError(f"max_rank must be >= 1, got {max_rank}")
        if quant_weights not in (None, "int8", "fp8"):
            raise ValueError(
                f"quant_weights {quant_weights!r}: int8|fp8|None")
        self.quant_weights = quant_weights
        # mid -> {"kind": "base"|"full"|"lora", "base": mid|None,
        #         "values"|"deltas": ..., "scale": f, "nbytes": int}
        self._artifacts: Dict[str, dict] = {
            self.base_model: {"kind": "base", "base": None, "nbytes": 0},
        }
        # per base mid: the target-parameter set every adapter over that
        # base shares (an engine's stacks are homogeneous)
        self._schemas: Dict[str, Tuple[str, ...]] = {}
        # replica -> LRU-ordered resident set: mid -> nbytes
        self._resident: Dict[object, "OrderedDict[str, int]"] = {}
        # replica -> mid -> pin count (in-flight requests)
        self._pins: Dict[object, Dict[str, int]] = {}
        self.installs = 0
        self.evictions = 0
        self.hits = 0
        self.misses = 0
        self.evict_refusals = 0

    # -- registration --------------------------------------------------
    def register_model(self, name: str, values: dict) -> str:
        """Register a FULL checkpoint: ``values`` maps every parameter
        name to its tensor (or numpy array) in the port's layout. With
        ``quant_weights`` set, the 2D matmul entries
        (`models.serving.QUANT_MATMULS`) are quantized NOW, so the store
        holds and later installs the smaller footprint. Returns the
        canonical model id."""
        mid = model_id(name)
        if mid in self._artifacts:
            raise ValueError(f"model {mid!r} already registered")
        if not values:
            raise ValueError(f"model {name!r} registered with no values")
        vals = dict(values)
        if self.quant_weights is not None:
            from ..models.serving import QUANT_MATMULS
            from ..ops.quant_matmul import (QuantizedWeight,
                                            quantize_weight_values)
            for nm, v in list(vals.items()):
                if getattr(v, "ndim", 0) == 2 \
                        and not isinstance(v, QuantizedWeight) \
                        and any(k in nm.lower() for k in QUANT_MATMULS):
                    vals[nm] = QuantizedWeight(*quantize_weight_values(
                        torch.as_tensor(v), self.quant_weights))
        self._artifacts[mid] = {"kind": "full", "base": None,
                                "values": vals,
                                "nbytes": _values_nbytes(vals)}
        return mid

    def register_adapter(self, name: str, deltas: dict,
                         base: Optional[str] = None,
                         scale: float = 1.0) -> str:
        """Register a LoRA adapter over ``base`` (default: the builtin
        base): ``deltas`` maps adapted parameter names to ``(A, B)``
        pairs, A (K, r) and B (r, N) with r <= max_rank. Ranks pad to
        ``max_rank`` HERE with exact-zero columns, so every replica
        hosting any subset of adapters runs stacks of one shape. All
        adapters over one base must adapt the same parameter set.
        Returns the canonical id."""
        base_mid = self.base_model if base is None else model_id(base)
        art = self._artifacts.get(base_mid)
        if art is None:
            raise ValueError(f"adapter base {base_mid!r} is not a "
                             "registered model")
        if art["kind"] == "lora":
            raise ValueError(f"adapter base {base_mid!r} is itself an "
                             "adapter — adapters stack on checkpoints "
                             "only")
        mid = model_id(base_mid, name)
        if mid in self._artifacts:
            raise ValueError(f"adapter {mid!r} already registered")
        if not deltas:
            raise ValueError(f"adapter {name!r} registered with no deltas")
        schema = tuple(sorted(deltas))
        want = self._schemas.get(base_mid)
        if want is not None and schema != want:
            raise ValueError(
                f"adapter {name!r} adapts {list(schema)} but adapters "
                f"over {base_mid!r} adapt {list(want)} — one target set "
                "per base (pad missing targets with zero deltas)")
        padded = {}
        for nm, (a, b) in deltas.items():
            a, b = _f32(a), _f32(b)
            if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
                raise ValueError(
                    f"adapter {name!r} delta for {nm!r}: A {a.shape} / B "
                    f"{b.shape} is not a rank factorization")
            r = a.shape[1]
            if r > self.max_rank:
                raise ValueError(
                    f"adapter {name!r} rank {r} exceeds the store's "
                    f"max_rank {self.max_rank}")
            if r < self.max_rank:
                a = np.concatenate(
                    [a, np.zeros((a.shape[0], self.max_rank - r),
                                 np.float32)], axis=1)
                b = np.concatenate(
                    [b, np.zeros((self.max_rank - r, b.shape[1]),
                                 np.float32)], axis=0)
            padded[nm] = (a, b)
        nbytes = sum(a.nbytes + b.nbytes for a, b in padded.values())
        self._artifacts[mid] = {"kind": "lora", "base": base_mid,
                                "deltas": padded, "scale": float(scale),
                                "nbytes": nbytes}
        if want is None:
            self._schemas[base_mid] = schema
        return mid

    def known(self, mid: str) -> bool:
        return mid in self._artifacts

    def models(self) -> List[str]:
        """Every registered model id (bases and adapters), sorted."""
        return sorted(self._artifacts)

    # -- residency -----------------------------------------------------
    def _rset(self, replica) -> "OrderedDict[str, int]":
        rset = self._resident.get(replica)
        if rset is None:
            # a fresh replica hosts the builtin base by construction
            rset = OrderedDict({self.base_model: 0})
            self._resident[replica] = rset
            self._pins[replica] = {}
        return rset

    def resident(self, replica) -> Tuple[str, ...]:
        return tuple(self._rset(replica))

    def is_resident(self, replica, mid: str) -> bool:
        return mid in self._rset(replica)

    def replica_base(self, replica) -> str:
        """The base checkpoint `replica` hosts now (its first resident
        entry: `_ensure_base` installs it before any adapter)."""
        for mid in self._rset(replica):
            art = self._artifacts.get(mid)
            if art is not None and art["kind"] in ("base", "full"):
                return mid
        return self.base_model

    def resident_bytes(self, replica) -> int:
        return sum(self._rset(replica).values())

    def pin(self, replica, mid: str):
        """One in-flight request depends on `mid` at `replica`: the LRU
        may not evict it until the matching `unpin`."""
        pins = self._pins.setdefault(replica, {})
        pins[mid] = pins.get(mid, 0) + 1

    def unpin(self, replica, mid: str):
        pins = self._pins.setdefault(replica, {})
        n = pins.get(mid, 0) - 1
        if n > 0:
            pins[mid] = n
        else:
            pins.pop(mid, None)

    def forget_replica(self, replica):
        """The replica died or left: its residency (device state) died
        with it. Registered artifacts are host state and survive — the
        next ensure() reinstalls."""
        self._resident.pop(replica, None)
        self._pins.pop(replica, None)

    # -- install/evict -------------------------------------------------
    def ensure(self, replica, engine, mid: str) -> bool:
        """Make `mid` resident on `replica`'s engine, cold-installing
        whatever is missing (base checkpoint first, then the adapter)
        and evicting unpinned adapters, least recently used first, past
        the byte budget. Returns True when a cold install happened,
        False when the replica was already warm. Raises KeyError for an
        unregistered id and passes the engine's refusals on (e.g.
        install_weights on a busy engine) with the store's accounting
        unchanged."""
        art = self._artifacts.get(mid)
        if art is None:
            raise KeyError(f"model {mid!r} is not registered with the "
                           "fleet store")
        rset = self._rset(replica)
        if mid in rset:
            rset.move_to_end(mid)
            base = art.get("base")
            if base is not None and base in rset:
                rset.move_to_end(base)    # the adapter keeps its base
            self.hits += 1
            return False
        if art["kind"] == "lora":
            self._ensure_base(replica, engine, art["base"], rset)
            self._make_room(replica, engine, rset, art["nbytes"])
            _, aname = split_model_id(mid)
            engine.install_adapter(aname, art["deltas"], scale=art["scale"])
            rset[mid] = art["nbytes"]
            self.installs += 1
        else:
            self._ensure_base(replica, engine, mid, rset)
        self.misses += 1
        return True

    def _ensure_base(self, replica, engine, base_mid: str,
                     rset: "OrderedDict[str, int]") -> bool:
        """Host checkpoint `base_mid` on the engine, swapping away the
        current base and every adapter over it (they die with their
        base, on the engine and in the store's accounting)."""
        if base_mid in rset:
            rset.move_to_end(base_mid)
            return False
        art = self._artifacts[base_mid]
        # the swap is idle-only on the engine side; a refusal propagates
        # BEFORE any accounting changes
        if art["kind"] == "base":
            engine.reset_weights()
        else:
            engine.install_weights(art["values"], tag=base_mid)
        rset.clear()
        self._pins.setdefault(replica, {}).clear()
        rset[base_mid] = art["nbytes"]
        if art["kind"] != "base":
            self.installs += 1
        return True

    def _make_room(self, replica, engine,
                   rset: "OrderedDict[str, int]", need: int):
        """Evict unpinned ADAPTERS, least recently used first, until
        `need` more bytes fit the replica budget. Pinned entries, the
        resident base, and adapters the engine still has in flight (its
        own refusal) are skipped — an eviction never strands a
        request."""
        budget = self.byte_budget_per_replica
        if budget is None:
            return
        pins = self._pins.setdefault(replica, {})
        used = sum(rset.values())
        for mid in list(rset):
            if used + need <= budget:
                break
            art = self._artifacts.get(mid)
            if art is None or art["kind"] != "lora":
                continue                      # bases never LRU out
            if pins.get(mid, 0):
                self.evict_refusals += 1
                continue
            _, aname = split_model_id(mid)
            try:
                engine.evict_adapter(aname)
            except ValueError:
                # still in flight on the engine: skip, never strand
                self.evict_refusals += 1
                continue
            used -= rset.pop(mid)
            self.evictions += 1
        # over budget with nothing evictable is legal: pinned work
        # outranks the budget

    # -- accounting ----------------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {
            "artifacts": len(self._artifacts),
            "adapters": sum(1 for a in self._artifacts.values()
                            if a["kind"] == "lora"),
            "replicas": len(self._resident),
            "resident_bytes": {str(r): sum(rs.values())
                               for r, rs in self._resident.items()},
            "installs": self.installs,
            "evictions": self.evictions,
            "evict_refusals": self.evict_refusals,
            "hits": self.hits,
            "misses": self.misses,
        }
