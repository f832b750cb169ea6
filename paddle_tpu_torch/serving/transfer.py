"""KV page transfer plane: migrate a request between engines.

≙ `paddle_tpu/serving/transfer.py`, whole. What moves is what the engine
holds for the request:

* its resident KV pages: `engine.export_pages` gathers the block-table
  window on the device and copies it to host tensors in one copy (the
  serialize side is read-only: the source stays consistent whatever
  happens next);
* its request state: the original prompt, the tokens streamed so far,
  the token budget, the remaining deadline, the preemption count and the
  stable `request_id`.

`install_request` re-materializes that state in the target engine
(`engine.import_pages`): a free slot is claimed, any prompt prefix the
target's own trie holds attaches read-only, the remaining pages are
allocated and written by the engine's install program (one CUDA graph a
page count on the card), and the installed chain enters the target's
prefix cache. Page accounting (`check_invariants`) holds on both engines
at every boundary.

Failure semantics: a fault at either end leaves both engines consistent
(serialize never mutates; install backs its slot out), so the request
stays live on exactly one engine. Fault sites ``transfer.serialize`` /
``transfer.install`` force either half, and the value site
``transfer.payload`` damages a serialized payload after its manifest
was attached.

Payload integrity: `export_pages` attaches a sha256 checksum per KV
array (``payload["kv_sha256"]``, and ``scales_sha256`` under int8 KV)
and `import_pages` verifies it before any target mutation, so a flipped
byte in flight is a `PayloadCorruption`, counted
``pdt_transfer_failures_total{stage="verify"}`` with a
`transfer.failed` event, and the request decodes on at its source.

Quantized serving: an int8-KV source's payload carries the int8 page
bytes, the per-page scale rows (``kv_scales``) and the ``kv_quant`` tag;
the bytes move verbatim (never re-quantized, so migrated streams stay
bitwise) and `payload_nbytes` counts the scales too. `import_pages`
refuses a cross-mode payload with `QuantMismatch` before any mutation.

Speculative decoding: the payload carries the target model's pages
only. The source's draft cache is dropped at the hand-off
(`evict_request` releases the slot's draft pages with the slot) and the
target backfills it from the migrated stream on its first spec round,
as after a preemption.

Telemetry: the ``pdt_transfer_*`` series and the ``transfer.serialize``
/ ``transfer.install`` spans, joined to the request's trace by its
``request_id``, under the JAX package's names, labels and help.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

from .. import observability as telemetry
from ..models.serving import (ContinuousBatchingEngine, EngineOverloaded,
                              PayloadCorruption, PoolExhausted,
                              QuantMismatch, Request,
                              assemble_payload_kv, verify_payload)
from ..utils.faults import fault_point, fault_value, value_armed

__all__ = ["serialize_request", "install_request", "migrate_request",
           "payload_nbytes", "assemble_payload_kv", "PayloadCorruption",
           "QuantMismatch", "verify_payload", "TransferStageTimeout"]


class TransferStageTimeout(RuntimeError):
    """A migration stage returned but overran its per-stage deadline
    (`migrate_request(stage_deadline=)`): the migration is refused (a
    late install is backed out of the target first) and counted
    ``pdt_transfer_failures_total{stage="timeout"}``. ``stage`` names
    the offender (``serialize`` | ``install``). Deadlines are checked at
    stage boundaries on the injected clock; a stage that never returns
    is not seen here."""

    def __init__(self, message: str, stage: str):
        super().__init__(message)
        self.stage = stage


_M_MIGRATIONS = telemetry.counter(
    "pdt_transfer_migrations_total",
    "Requests migrated between engines through the KV transfer plane.")
_M_FAILURES = telemetry.counter(
    "pdt_transfer_failures_total",
    "Transfer-plane failures by stage (serialize | verify | install; "
    "capacity deferrals — no free slot / no pages on the target — are "
    "not failures and retry next step).", ("stage",))
_M_BYTES = telemetry.counter(
    "pdt_transfer_bytes_total",
    "KV page bytes serialized out of source engines.")
_M_SECONDS = telemetry.histogram(
    "pdt_transfer_seconds",
    "Wall time of one complete migration (serialize + install + "
    "source evict).")


def _nbytes(a) -> int:
    """Bytes of a torch tensor (``numel() * element_size()``) or of a
    numpy array."""
    if hasattr(a, "element_size"):
        return a.numel() * a.element_size()
    return int(a.nbytes)


def payload_nbytes(payload: dict) -> int:
    """Host bytes of a payload's KV page content: the ``kv`` arrays, or a
    tensor-parallel source's per-shard fragments (``kv_shards``), plus
    an int8-KV payload's scale rows (``kv_scales``), which cross the
    wire with the page bytes."""
    if payload.get("kv") is not None:
        n = sum(_nbytes(k) + _nbytes(v) for k, v in payload["kv"])
    else:
        n = sum(_nbytes(k) + _nbytes(v)
                for shard in payload["kv_shards"] for k, v in shard)
    if payload.get("kv_scales") is not None:
        n += sum(_nbytes(ks) + _nbytes(vs)
                 for ks, vs in payload["kv_scales"])
    return n


def _corrupt_payload_site(payload: dict, tag=None) -> None:
    """The ``transfer.payload`` value fault site (`utils.faults` corrupt
    mode): damage the first KV array (layer 0's keys of the first shard)
    after `export_pages` attached its manifest, which is what in-flight
    damage looks like; `verify_payload` must refuse it at install.
    ``tag`` is the source engine's ``fault_tag``, so a tag-pinned rule
    damages one replica's payloads only."""
    if not value_armed("transfer.payload", tag):
        return
    shards = [payload["kv"]] if payload.get("kv") is not None \
        else payload["kv_shards"]
    k, v = shards[0][0]
    mut = fault_value("transfer.payload", k, tag=tag)
    if mut is not k:
        shards[0][0] = (mut, v)


def serialize_request(engine: ContinuousBatchingEngine,
                      rid: int) -> dict:
    """Serialize one RUNNING request's pages and state out of ``engine``
    (read-only: the source owns the request until
    `engine.evict_request`). Fault sites: ``transfer.serialize`` (raise)
    and ``transfer.payload`` (corrupt-mode damage, after the
    manifest)."""
    req = engine.get_request(rid)
    request_id = req.request_id if req is not None else str(rid)
    with telemetry.span("transfer.serialize", rid=rid,
                        request_id=request_id):
        fault_point("transfer.serialize")
        payload = engine.export_pages(rid)
    _corrupt_payload_site(payload, getattr(engine, "fault_tag", None))
    return payload


def install_request(engine: ContinuousBatchingEngine, payload: dict,
                    *, deadline: Optional[float] = None) -> Request:
    """Install a serialized request into ``engine``'s paged cache and
    return the live target Request. ``deadline`` is the remaining budget
    in seconds on the target's clock. Raises `EngineOverloaded` /
    `PoolExhausted` when the target lacks a slot or pages now (deferrals,
    not failures). Fault site: ``transfer.install``, before any target
    mutation."""
    with telemetry.span("transfer.install",
                        request_id=payload["request_id"],
                        tokens=len(payload["output"]),
                        pages=payload["n_pages"]):
        fault_point("transfer.install")
        return engine.import_pages(payload, deadline=deadline)


def _stage_overrun(stage: str, elapsed: float, deadline: float,
                   rid: int) -> TransferStageTimeout:
    """Count one per-stage deadline overrun (counter and event) and build
    the typed error."""
    _M_FAILURES.inc(stage="timeout")
    err = TransferStageTimeout(
        f"migration {stage} took {elapsed:.3f}s, over the "
        f"{deadline:.3f}s per-stage deadline — migration deferred, "
        f"slow endpoint degraded", stage)
    telemetry.event("transfer.failed", stage="timeout", rid=rid,
                    error=f"{type(err).__name__}: {err}")
    return err


def migrate_request(src: ContinuousBatchingEngine,
                    dst: ContinuousBatchingEngine, rid: int,
                    *, deadline: Optional[float] = None,
                    clock: Callable[[], float] = time.perf_counter,
                    stage_deadline: Optional[float] = None,
                    ) -> Tuple[Request, dict]:
    """One complete migration: serialize from ``src``, install into
    ``dst``, then evict the source copy (in that order, so a failure at
    any point leaves the request live on exactly one engine). Returns
    (target Request, payload). Capacity refusals (`EngineOverloaded` /
    `PoolExhausted`) propagate uncounted; a `PayloadCorruption` counts
    ``pdt_transfer_failures_total{stage="verify"}``; anything else
    counts the stage it failed in, with a ``transfer.failed`` event,
    before it re-raises. ``clock`` times ``pdt_transfer_seconds`` (a
    caller's fake clock drives it); ``stage_deadline`` bounds each stage
    on the same clock (`TransferStageTimeout`)."""
    t0 = clock()
    stage = "serialize"
    try:
        payload = serialize_request(src, rid)
        if stage_deadline is not None \
                and clock() - t0 > stage_deadline:
            # slow source: nothing was installed
            raise _stage_overrun("serialize", clock() - t0,
                                 stage_deadline, rid)
        stage = "install"
        # read the clock only where a deadline asks for it: callers drive
        # it with exact tick sequences
        t1 = clock() if stage_deadline is not None else t0
        req = install_request(dst, payload, deadline=deadline)
        if stage_deadline is not None \
                and clock() - t1 > stage_deadline:
            # slow target: the install landed, so back it out; the
            # source never evicted and stays authoritative
            dst.evict_request(req.rid)
            raise _stage_overrun("install", clock() - t1,
                                 stage_deadline, rid)
    except (EngineOverloaded, PoolExhausted):
        raise                       # target capacity: defer, not a fault
    except TransferStageTimeout:
        raise                       # counted by _stage_overrun
    except PayloadCorruption as e:
        _M_FAILURES.inc(stage="verify")
        telemetry.event("transfer.failed", stage="verify", rid=rid,
                        error=f"{type(e).__name__}: {e}")
        raise
    except BaseException as e:
        _M_FAILURES.inc(stage=stage)
        telemetry.event("transfer.failed", stage=stage, rid=rid,
                        error=f"{type(e).__name__}: {e}")
        raise
    # both engines hold the request for this instant: evicting second
    # means a crash window can only duplicate it, never lose it
    src.evict_request(rid)
    _M_MIGRATIONS.inc()
    _M_BYTES.inc(payload_nbytes(payload))
    _M_SECONDS.observe(clock() - t0)
    return req, payload
