"""Human-readable fleet status: the operator's one-glance surface.

≙ `paddle_tpu/observability/status.py`, whole. `render_fleet_status`
turns a fleet's `fleet_info()` dict (per-replica role and health, queue
depths, restart counts, the prefix-cache aggregate, role aggregates and
prefix-store stats, QoS admission state, the sentry, per-replica and
fleet-level SLO verdicts, and the attribution surface of
``fleet_info()["perf"]``: the `pdt_mem_bytes{pool}` memory ledger and
the per-family program-cache table) into a fixed-width report;
``python -m paddle_tpu_torch.observability status --from fleet.json``
renders a saved one. The port has no fleet router yet (ROADMAP.md queue
A, item 8), so the dict comes from the caller. Pure formatting: no
registry reads, no side effects, so it can render a dict captured
anywhere (a log line, a post-mortem dump, a test)."""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["render_fleet_status"]


def _fmt_bytes(n: float) -> str:
    """`1536 -> 1.5KiB` — compact fixed-point byte counts for the
    memory-ledger line (the raw integers live in `pdt_mem_bytes`)."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GiB"


def _submesh_cell(sm: Optional[Dict[str, object]]) -> str:
    """`tp=2@[0,1]` — the replica's tensor-parallel placement (its
    GSPMD submesh shape + device ids), or `-` for single-chip."""
    if not sm:
        return "-"
    devs = ",".join(str(d) for d in sm.get("devices", []))
    return f"tp={sm.get('tp')}@[{devs}]"


def render_fleet_status(info: Dict[str, object]) -> str:
    """Format one `ServingRouter.fleet_info()` snapshot."""
    lines: List[str] = ["fleet status"]
    # the submesh column appears only for TP fleets — a single-chip
    # fleet's table stays byte-identical to what operators already read
    replicas = info.get("replicas", [])
    with_tp = any(r.get("submesh") for r in replicas)
    # width follows the widest cell: tp=4@[0,1,2,3] must not push the
    # slo/note columns out of line with the header
    tp_w = max([7] + [len(_submesh_cell(r.get("submesh")))
                      for r in replicas]) if with_tp else 0
    tp_hdr = f" {'submesh':<{tp_w}}" if with_tp else ""
    # width fits the gray-failure states too ("quarantined" = 11)
    st_w = max([5] + [len(str(r.get("state", ""))) for r in replicas])
    lines.append(f"  {'replica':<8} {'role':<10} {'state':<{st_w}} "
                 f"{'outstanding':>11} {'restarts':>8}{tp_hdr} "
                 f"{'slo':<7} note")
    for r in replicas:
        slo = r.get("slo")
        note = r.get("death_reason") or ""
        if r.get("consecutive_failures"):
            note = (note + " " if note else "") \
                + f"{r['consecutive_failures']} consecutive failures"
        tp_cell = f" {_submesh_cell(r.get('submesh')):<{tp_w}}" \
            if with_tp else ""
        lines.append(
            f"  {r['index']:<8} {r.get('role', 'colocated'):<10} "
            f"{r['state']:<{st_w}} "
            f"{r['outstanding']:>11} {r['restarts']:>8}{tp_cell} "
            f"{(slo.upper() if slo else '-'):<7} {note}".rstrip())
    lines.append(
        f"  requests: {info.get('submitted', 0)} submitted, "
        f"{info.get('pending', 0)} pending; "
        f"failovers {info.get('failovers', 0)}, "
        f"restarts {info.get('restarts', 0)}")
    roles: Optional[Dict[str, dict]] = info.get("roles")  # type: ignore
    if roles:
        parts = [
            f"{name}={d.get('replicas', 0)} "
            f"(queue {d.get('queue_depth', 0)}, "
            f"{d.get('migrations', 0)} migrated)"
            for name, d in roles.items()]
        lines.append(
            "  roles: " + " ".join(parts)
            + f"; migrations {info.get('migrations', 0)}")
    lines.append(
        f"  prefix cache: {info.get('prefix_hits', 0)} hits, "
        f"{info.get('prefix_tokens_reused', 0)} tokens reused")
    store: Optional[Dict[str, object]] = \
        info.get("prefix_store")  # type: ignore
    if store:
        hr = store.get("hit_rate")
        lines.append(
            f"  prefix store: {store.get('chains', 0)} chains "
            f"({store.get('spilled_chains', 0)} spilled, "
            f"{store.get('spilled_bytes', 0)} B), "
            f"hits {store.get('hits', 0)} replica / "
            f"{store.get('spill_hits', 0)} spill, "
            f"{store.get('misses', 0)} miss"
            + (f"; hit rate {hr:.2f}" if hr is not None else ""))
    adm: Optional[Dict[str, object]] = \
        info.get("admission")  # type: ignore
    if adm:
        lane_parts = []
        for lane, d in sorted(adm.get("lanes", {}).items()):
            reasons = d.get("shed_reasons") or {}
            why = ", ".join(f"{r}={n}"
                            for r, n in sorted(reasons.items()))
            lane_parts.append(
                f"{lane}={d.get('admitted', 0)} admitted"
                f"/{d.get('shed', 0)} shed"
                + (f" ({why})" if why else ""))
        burn = adm.get("burn_rate", 0.0)
        lines.append(
            "  admission: "
            + ("SHEDDING" if adm.get("shedding") else "open")
            + f" (burn {burn:.2f} on {adm.get('objective', '?')}); "
            + " ".join(lane_parts))
        tenants = adm.get("tenants") or {}
        if tenants:
            t_parts = [
                f"{name}={d.get('used_tokens', 0)}"
                f"/{d.get('budget_tokens', 0)}"
                + (" OVER" if d.get("over") else "")
                for name, d in sorted(tenants.items())]
            lines.append("  tenant budgets: " + " ".join(t_parts))
    sentry: Optional[Dict[str, object]] = \
        info.get("sentry")  # type: ignore
    if sentry:
        lines.append(
            f"  sentry: {sentry.get('sentry_trips', 0)} trip(s), "
            f"canaries {sentry.get('canary_runs', 0)} run / "
            f"{sentry.get('canary_failures', 0)} failed, "
            f"{sentry.get('quarantines', 0)} quarantine(s), "
            f"{sentry.get('tainted_tokens_dropped', 0)} tainted "
            "token(s) dropped")
    perf: Optional[Dict[str, object]] = info.get("perf")  # type: ignore
    if perf:
        mem: Dict[str, float] = perf.get("mem_bytes") or {}  # type: ignore
        if mem:
            lines.append("  memory: " + " ".join(
                f"{pool}={_fmt_bytes(b)}"
                for pool, b in sorted(mem.items())))
        jit: Dict[str, dict] = perf.get("jit") or {}  # type: ignore
        if jit:
            parts = []
            for fam, d in sorted(jit.items()):
                cell = f"{fam}={d.get('compiles', 0)}"
                extra = []
                if d.get("entries"):
                    extra.append(f"{d['entries']} cached")
                if d.get("evictions"):
                    extra.append(f"{d['evictions']} evicted")
                if extra:
                    cell += f" ({', '.join(extra)})"
                parts.append(cell)
            storms = perf.get("retrace_storms", 0)
            lines.append(
                "  jit compiles: " + " ".join(parts)
                + (f"; RETRACE STORMS {storms}" if storms else ""))
    slo: Optional[Dict[str, dict]] = info.get("slo")  # type: ignore
    if slo:
        parts = []
        for name, st in slo.items():
            value = st.get("value")
            shown = "-" if value is None else f"{value:.4g}"
            parts.append(f"{name}={st['state'].upper()}({shown})")
        lines.append("  slo: " + " ".join(parts))
    return "\n".join(lines)
