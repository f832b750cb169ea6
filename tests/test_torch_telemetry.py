"""The port's telemetry package (`paddle_tpu_torch.observability`) and
fault injector (`paddle_tpu_torch.utils.faults`) against the JAX
package's: the same instrument calls give equal snapshots and
byte-equal Prometheus text (which `parse_prometheus` reads back), the
SLO monitor and `evaluate_snapshot` grade the same observations alike on
a fake clock, the same span and event sequence gives equal names, attrs
and parent links, the profile report, the fleet status and the CLI
render the same text, the injectors fire on the same visits for a seed,
corrupt mode damages numpy input byte for byte alike, and disabled mode
records nothing."""
import json
import math

import numpy as np
import pytest
import torch

import paddle_tpu.observability as jt
from paddle_tpu.observability import __main__ as jcli
from paddle_tpu.observability import profile as jprofile
from paddle_tpu.observability import registry as jregistry
from paddle_tpu.utils import faults as jfaults
import paddle_tpu_torch.observability as pt
from paddle_tpu_torch.observability import __main__ as pcli
from paddle_tpu_torch.observability import profile as pprofile
from paddle_tpu_torch.observability import registry as pregistry
from paddle_tpu_torch.utils import faults as pfaults

SIDES = [(jt, jregistry, jprofile, jfaults, jcli),
         (pt, pregistry, pprofile, pfaults, pcli)]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Recording on through the environment both packages read, the
    global registries and trace rings empty."""
    monkeypatch.setenv("PDT_TELEMETRY", "1")
    for t in (jt, pt):
        t.reset()
        t.clear_events()
    yield
    for t in (jt, pt):
        t.reset()
        t.clear_events()


def _record(reg):
    """One fixed sequence of instrument calls into ``reg``."""
    c = reg.counter("pdt_x_total", "a counter", ("site", "kind"))
    c.inc(site="a", kind="q")
    c.inc(2.5, site='b"quoted', kind="new\nline")
    c.inc(site="c,comma", kind="back\\slash")
    g = reg.gauge("pdt_depth", "a gauge")
    g.set(7)
    g.inc(3)
    g.dec(0.5)
    lg = reg.gauge("pdt_pool_bytes", "labelled", ("pool",))
    lg.set(1 << 40, pool="kv")
    lg.set(0.125, pool="draft")
    h = reg.histogram("pdt_lat_seconds", "a histogram")
    for v, ex in ((0.0004, None), (0.003, "r1"), (0.003, "r2"), (2.0, None),
                  (100.0, "slow")):
        h.observe(v, exemplar=ex)
    hb = reg.histogram("pdt_tok", "custom buckets", ("lane",),
                       buckets=(1, 10, 100))
    for v in (0, 1, 5, 50, 500):
        hb.observe(v, lane="x")
    hb.observe(3, lane="y")
    reg.counter("pdt_never_total", "never recorded")


@pytest.fixture
def registries():
    out = []
    for t, registry, *_ in SIDES:
        reg = registry.Registry()
        _record(reg)
        out.append((t, reg))
    return out


def test_snapshots_equal(registries):
    (jt_, jreg), (pt_, preg) = registries
    assert preg.snapshot() == jreg.snapshot()


def test_prometheus_text_byte_equal(registries):
    (jt_, jreg), (pt_, preg) = registries
    text = pt_.to_prometheus(preg)
    assert text == jt_.to_prometheus(jreg)
    assert "# HELP pdt_x_total a counter" in text and "pdt_never" not in text
    assert 'trace_id="slow"' in text


@pytest.mark.parametrize("render", ["live", "snapshot"])
def test_parse_prometheus_round_trips(registries, render):
    (jt_, jreg), (pt_, preg) = registries
    snap = preg.snapshot()
    text = pt_.to_prometheus(preg) if render == "live" \
        else pt_.render_prometheus(snap)
    parsed = pt_.parse_prometheus(text)
    assert parsed == {k: v for k, v in snap.items() if k != "enabled"}
    assert parsed == jt_.parse_prometheus(text)
    assert pt_.render_prometheus(snap) == jt_.render_prometheus(snap)


def test_json_snapshot_equal(registries, tmp_path):
    (jt_, jreg), (pt_, preg) = registries
    pt_.write_json(str(tmp_path / "p.json"), preg)
    jt_.write_json(str(tmp_path / "j.json"), jreg)
    assert (tmp_path / "p.json").read_text() \
        == (tmp_path / "j.json").read_text()


def test_registry_refusals_and_values():
    for t, registry, *_ in SIDES:
        reg = registry.Registry()
        reg.counter("a", "", ("x",))
        with pytest.raises(ValueError):
            reg.gauge("a")
        with pytest.raises(ValueError):
            reg.counter("a", "", ("y",))
        with pytest.raises(ValueError):
            reg.counter("a", "", ("x",)).inc(-1, x="1")
        with pytest.raises(ValueError):
            reg.counter("a", "", ("x",)).inc(z="1")
        h = reg.histogram("h", buckets=(1, 2))
        with pytest.raises(ValueError):
            reg.histogram("h", buckets=(1, 3))
        with h.time():
            pass
        assert h.get()["count"] == 1
    # the global registries: names outside the packages' ``pdt_*``
    # catalog, which a JAX test holds to the instruments its code declares
    for t, *_ in SIDES:
        t.counter("test_v_total").inc(4)
        t.gauge("test_v", "", ("k",)).set(2, k="z")
        assert t.value("test_v_total") == 4.0
        assert t.value("test_v", k="z") == 2.0
        assert t.value("test_absent") == 0.0


def test_disabled_records_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("PDT_TELEMETRY", "0")
    for t, registry, profile, faults, _ in SIDES:
        assert not t.enabled()
        reg = registry.Registry()
        _record(reg)
        assert reg.snapshot()["counters"] == {}
        assert reg.snapshot()["histograms"] == {}
        with t.span("s", request_id="r"):
            t.event("e")
        assert t.start_trace("r") is None
        assert t.events() == []
        profile.note_round("host", 1.0)
        profile.note_cache("ragged", 3, 1)
        assert profile.compile_timed(lambda: 5, "decode")() == 5
        with faults.FaultInjector() as fi:
            fi.arm("x", nth=1)
            with pytest.raises(faults.FaultError):
                faults.fault_point("x")
        snap = t.snapshot()
        assert snap["enabled"] is False
        assert snap["counters"] == snap["histograms"] == {}
        # the programmatic override wins over the environment
        t.enable()
        try:
            assert t.enabled()
        finally:
            t.disable(clear_override=True)
        assert not t.enabled()


# -- SLO ---------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _statuses(statuses):
    return {k: vars(v) for k, v in statuses.items()}


def _feed(mon, clock):
    rng = np.random.default_rng(3)
    for i in range(60):
        clock.t += 1.0
        mon.observe("ttft", float(rng.exponential(0.2)),
                    replica=f"r{i % 3}")
        mon.observe("tpot", float(rng.exponential(0.03)))
        mon.observe_outcome("outcome", i % 17 != 0, replica=f"r{i % 3}")


@pytest.mark.parametrize("window", [30.0, 1000.0])
def test_slo_monitor_grades_alike(window):
    outs = []
    for t, *_ in SIDES:
        clock = FakeClock()
        mon = t.SloMonitor(t.default_serving_objectives(
            ttft_p95=0.5, window_s=window), clock=clock, warn_burn=0.4)
        _feed(mon, clock)
        outs.append((_statuses(mon.evaluate()), mon.report(),
                     [mon.replica_state(f"r{i}") for i in range(4)],
                     t.snapshot()["gauges"]))
    assert outs[1] == outs[0]


def _serving_snapshot(registry):
    """A snapshot holding TTFT observations and terminal statuses, from a
    registry of its own (the global ones declare these names with their
    engines' help text)."""
    reg = registry.Registry()
    h = reg.histogram("pdt_serving_ttft_seconds")
    for v in (0.01, 0.2, 0.3, 0.6, 2.0, 40.0):
        h.observe(v)
    c = reg.counter("pdt_serving_requests_terminal_total", "", ("status",))
    c.inc(9, status="finished")
    c.inc(1, status="timeout")
    reg.histogram("pdt_profile_round_seconds", "", ("component",),
                  buckets=pprofile._ROUND_BUCKETS).observe(
        0.003, component="host")
    return reg


def test_evaluate_snapshot_and_quantiles():
    outs = []
    for t, registry, *_ in SIDES:
        snap = _serving_snapshot(registry).snapshot()
        spec = [{"name": "p50", "signal": "ttft", "kind": "latency",
                 "threshold": 0.25, "quantile": 0.5,
                 "metric": "pdt_serving_ttft_seconds"}]
        st = t.evaluate_snapshot(snap)
        st2 = t.evaluate_snapshot(snap, t.objectives_from_spec(spec))
        r = t.Reservoir(window_s=10, max_samples=5, clock=FakeClock())
        for v in (5, 1, 4, 2, 3, 9):
            r.observe(v)
        buckets = snap["histograms"]["pdt_serving_ttft_seconds"][""][
            "buckets"]
        outs.append((_statuses(st), t.format_slo_report(st),
                     _statuses(st2), r.quantile(0.5), r.fraction_over(3),
                     [t.quantile_from_buckets(buckets, q)
                      for q in (0.0, 0.5, 0.95, 1.0)]))
        with pytest.raises(ValueError, match="unknown keys"):
            t.objectives_from_spec([dict(spec[0], typo=1)])
    assert outs[1] == outs[0]


# -- traces -------------------------------------------------------------

def _trace_sequence(t):
    t.start_trace("req-1", replica=0)
    with t.span("serving.prefill", rid=0, request_id="req-1"):
        t.event("serving.first_token", rid=0, request_id="req-1")
        with t.span("inner", k=2):
            pass
    with t.span("serving.decode_step", slots=2, rids=["req-1", "req-2"]):
        t.event("point")
    with t.trace_attach("req-1"):
        t.event("attached")
    try:
        with t.span("boom", request_id="req-1"):
            raise KeyError("x")
    except KeyError:
        pass
    t.event("serving.terminal", request_id="req-1", status="finished")
    t.end_trace("req-1")
    t.event("after", request_id="req-1")


def _links(events):
    """Names, attrs, depths and parent / trace links made relative to the
    first event, with the times left out."""
    base = events[0]["seq"]
    tid = events[0]["trace"]
    out = []
    for e in events:
        out.append((e["name"], e["attrs"], e["depth"],
                    None if e["parent"] is None else e["parent"] - base,
                    e["seq"] - base,
                    None if e["trace"] is None else e["trace"] - tid))
    return out


def _tree_shape(node):
    return (node["event"]["name"], [_tree_shape(c) for c in node["children"]])


def test_spans_events_and_trees_equal(tmp_path):
    outs = []
    for t, *_ in SIDES:
        _trace_sequence(t)
        evts = t.events()
        doc = t.export_chrome_trace(evts)
        for e in doc["traceEvents"]:
            e.pop("ts", None)
            e.pop("dur", None)
            e.get("args", {}).pop("seq", None)
            e.get("args", {}).pop("parent", None)
            e.get("args", {}).pop("trace", None)
        tree = t.request_tree("req-1", evts)
        outs.append((_links(evts), _tree_shape(tree), doc["traceEvents"]))
    assert outs[1] == outs[0]
    names = [x[0] for x in outs[1][0]]
    assert names[:3] == ["trace.start", "serving.first_token", "inner"]
    assert outs[1][0][names.index("boom")][1]["error"] == "KeyError: 'x'"


def test_trace_file_sink_round_trips(tmp_path):
    for t, *_ in SIDES:
        path = tmp_path / f"{t.__name__}.jsonl"
        t.set_trace_file(str(path))
        try:
            _trace_sequence(t)
        finally:
            t.set_trace_file(None)
        loaded = t.load_trace_jsonl(str(path))
        assert [e["name"] for e in loaded] == [e["name"] for e in t.events()]
        t.clear_events()
    assert [e["name"] for e in jt.load_trace_jsonl(
        str(tmp_path / "paddle_tpu_torch.observability.jsonl"))] \
        == [e["name"] for e in jt.load_trace_jsonl(
            str(tmp_path / "paddle_tpu.observability.jsonl"))]


def test_span_opens_a_profiler_range():
    """A port span is a `torch.profiler.record_function` range."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with pt.span("serving.decode_step", slots=1):
            torch.ones(4).sum()
    assert "serving.decode_step" in {e.key for e in prof.key_averages()}


# -- profile -------------------------------------------------------------

def test_profile_report_and_summaries_equal(monkeypatch):
    outs = []
    for t, _, profile, *_ in SIDES:
        profile.configure_retrace(window_s=30, threshold=3,
                                  clock=lambda: 0.0)
        try:
            for comp, v in (("host", 0.002), ("dispatch", 0.001),
                            ("device", 0.009), ("harvest", 0.0004),
                            ("host", 0.0021)):
                profile.note_round(comp, v)
            for fam in ("ragged", "ragged", "decode", "verify"):
                assert profile.compile_timed(lambda: 1, fam, key=(8, 1))() \
                    == 1
            profile.note_cache("ragged", 2, 1)
            with profile.gap_sampler() as sampler:
                for op in ("embed", "rmsnorm", "qkv", "rope"):
                    profile.fence(op, torch.zeros(2))
            rows = sampler.table()
            snap = t.snapshot()
            # the measured walls are not the same numbers: fix them
            for name in ("pdt_jit_compile_seconds",):
                for s in snap["histograms"][name].values():
                    s["sum"] = 0.5
            for k in snap["gauges"]["pdt_profile_gap_seconds"]:
                snap["gauges"]["pdt_profile_gap_seconds"][k] = 1e-4
            outs.append((profile.render_profile_report(snap),
                         profile.compile_summary(snap),
                         profile.round_summary(snap),
                         [r["op_pair"] for r in rows],
                         t.value("pdt_jit_retrace_storms_total"),
                         profile.perf_section()["jit"]))
        finally:
            profile.configure_retrace(window_s=30, threshold=10,
                                      clock=__import__("time").monotonic)
    assert outs[1] == outs[0]
    assert outs[1][3] == ["embed->rmsnorm", "rmsnorm->qkv", "qkv->rope"] \
        or sorted(outs[1][3]) == sorted(
            ["embed->rmsnorm", "rmsnorm->qkv", "qkv->rope"])
    assert outs[1][4] == 1.0           # 4 compiles past a threshold of 3
    assert outs[1][1]["ragged"]["compiles"] == 2
    assert outs[1][1]["decode"]["compiles"] == 1
    assert pprofile.fence("x", 5) == 5  # unarmed: the identity
    # the card's capture: seconds under jit.compile, no compile count
    pt.reset()
    pprofile.compile_timed(lambda: None, "decode", count=False)()
    snap = pt.snapshot()
    assert snap["histograms"]["pdt_jit_compile_seconds"][
        'family="decode"']["count"] == 1
    assert "pdt_jit_compiles_total" not in snap["counters"]


def test_fence_is_identity_and_counts_pairs():
    with pprofile.gap_sampler() as s:
        out = pprofile.fence("qkv", (torch.ones(1), torch.ones(2)))
        pprofile.fence("rope", torch.ones(1))
    assert isinstance(out, tuple) and len(out) == 2
    rows = s.table()
    assert [r["op_pair"] for r in rows] == ["qkv->rope"]
    assert rows[0]["count"] == 1 and rows[0]["gap_s"] >= 0.0
    assert pprofile._SAMPLER is None


def test_status_report_equal():
    info = {"replicas": [
        {"index": 0, "role": "prefill", "state": "healthy",
         "outstanding": 2, "restarts": 0, "slo": "pass"},
        {"index": 1, "state": "quarantined", "outstanding": 0,
         "restarts": 3, "death_reason": "killed",
         "consecutive_failures": 2, "submesh": {"tp": 2, "devices": [0, 1]}}],
        "submitted": 9, "pending": 1, "failovers": 1, "restarts": 3,
        "prefix_hits": 4, "prefix_tokens_reused": 64,
        "perf": {"mem_bytes": {"kv_pool": 3 << 20, "draft_pool": 1536},
                 "jit": {"ragged": {"compiles": 3, "entries": 2,
                                    "evictions": 1}},
                 "retrace_storms": 0},
        "slo": {"ttft_p95": {"state": "warn", "value": 0.41}}}
    assert pt.render_fleet_status(info) == jt.render_fleet_status(info)


# -- the CLI --------------------------------------------------------------

def _cli(cli, argv, capsys):
    code = cli.main(argv)
    return code, capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["snapshot-prom", "snapshot-json", "slo",
                                 "profile", "status", "trace-tree",
                                 "trace-export"])
def test_cli_renders_alike(cmd, tmp_path, capsys):
    snap = tmp_path / "snap.json"
    pt.write_json(str(snap), _serving_snapshot(pregistry))
    trace = tmp_path / "t.jsonl"
    pt.set_trace_file(str(trace))
    try:
        _trace_sequence(pt)
    finally:
        pt.set_trace_file(None)
    fleet = tmp_path / "fleet.json"
    fleet.write_text(json.dumps({"replicas": [
        {"index": 0, "state": "healthy", "outstanding": 0, "restarts": 0}]}))
    argv = {"snapshot-prom": ["snapshot", "--from", str(snap)],
            "snapshot-json": ["snapshot", "--from", str(snap), "--format",
                              "json"],
            "slo": ["slo", "--from", str(snap)],
            "profile": ["profile", "--from", str(snap)],
            "status": ["status", "--from", str(fleet)],
            "trace-tree": ["trace", "tree", str(trace), "--request",
                           "req-1"],
            "trace-export": ["trace", "export", str(trace), "--chrome",
                             str(tmp_path / "c.json")]}[cmd]
    got = _cli(pcli, argv, capsys)
    want = _cli(jcli, argv, capsys)
    if cmd == "trace-tree":
        # span durations are in the tree text: compare its shape
        strip = lambda s: [ln.split(" [")[0] for ln in s.splitlines()]
        assert (got[0], strip(got[1])) == (want[0], strip(want[1]))
    else:
        assert got == want
    # the snapshot's TTFT p95 is past the stock 0.5 s objective: `slo`
    # exits 1 on a breach, as the JAX CLI does
    assert got[0] == (1 if cmd == "slo" else 0)


# -- fault injection ------------------------------------------------------

ARMINGS = [dict(nth=3), dict(probability=0.3), dict(probability=0.7, times=4),
           dict(always=True, times=2), dict(always=True)]


def _fires(faults, seed, arming, visits=40):
    fired = []
    with faults.FaultInjector(seed=seed) as fi:
        fi.arm("s", **arming)
        for _ in range(visits):
            try:
                faults.fault_point("s")
                fired.append(False)
            except faults.FaultError as e:
                assert e.site == "s"
                fired.append(True)
        stats = fi.stats()
    return fired, stats


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("arming", ARMINGS, ids=lambda a: "-".join(
    f"{k}{v}" for k, v in a.items()))
def test_fire_patterns_equal(seed, arming):
    assert _fires(pfaults, seed, arming) == _fires(jfaults, seed, arming)


def test_nested_scopes_and_custom_exc_equal():
    outs = []
    for faults in (jfaults, pfaults):
        log = []
        with faults.FaultInjector() as outer:
            outer.arm("s", nth=2)
            with faults.FaultInjector() as inner:
                inner.arm("s", always=True, times=1, exc=KeyError)
                for _ in range(3):
                    try:
                        faults.fault_point("s")
                        log.append("ok")
                    except Exception as e:
                        log.append(type(e).__name__)
            for _ in range(3):
                try:
                    faults.fault_point("s")
                    log.append("ok")
                except Exception as e:
                    log.append(type(e).__name__)
            log.append((outer.stats(), inner.stats()))
        faults.fault_point("s")             # disarmed on exit
        with pytest.raises(ValueError):
            faults.FaultInjector().arm("x", nth=1, always=True)
        outs.append(log)
    assert outs[1] == outs[0]


def test_fault_counter_and_event_equal():
    for t, _, _, faults, _ in SIDES:
        with faults.FaultInjector() as fi:
            fi.arm("serving.decode", always=True, times=2)
            for _ in range(3):
                try:
                    faults.fault_point("serving.decode")
                except faults.FaultError:
                    pass
    for t, *_ in SIDES:
        assert t.value("pdt_faults_fired_total",
                       site="serving.decode") == 2.0
    assert [(e["name"], e["attrs"]) for e in pt.events()] \
        == [(e["name"], e["attrs"]) for e in jt.events()]


@pytest.mark.parametrize("mode", ["bitflip", "nan", "scale"])
@pytest.mark.parametrize("dtype", ["float32", "float16", "int32"])
def test_corrupt_numpy_byte_equal(mode, dtype):
    arr = (np.arange(24) - 7).astype(dtype).reshape(4, 6)
    outs = []
    for faults in (jfaults, pfaults):
        with faults.FaultInjector(seed=5) as fi:
            fi.arm_corrupt("serving.kv_page", mode=mode, always=True,
                           times=2, factor=3.0, tag="1")
            assert faults.value_armed("serving.kv_page", tag=1)
            assert not faults.value_armed("serving.kv_page", tag=2)
            same = faults.fault_value("serving.kv_page", arr, tag=2)
            first = faults.fault_value("serving.kv_page", arr, tag=1)
            second = faults.fault_value("serving.kv_page", arr, tag="1")
            third = faults.fault_value("serving.kv_page", arr, tag=1)
            outs.append((same is arr, np.asarray(first).tobytes(),
                         np.asarray(second).tobytes(), third is arr,
                         fi.stats()))
    assert outs[1] == outs[0]
    assert outs[1][1] != arr.tobytes()
    np.testing.assert_array_equal(arr, (np.arange(24) - 7).astype(
        dtype).reshape(4, 6))               # the input is never damaged


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
@pytest.mark.parametrize("mode", ["bitflip", "nan", "scale"])
def test_corrupt_torch_keeps_type(mode, dtype):
    """A tensor comes back a tensor of its dtype and device, damaged at
    the element the numpy path of the same seed picks."""
    x = (torch.arange(24) - 7).to(dtype)
    with pfaults.FaultInjector(seed=5) as fi:
        fi.arm_corrupt("v", mode=mode, always=True, factor=3.0)
        y = pfaults.fault_value("v", x)
    assert torch.is_tensor(y) and y.dtype == dtype and y.device == x.device
    assert not torch.equal(y, x)
    if mode == "scale":
        torch.testing.assert_close(y, (x * 3.0).to(dtype))
    else:
        diff = (y != x) & ~(torch.isnan(y.float()) & torch.isnan(x.float()))
        assert int(diff.sum()) == 1
        if mode == "nan" and dtype != torch.int32:
            assert math.isnan(float(y[diff][0]))
