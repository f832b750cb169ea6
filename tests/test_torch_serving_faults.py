"""The port's failure isolation, decode retries and speculative
degradation against the JAX engine's: the drills of tests/test_chaos.py
`TestEngineChaos` and `TestSpeculativeChaos`, run on the same tiny Llama
(weights carried with `llama_state_from_numpy`) in both engines, each
armed through its own package's `FaultInjector`. Every drill compares
the requests' statuses, error strings, streams and preemption counts,
`lifecycle_info()`, `spec_info()` and the pages left in use; the engine
invariants are checked after every step of both. The prefill drill runs
on the ragged path, the legacy path and at ``harvest_every=4``, the
decode and pool drills on the ragged path and at k = 4; a sampled engine
whose decode faults once keeps the streams of its unfaulted run. On the
legacy path a ``serving.alloc_page`` fault after the prefill ran fails
that request alone on both engines, and a failure once the page scatter
began writing the pools re-raises."""
import collections
import time
import types

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.observability as jtelemetry
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models import serving as jserving
from paddle_tpu.utils import faults as jfaults
import paddle_tpu_torch.observability as telemetry
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import serving
from paddle_tpu_torch.utils import faults

TARGET = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=1, max_position_embeddings=64)
DRAFT = dict(TARGET, hidden_size=16, intermediate_size=32,
             num_hidden_layers=1)
JOBS = [([5, 4, 3, 2, 6, 7], 8), ([9, 1, 2], 6)]
LAYOUTS = {"ragged": {}, "legacy": {"attention_impl": "legacy"},
           "k4": {"harvest_every": 4}}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


def _pair(seed, cfg):
    paddle.seed(seed)
    jm = JLlama(JConfig(**cfg))
    jm.eval()
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm


@pytest.fixture(scope="module")
def sides():
    (jm, tm), (jd, td) = _pair(7, TARGET), _pair(8, DRAFT)
    jax = types.SimpleNamespace(name="jax", mod=jserving, faults=jfaults,
                                model=jm, draft=jd, telemetry=jtelemetry,
                                kw={})
    port = types.SimpleNamespace(name="port", mod=serving, faults=faults,
                                 model=tm, draft=td, telemetry=telemetry,
                                 kw={"device": "cpu"})
    return jax, port


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Invariants after every step, telemetry recording, both registries
    and trace rings empty, and the retrace-storm windows out of the way
    (they count compiles on the host's clock, which the two engines
    spend differently)."""
    monkeypatch.setenv("PDT_CHECK_INVARIANTS", "1")
    monkeypatch.setenv("PDT_TELEMETRY", "1")
    for t in (telemetry, jtelemetry):
        t.reset()
        t.clear_events()
        t.profile.configure_retrace(threshold=10 ** 6)
    yield
    for t in (telemetry, jtelemetry):
        t.reset()
        t.clear_events()
        t.profile.configure_retrace(window_s=30.0, threshold=10,
                                    clock=time.monotonic)


def _engine(side, layout="ragged", spec=None, **kw):
    kw = dict(dict(max_batch_size=2, max_seq_len=64, page_size=4),
              **LAYOUTS[layout], **kw, **side.kw)
    if spec is not None:
        kw["spec_decode"] = side.mod.SpecConfig(side.draft, k=spec)
    return side.mod.ContinuousBatchingEngine(side.model, **kw)


def _drain(eng):
    """run(), keeping the Request objects."""
    reqs = {}
    while eng._queue or any(r is not None for r in eng._slot_req):
        for r in eng.step():
            reqs[r.rid] = r
    return reqs


def _arm(side, fi, arms):
    for site, opts in arms:
        opts = dict(opts)
        if opts.get("exc") == "PoolExhausted":
            opts["exc"] = side.mod.PoolExhausted
        fi.arm(site, **opts)


def _outcome(eng, rids, reqs):
    return {"streams": [reqs[r].output for r in rids],
            "statuses": [reqs[r].status for r in rids],
            "errors": [reqs[r].error for r in rids],
            "preemptions": [reqs[r].preemptions for r in rids],
            "lifecycle": eng.lifecycle_info(),
            "spec": eng.spec_info(),
            "pages_in_use": eng.cache_memory_info()["pages_in_use"]}


def _drill(side, arms=(), jobs=JOBS, layout="ragged", spec=None, **kw):
    eng = _engine(side, layout, spec, **kw)
    rids = [eng.add_request(p, n) for p, n in jobs]
    with side.faults.FaultInjector() as fi:
        _arm(side, fi, arms)
        reqs = _drain(eng)
    return eng, fi, _outcome(eng, rids, reqs)


def _both(sides, *args, **kw):
    """The drill on both engines: their outcomes must be equal."""
    (_, _, want), (eng, fi, got) = [_drill(s, *args, **kw) for s in sides]
    assert got == want
    return eng, fi, got


def _fired(side, site):
    return side.telemetry.value("pdt_faults_fired_total", site=site)


@pytest.mark.parametrize("layout", ["ragged", "k4"])
def test_pool_exhaustion_preempts_and_recovers(sides, layout):
    """A forced exhaustion at the first decode-time growth preempts the
    youngest request, which re-prefills; streams as unfaulted. At k = 4
    the growth first harvests the pending window and retries, and the
    retry finds a page: no preemption."""
    ref = _drill(sides[1], layout=layout)[2]
    _, fi, got = _both(sides, [("serving.alloc_page",
                                dict(nth=4, exc="PoolExhausted"))],
                       layout=layout)
    assert got["streams"] == ref["streams"]
    n = 0 if layout == "k4" else 1
    assert got["lifecycle"]["preemptions"] == n
    assert got["preemptions"] == [0, n] and got["pages_in_use"] == 0
    assert _fired(sides[1], "serving.alloc_page") \
        == _fired(sides[0], "serving.alloc_page") \
        == fi.trips("serving.alloc_page") == 1


def test_self_preemption_resumes_and_matches(sides):
    _, _, got = _both(sides, [("serving.alloc_page",
                               dict(nth=3, exc="PoolExhausted"))],
                      jobs=JOBS[:1], max_batch_size=1)
    assert got["preemptions"] == [1]
    assert got["statuses"] == ["finished"]


def test_admission_alloc_exhaustion_requeues(sides):
    jobs = [([5, 4, 3, 2, 6, 7], 4), ([9, 1, 2], 6)]
    _, _, got = _both(sides, [("serving.alloc_page",
                               dict(nth=4, exc="PoolExhausted"))],
                      jobs=jobs, max_batch_size=1)
    assert got["lifecycle"]["failures"] == 0
    assert got["preemptions"] == [0, 1]


def test_preemption_starvation_guard(sides):
    _, _, got = _both(sides, [("serving.alloc_page",
                               dict(nth=3, exc="PoolExhausted"))],
                      jobs=[([5, 4, 3, 2, 6, 7], 8)], max_batch_size=1,
                      max_preemptions=0)
    assert got["statuses"] == ["preempted"]
    assert "starvation" in got["errors"][0] and got["streams"][0]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefill_failure_isolates_request(sides, layout):
    """The first admission fails alone, FAILED with the fault's text;
    the other request decodes as unfaulted, and the engine serves on."""
    ref = _drill(sides[1], layout=layout)[2]
    outs = []
    for side in sides:
        eng, _, got = _drill(side, [("serving.prefill", dict(nth=1))],
                             layout=layout)
        c = eng.add_request(JOBS[0][0], 8)
        got["after"] = eng.run()[c]
        got["after_lifecycle"] = eng.lifecycle_info()
        got["fired"] = _fired(side, "serving.prefill")
        got["terminal_failed"] = side.telemetry.value(
            "pdt_serving_requests_terminal_total", status="failed")
        got["fire_events"] = sum(
            e["name"] == "fault.fire"
            and e["attrs"]["site"] == "serving.prefill"
            for e in side.telemetry.events())
        outs.append(got)
    want, got = outs
    assert got == want
    assert got["statuses"] == ["failed", "finished"]
    assert got["errors"][0] == ("FaultError: injected fault at "
                                "'serving.prefill' (visit #1)")
    assert got["streams"] == [[], ref["streams"][1]]
    assert got["after"] == ref["streams"][0]
    assert got["lifecycle"]["failures"] == 1
    assert got["fired"] == got["terminal_failed"] == got["fire_events"] == 1
    assert got["after_lifecycle"]["running"] == 0


def test_legacy_alloc_fault_after_prefill_fails_one_request(sides):
    """``serving.alloc_page`` with its default FaultError at the first
    allocation of a legacy admission: the bucketed prefill has run and
    no row has reached the pages. Both engines fail that request alone,
    with the same text, and serve the other to its unfaulted stream;
    lifecycle, pages in use and the invariants (every step) agree."""
    ref = _drill(sides[1], layout="legacy")[2]
    _, fi, got = _both(sides, [("serving.alloc_page", dict(nth=1))],
                       layout="legacy")
    assert got["statuses"] == ["failed", "finished"]
    assert got["errors"][0] == ("FaultError: injected fault at "
                                "'serving.alloc_page' (visit #1)")
    assert got["streams"] == [[], ref["streams"][1]]
    assert got["lifecycle"]["failures"] == 1
    assert got["pages_in_use"] == 0 and fi.trips("serving.alloc_page") == 1


def test_legacy_failure_after_pool_write_reraises(sides, monkeypatch):
    """A legacy admission that fails once its scatter began writing the
    pools re-raises out of step(), as the JAX engine re-raises once a
    donating dispatch consumed the pools: the pools may hold a partial
    write, so failing the one request and serving on is not safe."""
    eng = _engine(sides[1], "legacy")
    eng.add_request(*JOBS[0])
    run = eng._run_program

    def broken(prog):
        if prog.family == "scatter":
            raise RuntimeError("scatter launch failed")
        return run(prog)
    monkeypatch.setattr(eng, "_run_program", broken)
    with pytest.raises(RuntimeError, match="scatter launch failed"):
        eng.step()
    assert eng._pool_writes == 1 and eng.num_failures == 0


def test_deadline_expiry_mid_decode(sides):
    outs = []
    for side in sides:
        clk = FakeClock()
        eng = _engine(side, clock=clk)
        rid = eng.add_request([5, 4, 3, 2, 6, 7], 32, deadline=10.0)
        first = eng.step()
        clk.advance(11.0)
        done = eng.step()
        outs.append((first, [(r.rid, r.status, r.output) for r in done],
                     eng.lifecycle_info(),
                     eng.cache_memory_info()["pages_in_use"]))
    assert outs[1] == outs[0]
    assert outs[1][1][0][:2] == (rid, "timeout")


def test_max_queue_time_expires_waiting_request(sides):
    outs = []
    for side in sides:
        clk = FakeClock()
        eng = _engine(side, max_batch_size=1, clock=clk)
        a = eng.add_request([5, 4, 3], 24)
        b = eng.add_request([9, 1, 2], 8, max_queue_time=5.0)
        eng.step()
        clk.advance(6.0)
        done = {r.rid: (r.status, r.output) for r in eng.step()}
        reqs = _drain(eng)
        outs.append((done, reqs[a].status, reqs[a].output,
                     eng.lifecycle_info()))
    assert outs[1] == outs[0]
    assert outs[1][0][b] == ("timeout", [])


def test_backpressure_and_admission_policy(sides):
    """The refusals and their counters (the requests the JAX drill then
    serves are ordinary admissions, which the other drills run)."""
    outs = []
    for side in sides:
        eng = _engine(side, max_waiting=2)
        eng.add_request([1, 2], 2)
        eng.add_request([3, 4], 2)
        with pytest.raises(side.mod.EngineOverloaded, match="queue full"):
            eng.add_request([5, 6], 2)
        pol = _engine(side, admission_policy=lambda e, r: len(r.prompt) <= 4)
        pol.add_request([1, 2, 3, 4], 2)
        with pytest.raises(side.mod.EngineOverloaded, match="policy"):
            pol.add_request([1, 2, 3, 4, 5], 2)
        outs.append(([side.telemetry.value(
            "pdt_serving_rejections_total", reason=why)
            for why in ("queue_full", "policy")], eng.lifecycle_info(),
            pol.lifecycle_info()))
    assert outs[1] == outs[0]
    assert outs[1][0] == [1.0, 1.0]


@pytest.mark.parametrize("layout", ["ragged", "k4"])
def test_decode_fault_retries_transparently(sides, layout):
    ref = _drill(sides[1], jobs=[([5, 4, 3], 6)], layout=layout)[2]
    _, _, got = _both(sides, [("serving.decode", dict(nth=2))],
                      jobs=[([5, 4, 3], 6)], layout=layout)
    assert got["streams"] == ref["streams"]
    assert got["lifecycle"]["decode_retries"] == 1


@pytest.mark.parametrize("layout", ["ragged", "k4"])
def test_decode_fault_persistent_raises_after_cap(sides, layout):
    outs = []
    for side in sides:
        eng = _engine(side, layout, max_decode_retries=2)
        eng.add_request([5, 4, 3], 6)
        with side.faults.FaultInjector() as fi:
            fi.arm("serving.decode", always=True)
            with pytest.raises(side.faults.FaultError) as err:
                eng.run()
        outs.append((str(err.value), err.value.site, eng.lifecycle_info()))
    assert outs[1] == outs[0]
    assert outs[1][2]["decode_retries"] == 3        # 2 retries + the raiser


def test_starvation_finalize_survives_decode_fault(sides):
    _, _, got = _both(sides, [("serving.alloc_page",
                               dict(nth=4, exc="PoolExhausted")),
                              ("serving.decode", dict(nth=2))],
                      max_preemptions=0)
    assert got["statuses"] == ["finished", "preempted"]
    assert got["lifecycle"]["decode_retries"] == 1


def test_finished_backlog_survives_retry_cap_raise(sides):
    outs = []
    for side in sides:
        eng = _engine(side, max_preemptions=0, max_decode_retries=0)
        rids = [eng.add_request(p, n) for p, n in JOBS]
        with side.faults.FaultInjector() as fi:
            _arm(side, fi, [("serving.alloc_page",
                             dict(nth=4, exc="PoolExhausted")),
                            ("serving.decode", dict(nth=2))])
            with pytest.raises(side.faults.FaultError):
                eng.run()
        outs.append(_outcome(eng, rids, _drain(eng)))
    assert outs[1] == outs[0]
    assert outs[1]["statuses"] == ["finished", "preempted"]


def test_invariant_checker_catches_corruption(sides):
    for side in sides:
        eng = _engine(side)
        eng.check_invariants()
        leaked = eng._free.pop()
        with pytest.raises(side.mod.EngineInvariantError, match="LEAKED"):
            eng.check_invariants()
        eng._free.append(leaked)
        eng.check_invariants()
        eng._free.append(leaked)
        with pytest.raises(side.mod.EngineInvariantError,
                           match="duplicates"):
            eng.check_invariants()


def _series(side, eng):
    """Every counter (the retrace storms aside), every histogram's
    observation count, the span and event names and the memory ledger
    in ``side``'s package."""
    snap = side.telemetry.snapshot()
    return ({n: s for n, s in snap["counters"].items()
             if n != "pdt_jit_retrace_storms_total"},
            {n: {k: v["count"] for k, v in s.items()}
             for n, s in snap["histograms"].items()},
            collections.Counter(e["name"] for e in side.telemetry.events()),
            side.telemetry.profile.memory_ledger([eng]))


def test_spec_draft_fault_degrades_round_not_request(sides):
    """``speculative.draft`` at its second visit: that round decodes
    plainly, every request finishes with the plain stream, and both
    engines count one degraded round, its event and its fault; the spec
    engines' whole telemetry (counters, histogram counts, the program
    families, span and event names, the ledger's draft pool) is equal."""
    plain = _drill(sides[1])[2]
    for t in (telemetry, jtelemetry):
        t.reset()
        t.clear_events()
    series = []
    for side in sides:
        eng, _, got = _drill(side, [("speculative.draft", dict(nth=2))],
                             spec=4)
        series.append((got, _series(side, eng)))
    (want, jseries), (got, pseries) = series
    assert got == want and pseries == jseries
    assert set(pseries[0]["pdt_jit_compiles_total"]) == {
        'family="ragged"', 'family="draft"', 'family="draft_scan"',
        'family="verify"', 'family="decode"'}
    assert pseries[3]["draft_pool"] > 0
    assert got["streams"] == plain["streams"]
    assert got["spec"]["degraded"] == 1 and got["spec"]["rounds"] >= 1
    for side in sides:
        snap = side.telemetry.snapshot()["counters"]
        assert snap["pdt_spec_degraded_total"]['site="draft"'] == 1
        assert snap["pdt_faults_fired_total"][
            'site="speculative.draft"'] == 1
        ev = [e for e in side.telemetry.events()
              if e["name"] == "serving.spec_degraded"]
        assert len(ev) == 1 and ev[0]["attrs"]["site"] == "draft"


def test_spec_verify_fault_storm_never_fails_requests(sides):
    plain = _drill(sides[1])[2]
    _, _, got = _both(sides, [("speculative.verify", dict(always=True))],
                      spec=4)
    assert got["streams"] == plain["streams"]
    assert set(got["statuses"]) == {"finished"}
    assert got["spec"]["rounds"] == 0 and got["spec"]["degraded"] >= 1
    for side in sides:
        assert side.telemetry.value("pdt_spec_degraded_total",
                                    site="verify") \
            == got["spec"]["degraded"] \
            == side.telemetry.value("pdt_faults_fired_total",
                                    site="speculative.verify")


def test_sampled_decode_fault_keeps_the_streams(sides):
    """A sampled engine's decode faults once: the retried step draws
    the same uniforms (the key advances only at a dispatch), so the
    streams and the sampling counter equal the unfaulted run's."""
    port = sides[1]
    kw = dict(do_sample=True, temperature=0.8, top_p=0.9, seed=3)
    eng0, _, ref = _drill(port, **kw)
    eng1, _, got = _drill(port, [("serving.decode", dict(nth=3))], **kw)
    assert got["streams"] == ref["streams"]
    assert got["lifecycle"]["decode_retries"] == 1
    assert eng1._sample_ctr == eng0._sample_ctr
