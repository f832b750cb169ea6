"""The port engine's telemetry against the JAX engine's, telemetry on in
both for the same request sequence on the same tiny Llama (weights
carried with `llama_state_from_numpy`): every counter, every
histogram's observation count (the decode-round decomposition's
components and the program cache's compile seconds included), the
deterministic gauges, the ``pdt_jit_*`` series by program family, the
multiset of span and event names and the `memory_ledger` pools are
equal, on the ragged path with the prefix cache, at ``harvest_every=4``
and on the legacy path (a spec engine's, through a degraded round: in
tests/test_torch_serving_faults.py). `profile_round()`
gives the JAX op-pair set, writes only the rows the next step writes
again, and leaves every later stream bitwise as it was; telemetry on and
off give the same streams."""
import collections
import time
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability as jtelemetry
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models import serving as jserving
from paddle_tpu.observability import profile as jprofile
import paddle_tpu_torch.observability as telemetry
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import serving
from paddle_tpu_torch.observability import profile as pprofile

TARGET = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=1, max_position_embeddings=64)
DRAFT = dict(TARGET, hidden_size=16, intermediate_size=32,
             num_hidden_layers=1)
SHARED = [3, 1, 4, 1, 5, 9, 2, 6]
JOBS = [([5, 4, 3, 2, 6, 7], 8), ([9, 1, 2], 6), ([7, 7, 1, 2], 1),
        (SHARED + [7, 7], 6), (SHARED + [2, 8, 1], 5)]
CONFIGS = {"ragged": {"enable_prefix_caching": True},
           "k4": {"harvest_every": 4},
           "legacy": {"attention_impl": "legacy"}}
# the gauges whose values do not depend on the host's clock
GAUGES = ("pdt_serving_queue_depth", "pdt_serving_running_slots",
          "pdt_serving_pages_in_use", "pdt_serving_page_occupancy",
          "pdt_jit_cache_entries", "pdt_spec_acceptance_rate",
          "pdt_mem_bytes")


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
    jax = types.SimpleNamespace(mod=jserving, model=jm, draft=jd,
                                telemetry=jtelemetry, profile=jprofile,
                                kw={})
    port = types.SimpleNamespace(mod=serving, model=tm, draft=td,
                                 telemetry=telemetry, profile=pprofile,
                                 kw={"device": "cpu"})
    return jax, port


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Recording on, both registries and trace rings empty, and the
    retrace-storm windows out of the way (they count compiles on the
    host's clock, which the two engines spend differently)."""
    monkeypatch.setenv("PDT_TELEMETRY", "1")
    for t, prof in ((telemetry, pprofile), (jtelemetry, jprofile)):
        t.reset()
        t.clear_events()
        prof.configure_retrace(threshold=10 ** 6)
    yield
    for t, prof in ((telemetry, pprofile), (jtelemetry, jprofile)):
        t.reset()
        t.clear_events()
        prof.configure_retrace(window_s=30.0, threshold=10,
                               clock=time.monotonic)


def _engine(side, spec=None, **kw):
    kw = dict(dict(max_batch_size=2, max_seq_len=64, page_size=4), **kw,
              **side.kw)
    if spec is not None:
        kw["spec_decode"] = side.mod.SpecConfig(side.draft, k=spec)
    return side.mod.ContinuousBatchingEngine(side.model, **kw)


def _serve(side, jobs=JOBS, **kw):
    eng = _engine(side, **kw)
    rids = [eng.add_request(p, n, request_id=f"q{i}")
            for i, (p, n) in enumerate(jobs)]
    out = eng.run()
    return eng, [out[r] for r in rids]


def _reading(side, eng):
    """What the two engines must agree on, from ``side``'s registry and
    trace ring."""
    snap = side.telemetry.snapshot()
    counters = {n: s for n, s in snap["counters"].items()
                if n != "pdt_jit_retrace_storms_total"}
    hists = {n: {k: v["count"] for k, v in s.items()}
             for n, s in snap["histograms"].items()}
    ledger = side.profile.memory_ledger([eng])
    gauges = {n: snap["gauges"].get(n, {}) for n in GAUGES}
    names = collections.Counter(e["name"] for e in side.telemetry.events())
    tree = side.telemetry.request_tree("q1")
    children = collections.Counter(c["event"]["name"]
                                   for c in tree["children"])
    exemplars = {e["trace_id"] for e in snap["histograms"][
        "pdt_serving_ttft_seconds"][""]["exemplars"].values()}
    return {"counters": counters, "hist_counts": hists, "gauges": gauges,
            "names": names, "ledger": ledger, "q1_children": children,
            "ttft_exemplars_known": exemplars <= {
                f"q{i}" for i in range(len(JOBS))}}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_series_equal_jax(sides, config):
    readings, streams = [], []
    for side in sides:
        side.telemetry.start_trace("q1")
        eng, out = _serve(side, **CONFIGS[config])
        streams.append(out)
        readings.append(_reading(side, eng))
    assert streams[1] == streams[0]
    want, got = readings
    for key in want:
        assert got[key] == want[key], key
    assert got["counters"]["pdt_serving_admissions_total"][""] >= len(JOBS)
    # the legacy page scatter is a program family of both engines
    fams = set(got["counters"]["pdt_jit_compiles_total"])
    assert fams == ({'family="prefill"', 'family="scatter"',
                     'family="decode"'}
                    if config == "legacy"
                    else {'family="ragged"', 'family="decode"'})
    # a request's trace: its admission, the decode steps that served it
    # and its terminal event, fanned in under its root alike
    assert got["ttft_exemplars_known"] and got["q1_children"][
        "serving.terminal"] == 1 and got["q1_children"][
        "serving.decode_step"] >= 1
    assert {f'component="{c}"' for c in ("host", "dispatch", "device",
                                         "harvest")} \
        <= set(got["hist_counts"]["pdt_profile_round_seconds"])
    assert {"serving.prefill", "serving.terminal",
            "serving.first_token", "jit.compile"} <= set(got["names"])
    assert got["ledger"]["kv_pool"] > 0


def test_decomposition_sums_to_the_round_wall(sides):
    """The components of every step sum to the steps' measured wall
    (each component is a wall interval of the step)."""
    port = sides[1]
    eng = _engine(port)
    for p, n in JOBS:
        eng.add_request(p, n)
    wall = 0.0
    while eng._queue or any(r is not None for r in eng._slot_req):
        t0 = time.perf_counter()
        eng.step()
        wall += time.perf_counter() - t0
    rounds = pprofile.round_summary(telemetry.snapshot())
    total = sum(r["total_s"] for r in rounds.values())
    assert 0.8 * wall <= total <= wall


def test_telemetry_on_and_off_give_equal_streams(sides, monkeypatch):
    port = sides[1]
    outs = []
    for flag in ("1", "0"):
        monkeypatch.setenv("PDT_TELEMETRY", flag)
        for kw in ({}, {"harvest_every": 4}, {"spec": 4},
                   {"do_sample": True, "temperature": 0.7, "seed": 2}):
            outs.append(_serve(port, **kw)[1])
    assert outs[:4] == outs[4:]


def _pools(eng):
    return [t.clone() for layer in eng._kv for t in layer]


def _steps(eng, out, n=None):
    """Step ``n`` times (None: to the end), collecting finished streams
    into ``out`` by request id."""
    while (eng._queue or any(r is not None for r in eng._slot_req)) \
            and n != 0:
        out.update((r.rid, r.output) for r in eng.step())
        n = None if n is None else n - 1
    return out


@pytest.fixture(scope="module")
def jax_pairs(sides):
    """The op pairs of the JAX engine's gap table, three steps in."""
    jeng = _engine(sides[0])
    for p, n in JOBS:
        jeng.add_request(p, n)
    _steps(jeng, {}, 3)
    return {r["op_pair"] for r in jeng.profile_round()}


@pytest.mark.parametrize("k", [1, 4])
def test_profile_round_pairs_and_streams(sides, jax_pairs, k):
    """profile_round mid-run gives JAX's op pairs; its pass writes each
    active slot's next row (and the trash page) alone, the next step
    writes those rows again, and every stream equals the unprofiled
    run's (which `test_series_equal_jax` holds to JAX's)."""
    port = sides[1]
    jpairs = jax_pairs
    eng = _engine(port, harvest_every=k)
    twin = _engine(port, harvest_every=k)
    outs = ({}, {})
    for e, out in zip((eng, twin), outs):
        for p, n in JOBS:
            e.add_request(p, n)
        _steps(e, out, 3)
    twin.quiesce()
    before = _pools(eng)
    ctr = eng._sample_ctr
    rows = eng.profile_round()
    assert {r["op_pair"] for r in rows} == jpairs
    assert {r["op_pair"] for r in rows} >= {
        "embed->rmsnorm", "rmsnorm->qkv", "qkv->rope", "rope->kv_scatter",
        "kv_scatter->attention", "attention->oproj", "oproj->mlp",
        "mlp->rmsnorm"}
    assert all(r["count"] >= 1 and r["gap_s"] >= 0 for r in rows)
    assert eng._sample_ctr == ctr and not eng._pending
    # the rows the pass wrote: each active slot's next position, and
    # the trash page
    ps = eng.page_size
    allowed = {(0, o) for o in range(ps)}
    for i, r in enumerate(eng._slot_req):
        if r is not None:
            pos = int(eng._pos[i])
            allowed.add((int(eng._bt[i, pos // ps]), pos % ps))
    for b, a in zip(before, _pools(eng)):
        diff = (b != a).any(dim=-1).any(dim=0).nonzero().tolist()
        assert {tuple(d) for d in diff} <= allowed
    # one real step rewrites them: the pools equal the twin's
    for e, out in zip((eng, twin), outs):
        _steps(e, out, 1)
        e.quiesce()
        out.update((r.rid, r.output) for r in e.step())
    for a, b in zip(_pools(eng), _pools(twin)):
        assert torch.equal(a[:, 1:], b[:, 1:])       # page 0 is trash
    for e, out in zip((eng, twin), outs):
        _steps(e, out)
    assert [outs[0][r] for r in range(len(JOBS))] \
        == [outs[1][r] for r in range(len(JOBS))]
    snap = telemetry.snapshot()["gauges"]["pdt_profile_gap_seconds"]
    assert set(snap) == {f'op_pair="{r["op_pair"]}"' for r in rows}


def test_profile_round_refusals(sides):
    port = sides[1]
    with pytest.raises(RuntimeError, match="paged\\+ragged"):
        _engine(port, attention_impl="legacy").profile_round()
    with pytest.raises(RuntimeError, match="active slot"):
        _engine(port).profile_round()


def test_model_store_and_lora_series_equal(sides):
    """The ``pdt_model_store_*`` and ``pdt_lora_*`` series and the ledger's
    ``model_store`` pool after one store call sequence (cold and warm
    installs, an LRU eviction under the byte budget, a pin, a forgotten
    replica) on each package's store and engines."""
    from paddle_tpu.serving import FleetModelStore as JStore
    from paddle_tpu_torch.serving import FleetModelStore
    rng = np.random.default_rng(4)
    targets = ("model.layers.0.self_attn.q_proj.weight",
               "model.layers.1.mlp.gate_proj.weight")
    shapes = {nm: tuple(np.asarray(
        dict(sides[0].model.state_dict())[nm]._value).shape)
        for nm in targets}
    deltas = [{nm: (rng.normal(size=(k, 4)).astype(np.float32),
                    rng.normal(size=(4, n)).astype(np.float32))
               for nm, (k, n) in shapes.items()} for _ in range(2)]
    readings = []
    for side, cls in zip(sides, (JStore, FleetModelStore)):
        store = cls(base_model="base", byte_budget_per_replica=6_000,
                    max_rank=8)
        m1, m2 = [store.register_adapter(a, d)
                  for a, d in zip(("a1", "a2"), deltas)]
        engines = [_engine(side) for _ in range(3)]
        store.ensure("r0", engines[0], m1)
        store.ensure("r0", engines[0], m1)
        store.ensure("r0", engines[0], m2)
        store.ensure("r1", engines[1], m2)
        store.pin("r1", m2)
        store.ensure("r1", engines[1], m1)
        store.unpin("r1", m2)
        store.forget_replica("r1")
        store.ensure("r2", engines[2], m2)
        snap = side.telemetry.snapshot()
        readings.append((
            {n: v for sec in ("counters", "gauges")
             for n, v in snap[sec].items()
             if n.startswith(("pdt_model_store", "pdt_lora"))},
            side.profile.memory_ledger(model_store=store)))
    assert readings[1] == readings[0]
    assert readings[1][0]["pdt_model_store_installs_total"][
        'kind="adapter"'] >= 3
    assert readings[1][1]["model_store"] > 0


def test_generate_spans_equal(sides):
    """One `generate()` call of each model: a ``generate.build`` and a
    ``generate.dispatch`` span with the same attrs."""
    import paddle_tpu as jpaddle
    ids = np.array([[5, 4, 3, 2], [9, 1, 2, 7]], np.int32)
    outs = []
    for side in sides:
        model = side.model
        if side is sides[0]:
            model.generate(jpaddle.to_tensor(ids), max_new_tokens=3)
        else:
            model.generate(torch.from_numpy(ids), max_new_tokens=3)
        outs.append([(e["name"], e["attrs"]) for e in side.telemetry.events()
                     if e["name"].startswith("generate.")])
    assert outs[1] == outs[0]
    assert [n for n, _ in outs[1]] == ["generate.build", "generate.dispatch"]
