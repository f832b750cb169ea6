"""Pipelined decode in the port (`ContinuousBatchingEngine(
harvest_every=k)`, ``device="cpu"``) against its own k = 1 loop and the
JAX engine, on the same seeded `LlamaConfig.tiny()` weights (crossing as
numpy), mirroring tests/test_async_pipeline.py `TestEnginePipeline`:

- k in {2, 4, 8} gives the k = 1 streams, which equal the JAX engine's,
  with more jobs than slots (queue pressure forces early harvests), past
  an EOS the device cannot see mid-window (the overshoot is discarded),
  under quantized weights and KV, and through preemption (the window is
  harvested before a victim is chosen);
- k = 1 keeps the synchronous loop; `quiesce` drains a window, and each
  path that touches slot state from outside the loop drains it first;
  ``device_len`` runs ahead of ``output`` inside a window and resyncs;
- the constructor's checks, and a deadline that passes mid-window
  finalizing at the token count of k = 1 and of the JAX engine (a fake
  clock);
- a window's accounting: the committed tokens equal k = 1's, and its
  decode seconds hold the dispatch walls and the harvest copy."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models.serving import QuantServingConfig as JQuant
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.generation import RequestStatus
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                             QuantServingConfig)

# more jobs than slots, staggered budgets: queue pressure forces early
# harvests (the admission trigger) and full windows coexist
JOBS = [([1, 2, 3], 9), ([4, 5], 7), ([6, 7, 8, 9], 5),
        ([2, 2], 12), ([9, 1], 3)]
KS = [2, 4, 8]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JLlama(JConfig.tiny())
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm


def _opts(kw):
    return dict(dict(max_batch_size=3, max_seq_len=64, page_size=4), **kw)


def _port(tm, k=1, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", harvest_every=k,
                                    **_opts(kw))


def _serve(eng, jobs=JOBS):
    rids = [eng.add_request(p, n) for p, n in jobs]
    res = eng.run()
    eng.check_invariants()
    assert len(eng._free) == eng.num_pages - 1
    assert eng._pending == [] and eng._tok_dev is None
    return [res[r] for r in rids]


def _deadline_script(eng, clock):
    doomed = eng.add_request([1, 2, 3], 30, deadline=4.0)
    safe = eng.add_request([4, 5], 6)
    outs = {}
    for _ in range(40):
        for r in eng.step():
            outs[r.rid] = (r.status, list(r.output))
        clock.advance(1.0)
        if doomed in outs and safe in outs:
            break
    return outs[doomed], outs[safe]


@pytest.fixture(scope="module")
def reference(models):
    """The JAX engine's k = 1 streams: plain, with an EOS that fires
    mid-stream, under int8 weights and KV, and the deadline script."""
    jm, _ = models
    plain = _serve(JEngine(jm, **_opts({})))
    # the last token of request 1, which request 3 also emits mid-stream:
    # at k >= 4 it fires inside windows that go on past it
    eos = plain[1][6]
    clock = FakeClock()
    return dict(plain=plain, eos=eos,
                eos_streams=_serve(JEngine(jm, eos_token_id=eos,
                                           **_opts({}))),
                quant=_serve(JEngine(jm, quant=JQuant("int8", "int8"),
                                     **_opts({}))),
                deadline=_deadline_script(JEngine(jm, clock=clock,
                                                  **_opts({})), clock))


@pytest.mark.parametrize("k", [1] + KS)
def test_streams_equal_k1_and_jax(models, reference, k):
    _, tm = models
    assert _serve(_port(tm, k)) == reference["plain"]


@pytest.mark.parametrize("k", KS)
def test_eos_overshoot_discarded(models, reference, k):
    """The device cannot see an EOS mid-window and runs up to k - 1
    dispatches past it; the harvest discards those tokens."""
    _, tm = models
    want = reference["eos_streams"]
    assert any(len(r) < n for r, (_, n) in zip(want, JOBS))
    eng = _port(tm, k, eos_token_id=reference["eos"])
    made = []                # tokens of active slots the windows made
    harvest = eng._harvest_pending

    def counted(finished):
        made.append(sum(len(e["act"]) for e in eng._pending))
        harvest(finished)
    eng._harvest_pending = counted
    assert _serve(eng) == want
    ref = _port(tm, 1, eos_token_id=reference["eos"])
    assert _serve(ref) == want
    assert eng.decode_tokens == ref.decode_tokens
    if k >= 4:
        assert sum(made) > eng.decode_tokens       # an overshoot happened


@pytest.mark.parametrize("k", [1, 4])
def test_quantized_streams_equal_k1_and_jax(models, reference, k):
    _, tm = models
    eng = _port(tm, k, quant=QuantServingConfig("int8", "int8"))
    assert _serve(eng) == reference["quant"]


def test_k1_keeps_the_synchronous_loop(models, reference):
    _, tm = models
    eng = _port(tm, 1)
    rids = [eng.add_request(p, n) for p, n in JOBS[:2]]
    eng.step()
    eng.step()
    assert eng._pending == [] and eng._tok_dev is None
    assert eng.quiesce() == 0
    out = eng.run()
    assert [out[r] for r in rids] == reference["plain"][:2]


def test_quiesce_drains_the_window(models, reference):
    _, tm = models
    eng = _port(tm, 4)
    rids = [eng.add_request(p, n) for p, n in JOBS[:2]]
    eng.step()                          # admission + first dispatch
    eng.step()                          # a deferred dispatch
    assert len(eng._pending) == 2 and eng._tok_dev is not None
    assert eng.quiesce() == 2
    assert eng._pending == [] and eng._tok_dev is None
    out = eng.run()
    assert [out[r] for r in rids] == reference["plain"][:2]


def test_device_len_runs_ahead_then_resyncs(models):
    _, tm = models
    eng = _port(tm, 4)
    rid = eng.add_request([1, 2, 3], 9)
    for _ in range(3):
        eng.step()
    (req,) = [r for r in eng._slot_req if r is not None and r.rid == rid]
    depth = len(eng._pending)
    assert depth == 3
    assert req.device_len == len(req.output) + depth
    eng.quiesce()
    assert req.device_len == len(req.output) == 4


@pytest.mark.parametrize("seam", ["check_invariants", "install_adapter",
                                  "evict_adapter", "install_weights"])
def test_outside_calls_drain_the_window(models, reference, seam):
    """Each call that touches slot state from outside the loop drains a
    window first; the streams stay the k = 1 streams (install_weights
    then refuses: the engine is busy)."""
    _, tm = models
    eng = _port(tm, 4)
    k = tm.config.hidden_size
    nm = "model.layers.0.mlp.up_proj.weight"
    delta = {nm: (np.zeros((k, 2), np.float32),
                  np.zeros((2, tm.config.intermediate_size), np.float32))}
    if seam == "evict_adapter":
        eng.install_adapter("a0", delta)
    rids = [eng.add_request(p, n) for p, n in JOBS]
    for _ in range(3):
        eng.step()
    assert eng._pending
    if seam == "install_weights":
        with pytest.raises(ValueError, match="busy"):
            eng.install_weights({n: p.detach() for n, p in
                                 tm.named_parameters()}, "other")
    elif seam == "install_adapter":
        eng.install_adapter("a1", delta)
    elif seam == "evict_adapter":
        eng.evict_adapter("a0")
    else:
        eng.check_invariants()
    assert eng._pending == [] and eng._tok_dev is None
    out = {}
    for r in eng.step():               # the drained finishes come back
        out[r.rid] = r.output
    out.update(eng.run())
    assert [out[r] for r in rids] == reference["plain"]


def test_preemption_harvests_the_window_first(models, monkeypatch):
    """With reservation bypassed on a tight pool, lazy growth runs dry
    inside a window (9-token prompts put page edges off the window's):
    the window is harvested before a victim is chosen, so the victim
    keeps every token the device made and re-prefills exactly what it
    would at k = 1."""
    _, tm = models
    jobs = [(list(range(1, 10)), 6), (list(range(30, 39)), 12)]
    runs = {}
    for k in (1, 4):
        eng = _port(tm, k, max_batch_size=2, num_pages=8)
        monkeypatch.setattr(eng, "_reserve_ok", lambda req: True)
        runs[k] = (_serve(eng, jobs), eng.num_preemptions,
                   eng.admission_tokens, eng.decode_tokens)
    assert runs[4] == runs[1]
    streams, preemptions = runs[1][:2]
    assert preemptions > 0
    assert [len(s) for s in streams] == [6, 12]


@pytest.mark.parametrize("kw,match", [
    (dict(harvest_every=0), "harvest_every"),
    (dict(harvest_every=4, do_sample=True), "greedy-only"),
    (dict(harvest_every=4, spec_decode=object()), "spec_decode"),
    (dict(harvest_every=4, attention_impl="legacy"), "ragged"),
    (dict(harvest_every=4, kv_layout="dense"), "ragged")])
def test_constructor_validation(models, kw, match):
    _, tm = models
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingEngine(tm, device="cpu", **kw)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_deadline_expiry_mid_window(models, reference, k):
    """A deadline that passes inside a window finalizes at the token
    count of k = 1 and of the JAX engine: the running-deadline trigger
    harvests the window before expiry acts."""
    _, tm = models
    clock = FakeClock()
    got = _deadline_script(_port(tm, k, clock=clock), clock)
    assert got == reference["deadline"]
    assert got[0][0] == RequestStatus.TIMEOUT
    assert got[1][0] == RequestStatus.FINISHED


def test_window_accounting(models):
    _, tm = models
    ref, eng = _port(tm, 1), _port(tm, 4)
    _serve(ref)
    _serve(eng)
    assert eng.decode_tokens == ref.decode_tokens
    assert eng.num_decode_dispatches == ref.num_decode_dispatches
    assert eng.decode_seconds > 0 and eng._window_wall == 0.0
