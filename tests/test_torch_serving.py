"""The port's `ContinuousBatchingEngine` (`paddle_tpu_torch.models.
serving`, ``device="cpu"``) against the JAX engine: on the same seeded
`LlamaConfig.tiny()` weights and prompts the two give EQUAL greedy token
streams — with more requests than slots, with ``prefill_chunk=16``
(chunk continuations), with an ``eos_token_id``, and with a prompt near
``max_seq_len`` — and leave clean page accounting after `run()`."""
import re

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.serving import (_UNPORTED_OPTIONS,
                                             ContinuousBatchingEngine,
                                             EngineOverloaded, ModelMismatch)

S = 64
# five requests for two slots; the 60-token prompt ends at the cache end
LENS = (5, 20, 40, 60, 13)
NEW = (6, 9, 5, 8, 7)


@pytest.fixture(scope="module")
def models():
    paddle.seed(5)
    jm = JLlama(JConfig.tiny())
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n) for n in LENS]
    return jm, tm, prompts


def _serve(engine, prompts):
    for p, n in zip(prompts, NEW):
        engine.add_request(p, max_new_tokens=n)
    out = engine.run()
    engine.check_invariants()
    assert len(engine._free) == engine.num_pages - 1
    return out


def _port(tm, **kw):
    return ContinuousBatchingEngine(tm, max_batch_size=2, max_seq_len=S,
                                    device="cpu", **kw)


def _jax(jm, **kw):
    return JEngine(jm, max_batch_size=2, max_seq_len=S, **kw)


@pytest.mark.parametrize("chunk", [None, 16])
def test_greedy_streams_equal_jax(models, chunk):
    jm, tm, prompts = models
    want = _serve(_jax(jm, prefill_chunk=chunk), prompts)
    got = _serve(_port(tm, prefill_chunk=chunk), prompts)
    assert got == want
    # the near-S prompt stops at the cache end, not at max_new_tokens
    assert len(got[3]) == S - 1 - LENS[3] + 1 < NEW[3]


def test_eos_streams_equal_jax(models):
    jm, tm, prompts = models
    free_run = _serve(_port(tm), prompts)
    eos = free_run[1][2]                 # a token request 1 emits third
    want = _serve(_jax(jm, eos_token_id=eos, prefill_chunk=16), prompts)
    got = _serve(_port(tm, eos_token_id=eos, prefill_chunk=16), prompts)
    assert got == want
    assert got[1][-1] == eos and len(got[1]) <= 3


def test_dispatch_counts(models):
    _, tm, prompts = models
    eng = _port(tm, prefill_chunk=16)
    out = _serve(eng, prompts)
    assert eng.num_dispatches == (eng.num_admission_dispatches
                                  + eng.num_decode_dispatches)
    assert eng.decode_tokens == sum(len(v) - 1 for v in out.values())


def test_preemption_keeps_greedy_streams(models, monkeypatch):
    """With reservation bypassed on a tight pool, lazy page growth runs
    dry and preempts the youngest slot, which re-prefills its prompt
    plus its tokens and continues the same greedy stream."""
    _, tm, prompts = models
    want = _serve(_port(tm), prompts[:2])
    eng = _port(tm, page_size=4, num_pages=9)
    monkeypatch.setattr(eng, "_reserve_ok", lambda req: True)
    got = _serve(eng, prompts[:2])
    assert eng.num_preemptions > 0
    assert got == want


@pytest.mark.parametrize("name,off,item", _UNPORTED_OPTIONS,
                         ids=[o[0] for o in _UNPORTED_OPTIONS])
def test_unported_options_raise(models, name, off, item):
    _, tm, _ = models
    value = True if off is False else object() if off is None else off + 1
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.*item {re.escape(item)}"):
        _port(tm, **{name: value})


@pytest.mark.parametrize("kw", [dict(adapter="a")])
def test_unported_request_options_raise(models, kw):
    """Every request option is ported (deadlines:
    tests/test_torch_serving_deadlines.py); an adapter that is not
    resident is refused before enqueue (tests/test_torch_lora.py)."""
    _, tm, prompts = models
    with pytest.raises(ModelMismatch, match="not resident"):
        _port(tm).add_request(prompts[0], **kw)


def test_backpressure_and_policy(models):
    _, tm, prompts = models
    eng = _port(tm, max_waiting=1)
    eng.add_request(prompts[0])
    with pytest.raises(EngineOverloaded):
        eng.add_request(prompts[1])
    eng = _port(tm, admission_policy=lambda e, r: len(r.prompt) < 30)
    eng.add_request(prompts[0])
    with pytest.raises(EngineOverloaded):
        eng.add_request(prompts[2])


def test_priority_class_admits_first(models):
    _, tm, prompts = models
    eng = _port(tm)
    low = eng.add_request(prompts[0], max_new_tokens=1, priority=1)
    high = eng.add_request(prompts[1], max_new_tokens=1, priority=0)
    assert [r.rid for r in eng._queue] == [high, low]


def test_engine_rejects_other_device(models):
    _, tm, _ = models
    with pytest.raises(ValueError, match="device"):
        ContinuousBatchingEngine(tm, device="meta")


def test_request_validation(models):
    _, tm, prompts = models
    eng = _port(tm)
    with pytest.raises(ValueError):
        eng.add_request([], max_new_tokens=1)
    with pytest.raises(ValueError):
        eng.add_request(prompts[0], max_new_tokens=0)
    with pytest.raises(ValueError):
        eng.add_request(np.zeros(S, np.int64))
