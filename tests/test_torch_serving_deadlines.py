"""Request deadlines and queue-time limits in the port
(`ContinuousBatchingEngine(request_timeout=, max_queue_time=)`,
`add_request(deadline=, max_queue_time=)`, ``device="cpu"``) against
the JAX engine, on the same seeded `LlamaConfig.tiny()` weights (crossing
as numpy) and one fake clock that moves 1 s a step: requests expire in
the queue and mid-decode at the same step, with the same statuses and
tokens, the same ``num_timeouts`` and ``lifecycle_info()``, and every
page comes back (to the prefix cache, where it is on, as in JAX: a
request that times out registers its prompt)."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.generation import RequestStatus
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.serving import ContinuousBatchingEngine

SHARED = list(range(1, 13))              # 3 pages of 4
JOBS = [(SHARED + [20], 6), (SHARED + [21, 22], 6), ([40, 41, 42], 3)]

# name: (engine options, per-request add_request options)
SCENARIOS = {
    # a default deadline: request 0 expires mid-decode, 1 and 2 queued
    "request_timeout": (dict(request_timeout=4.0), [{}, {}, {}]),
    # a default queue-time budget: the waiting requests expire
    "max_queue_time": (dict(max_queue_time=2.0), [{}, {}, {}]),
    # per-request budgets override the engine's defaults
    "per_request": (dict(max_batch_size=2, request_timeout=100.0),
                    [dict(deadline=3.0), {}, dict(max_queue_time=1.0)]),
    # request 0 times out mid-decode and registers its prompt in the
    # prefix cache; request 1 then hits it
    "with_prefix_cache": (dict(request_timeout=5.0,
                               enable_prefix_caching=True),
                          [dict(deadline=3.0), dict(deadline=50.0), {}]),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = JLlama(JConfig.tiny())
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm


def _script(build, name):
    """Drive one engine on the fake clock until every request is
    terminal: ({rid: (status, tokens)}, num_timeouts, lifecycle_info,
    the engine)."""
    kw, per_request = SCENARIOS[name]
    clock = FakeClock()
    eng = build(**dict(dict(max_batch_size=1, max_seq_len=64, page_size=4,
                            clock=clock), **kw))
    rids = [eng.add_request(p, n, **o)
            for (p, n), o in zip(JOBS, per_request)]
    outs = {}
    for _ in range(60):
        for r in eng.step():
            outs[r.rid] = (r.status, list(r.output))
        clock.advance(1.0)
        if len(outs) == len(rids):
            break
    return outs, eng.num_timeouts, eng.lifecycle_info(), eng


@pytest.fixture(scope="module")
def jax_runs(models):
    jm, _ = models
    return {name: _script(lambda **kw: JEngine(jm, **kw), name)[:3]
            for name in SCENARIOS}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_expiry_equals_jax(models, jax_runs, name):
    _, tm = models
    outs, n_timeouts, info, eng = _script(
        lambda **kw: ContinuousBatchingEngine(tm, device="cpu", **kw), name)
    assert (outs, n_timeouts, info) == jax_runs[name]
    assert n_timeouts >= 1
    assert info["waiting"] == info["running"] == 0
    eng.check_invariants()
    while eng._evict_one():
        pass
    assert len(eng._free) == eng.num_pages - 1
    assert not eng._page_rc[1:].any()


def test_expiry_in_queue_and_mid_decode(models, jax_runs):
    outs = jax_runs["request_timeout"][0]
    assert outs[0][0] == RequestStatus.TIMEOUT and 0 < len(outs[0][1]) < 6
    assert outs[1] == (RequestStatus.TIMEOUT, [])
    assert outs[2] == (RequestStatus.TIMEOUT, [])
    outs = jax_runs["max_queue_time"][0]
    assert outs[0] == (RequestStatus.FINISHED, outs[0][1])
    assert len(outs[0][1]) == 6
    assert {outs[1][0], outs[2][0]} == {RequestStatus.TIMEOUT}


def test_timed_out_request_registers_its_prompt(models):
    _, tm = models
    eng = _script(lambda **kw: ContinuousBatchingEngine(tm, device="cpu",
                                                        **kw),
                  "with_prefix_cache")[3]
    assert eng.prefix_hits == 1
    assert eng.prefix_tokens_reused == 8         # 3 pages, cut to 2
    assert len(eng._prefix_nodes) == len(SHARED) // 4


def test_request_fields(models):
    _, tm = models
    clock = FakeClock()
    clock.advance(10.0)
    eng = ContinuousBatchingEngine(tm, device="cpu", max_seq_len=64,
                                   request_timeout=5.0, max_queue_time=2.0,
                                   clock=clock)
    eng.add_request([1, 2], 3)
    eng.add_request([1, 2], 3, deadline=1.5, max_queue_time=0.5)
    ra, rb = eng._queue
    assert (ra.deadline, ra.max_queue_time) == (15.0, 2.0)
    assert (rb.deadline, rb.max_queue_time) == (11.5, 0.5)
    assert eng.lifecycle_info() == {"waiting": 2, "running": 0,
                                    "timeouts": 0, "failures": 0,
                                    "preemptions": 0, "decode_retries": 0}
