"""The port's speculative engine (`ContinuousBatchingEngine(spec_decode=
SpecConfig(draft, k))`, ``device="cpu"``) against the JAX engine, on the
models of tests/test_spec_decode.py (target: vocab 64, hidden 32, 2
layers; draft: hidden 16, 1 layer), weights carried with
`llama_state_from_numpy`:

- validation, as that file's `TestSpecConfigValidation`: paged ragged
  only, greedy only, vocabulary and rope coverage, ``k >= 1``, the
  tiny() / tiny_draft() pair, sliding windows refused; and the
  refusals of ``harvest_every > 1`` and `install_adapter`;
- losslessness, as its `TestSpecEngineLossless`: streams equal to the
  JAX spec engine's and to a plain engine's (JAX's on the clean run, the
  port's elsewhere, which the other port tests hold to JAX's), and
  `spec_info()` equal to the JAX spec engine's, at k = 2 and 4, with
  the target as its own draft (every proposal accepted), through an
  EOS, at budgets below k,
  through a forced preemption (the JAX run's ``serving.alloc_page``
  fault, the port's `_alloc_page` raising at the same visit), with an
  undersized draft pool, with prefix caching and under int8 weights and
  KV (int8 draft pools);
- the program keys: verify programs and draft prefills in LRU order
  equal to the JAX engine's `_verify_jits` / `_d_prefill_jits`, at the
  default cap and, over longer streams, at ``max_prefill_programs=2``;
- the eager engine (``_graphs=False``) equal to the programmed one, and
  the page accounting (draft pools included) checked after every step
  under ``PDT_CHECK_INVARIANTS=1``, every draft page back after the
  run."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models.serving import PoolExhausted as JPoolExhausted
from paddle_tpu.models.serving import QuantServingConfig as JQuant
from paddle_tpu.models.serving import SpecConfig as JSpec
from paddle_tpu.utils.faults import FaultInjector
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                             PoolExhausted,
                                             QuantServingConfig,
                                             RequestStatus, SpecConfig)

TARGET = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=1, max_position_embeddings=64)
DRAFT = dict(TARGET, hidden_size=16, intermediate_size=32,
             num_hidden_layers=1)
JOBS = [([5, 4, 3, 2, 6, 7], 8), ([9, 1, 2], 6), ([7, 7, 1, 2], 5)]
SHARED = [3, 1, 4, 1, 5, 9, 2, 6]                     # 2 pages of 4
PREFIX_JOBS = [(SHARED + [7, 7], 6), (SHARED + [2, 8, 1], 5),
               (SHARED[:4] + [1, 1], 4), ([8, 8, 8], 4)]


def _pair(seed, cfg):
    paddle.seed(seed)
    jm = JLlama(JConfig(**cfg))
    jm.eval()
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(7, TARGET), _pair(8, DRAFT)


@pytest.fixture(autouse=True)
def _invariants(monkeypatch):
    monkeypatch.setenv("PDT_CHECK_INVARIANTS", "1")


def _opts(kw):
    return dict(dict(max_batch_size=2, max_seq_len=64, page_size=4), **kw)


def _port(tm, draft=None, k=4, num_pages=None, **kw):
    if draft is not None:
        kw["spec_decode"] = SpecConfig(draft, k=k, num_pages=num_pages)
    return ContinuousBatchingEngine(tm, device="cpu", **_opts(kw))


def _jax(jm, draft=None, k=4, num_pages=None, **kw):
    if draft is not None:
        kw["spec_decode"] = JSpec(draft, k=k, num_pages=num_pages)
    return JEngine(jm, **_opts(kw))


def _serve(eng, jobs=JOBS):
    rids = [eng.add_request(p, n) for p, n in jobs]
    done = {}
    while eng._queue or any(r is not None for r in eng._slot_req):
        for r in eng.step():
            done[r.rid] = r
    eng.check_invariants()
    if getattr(eng, "_spec", None) is not None:
        assert len(eng._d_free) == eng._d_num_pages - 1
        assert not eng._d_valid.any()
    return [done[r].output for r in rids], [done[r].status for r in rids]


@pytest.fixture(scope="module")
def plain(models):
    """The JAX plain engine's streams of JOBS: every lossless check
    compares to them."""
    (jt, _), _ = models
    outs, statuses = _serve(_jax(jt))
    assert all(s == RequestStatus.FINISHED for s in statuses)
    return outs


# -- validation -----------------------------------------------------------
def test_requires_paged_ragged(models):
    (_, tt), (_, td) = models
    for kw in (dict(kv_layout="dense"), dict(attention_impl="legacy")):
        with pytest.raises(ValueError, match="ragged"):
            _port(tt, td, **kw)


def test_greedy_only(models):
    (_, tt), (_, td) = models
    with pytest.raises(ValueError, match="greedy"):
        _port(tt, td, do_sample=True, temperature=0.8)


def test_vocab_and_rope_coverage(models):
    (_, tt), _ = models
    bad = LlamaForCausalLM(LlamaConfig(**dict(DRAFT, vocab_size=32)),
                           device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        _port(tt, bad)
    short = LlamaForCausalLM(LlamaConfig(
        **dict(DRAFT, max_position_embeddings=16)), device="cpu")
    with pytest.raises(ValueError, match="rope"):
        _port(tt, short)


def test_k_validation(models):
    (_, tt), (_, td) = models
    with pytest.raises(ValueError, match="k must be"):
        _port(tt, td, k=0)


def test_tiny_draft_pairs_with_tiny():
    t_cfg, d_cfg = LlamaConfig.tiny(), LlamaConfig.tiny_draft()
    assert d_cfg.vocab_size == t_cfg.vocab_size
    assert d_cfg.max_position_embeddings == t_cfg.max_position_embeddings
    eng = ContinuousBatchingEngine(
        LlamaForCausalLM(t_cfg, device="cpu"), max_batch_size=1,
        max_seq_len=64, device="cpu", spec_decode=SpecConfig(
            LlamaForCausalLM(d_cfg, device="cpu"), k=4))
    assert eng.spec_enabled
    assert eng.spec_info() == {"rounds": 0, "proposed": 0, "accepted": 0,
                               "degraded": 0, "acceptance_rate": 0.0}


def test_sliding_window_rejected(models):
    _, (_, td) = models
    win = LlamaForCausalLM(LlamaConfig(**dict(TARGET, num_hidden_layers=1,
                                              sliding_window=8)),
                           device="cpu")
    with pytest.raises(ValueError, match="sliding_window"):
        _port(win, td)


def test_harvest_every_and_adapters_refused(models):
    (_, tt), (_, td) = models
    with pytest.raises(ValueError, match="spec_decode"):
        _port(tt, td, harvest_every=4)
    eng = _port(tt, td)
    name = "model.layers.0.self_attn.q_proj.weight"
    with pytest.raises(ValueError, match="spec_decode"):
        eng.install_adapter("a", {name: (np.zeros((32, 2), np.float32),
                                         np.zeros((2, 32), np.float32))})
    assert not eng._adapter_rows and not eng.spec_info()["rounds"]


# -- losslessness ------------------------------------------------------------
def _both(models, jobs=JOBS, self_draft=False, **kw):
    (jt, tt), (jd, td) = models
    if self_draft:
        jd, td = jt, tt
    jeng, eng = _jax(jt, jd, **kw), _port(tt, td, **kw)
    want, w_st = _serve(jeng, jobs)
    got, g_st = _serve(eng, jobs)
    assert got == want and g_st == w_st
    assert eng.spec_info() == jeng.spec_info()
    assert list(eng._verify_programs) == list(jeng._verify_jits)
    assert list(eng._d_prefill_programs) == list(jeng._d_prefill_jits)
    return eng, got


@pytest.mark.parametrize("k", [2, 4])
def test_streams_and_counters_equal_jax(models, plain, k):
    eng, got = _both(models, k=k)
    assert got == plain
    assert eng.num_spec_rounds > 0 and eng.num_draft_scans > 0
    assert eng.num_draft_prefills > 0
    # the eager engine: the same streams and counters
    (_, tt), (_, td) = models
    eager = _port(tt, td, k=k, _graphs=False)
    assert _serve(eager)[0] == plain
    assert eager.spec_info() == eng.spec_info()


def test_self_draft_accepts_everything(models, plain):
    eng, got = _both(models, self_draft=True)
    assert got == plain
    info = eng.spec_info()
    assert info["proposed"] > 0 and info["accepted"] == info["proposed"]
    assert info["acceptance_rate"] == 1.0


def test_eos_stops_identically(models, plain):
    eos = plain[0][3]
    (_, tt), _ = models
    want, _ = _serve(_port(tt, eos_token_id=eos))
    _, got = _both(models, eos_token_id=eos)
    assert got == want
    assert got[0][-1] == eos and len(got[0]) == 4


def test_tiny_budgets_never_overshoot(models):
    jobs = [([5, 4, 3], 1), ([9, 1, 2], 2), ([8, 8], 3)]
    (_, tt), _ = models
    want, _ = _serve(_port(tt), jobs)
    _, got = _both(models, jobs, k=8)
    assert got == want and [len(o) for o in got] == [1, 2, 3]


def test_streams_equal_through_preemption(models, plain):
    """A PoolExhausted at the 4th page allocation (the JAX run's armed
    ``serving.alloc_page`` site; the port's `_alloc_page` raising at the
    same visit) preempts a slot: its draft cache is dropped with it, the
    request re-prefills its folded stream, the next round backfills the
    draft, and the streams, the preemption count and the counters equal
    JAX's."""
    (jt, tt), (jd, td) = models
    jeng = _jax(jt, jd)
    with FaultInjector() as fi:
        fi.arm("serving.alloc_page", nth=4, exc=JPoolExhausted)
        want, _ = _serve(jeng, JOBS[:2])
    eng = _port(tt, td)
    alloc, visits = eng._alloc_page, [0]

    def faulty(slot):
        visits[0] += 1
        if visits[0] == 4:
            raise PoolExhausted("forced")
        return alloc(slot)
    eng._alloc_page = faulty
    got, statuses = _serve(eng, JOBS[:2])
    assert got == want == plain[:2]
    assert eng.num_preemptions == jeng.num_preemptions >= 1
    assert eng.spec_info() == jeng.spec_info()
    assert all(s == RequestStatus.FINISHED for s in statuses)


def test_draft_pool_exhaustion_rides_plain_rows(models, plain):
    eng, got = _both(models, num_pages=3)
    assert got == plain
    assert eng.spec_info()["proposed"] < 4 * eng.spec_info()["rounds"] * 2


def test_prefix_caching(models):
    (_, tt), _ = models
    want, _ = _serve(_port(tt, enable_prefix_caching=True,
                           max_batch_size=1), PREFIX_JOBS)
    eng, got = _both(models, PREFIX_JOBS, enable_prefix_caching=True,
                     max_batch_size=1)
    assert got == want and eng.prefix_hits > 0


def test_int8_weights_and_kv(models):
    (_, tt), _ = models
    want, _ = _serve(_port(tt, quant=QuantServingConfig("int8", "int8")))
    (jt, tt), (jd, td) = models
    jeng = _jax(jt, jd, quant=JQuant("int8", "int8"))
    eng = _port(tt, td, quant=QuantServingConfig("int8", "int8"))
    assert _serve(jeng)[0] == want
    got, _ = _serve(eng)
    assert eng.spec_info() == jeng.spec_info()
    assert got == want
    k_pool = eng._d_kv[0]
    assert len(k_pool) == 4 and k_pool[0].dtype.itemsize == 1


# -- program keys ----------------------------------------------------------
def test_program_keys_follow_jax_lru(models):
    """Longer prompts and budgets at a cap of 2: verify dispatches of
    several padded sizes and pages bounds evicting each other, and draft
    backfills of fresh admissions (every `_both` run holds the keys at
    the default cap)."""
    (jt, tt), (jd, td) = models
    jobs = [(list(range(1, n + 1)), new)
            for n, new in ((3, 9), (21, 12), (40, 7), (9, 14))]
    cap = 2
    kw = dict(max_prefill_programs=cap)
    jeng, eng = _jax(jt, jd, **kw), _port(tt, td, **kw)
    assert _serve(eng, jobs)[0] == _serve(jeng, jobs)[0]
    assert list(eng._verify_programs) == list(jeng._verify_jits)
    assert list(eng._d_prefill_programs) == list(jeng._d_prefill_jits)
    assert list(eng._ragged_programs) == list(jeng._ragged_jits)
    assert len(eng._verify_programs) <= cap
    assert eng._draft_scan_program is not None
    eng._drop_programs()
    assert not eng._programs()


def test_checks_catch_planted_faults(models, plain, monkeypatch):
    """The checks above catch their planted faults: a draft scan without
    its catch-up step keeps the streams (the target decides every token)
    but breaks self-draft acceptance 1.0; one more proposal accepted than
    matched breaks the streams' equality with the plain engine's."""
    from paddle_tpu_torch.models import serving
    (_, tt), (_, td) = models
    # long streams: holes in the draft cache to attend
    jobs = [(p, 25) for p, _ in JOBS] + [([2, 7, 1, 8], 28)]
    want = _serve(_port(tt), jobs)[0]
    own = _port(tt, tt)
    assert _serve(own, jobs)[0] == want
    assert own.spec_info()["acceptance_rate"] == 1.0
    own = _port(tt, tt)
    own._build_draft_scan = lambda: type(own)._build_draft_scan(
        own, catch_up=False)
    assert _serve(own, jobs)[0] == want
    assert 0 < own.spec_info()["acceptance_rate"] < 1.0
    right = serving.spec_accept_greedy

    def wrong(greedy, props):
        j, bonus = right(greedy, props)
        return np.minimum(j + 1, (props >= 0).sum(1)).astype(np.int32), bonus
    monkeypatch.setattr(serving, "spec_accept_greedy", wrong)
    assert _serve(_port(tt, td))[0] != plain
