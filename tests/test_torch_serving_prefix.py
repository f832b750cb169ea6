"""The port's prefix cache (`ContinuousBatchingEngine(
enable_prefix_caching=True)`, ``device="cpu"``) against the JAX engine's,
on the same seeded `LlamaConfig.tiny()` weights (crossing as numpy):

- equal greedy streams with the cache on, equal ``prefix_hits``,
  ``prefix_tokens_reused`` and trie size, and streams equal to an
  uncached engine's (tests/test_serving.py `TestPrefixCaching`): a hit,
  a shorter-prefix hit cut to a power-of-two page count, a miss, a whole
  prompt cached (the match stops a page short), chunked admission of a
  hit's suffix, and eviction under pool pressure with the matched pages
  pinned across the reservation;
- page accounting: every page comes back once the trie is drained
  (`TestPageAccounting`), and a reservation that raises unpins the
  matched prefix (`TestPinSafety`);
- the JAX engine's refusals: a sliding-window model warns and disables
  the cache, `install_adapter` and `install_weights` refuse (the legacy
  path's suffix prefill: tests/test_torch_serving_legacy.py)."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.serving import ContinuousBatchingEngine

VOCAB = 512
RNG = np.random.default_rng(5)
BASE = [int(t) for t in RNG.integers(1, VOCAB, 24)]       # 3 pages of 8
HIT = [BASE + [7, 8, 9],                 # registers the prefix
       BASE + [100, 101],                # hits it: 3 pages, 2 attach
       BASE[:16] + [55, 56, 57, 58],     # a 2-page hit
       [int(t) for t in RNG.integers(1, VOCAB, 10)]]       # a miss
WHOLE = [list(range(1, 17))] * 2         # exactly 2 pages of 8
PRESSURE = [[int(t) for t in RNG.integers(1, VOCAB, 16)] for _ in range(4)]
PIN_BASE = [int(t) for t in RNG.integers(1, VOCAB, 16)]
PIN_OTHERS = [[int(t) for t in RNG.integers(1, VOCAB, 16)]
              for _ in range(3)]
PINNED = [PIN_BASE, PIN_OTHERS[0], PIN_BASE + [3], PIN_OTHERS[1],
          PIN_BASE + [4], PIN_OTHERS[2], PIN_BASE + [5]]
LONG = [BASE + BASE[:12] + [3, 4], BASE + BASE[:12] + [5, 6, 7]]

# name: (prompts, new tokens each, engine options); batch 1 admits one
# request at a time, so earlier requests register before later ones
CASES = {
    "hits": (HIT, [6, 6, 5, 4], {}),
    "whole_prompt": (WHOLE, [5, 5], {}),
    "chunked": (LONG, [5, 5], dict(prefill_chunk=16)),
    "pool_pressure": (PRESSURE, [6] * 4, dict(num_pages=8)),
    "pinned_under_pressure": (PINNED, [6] * 7, dict(num_pages=10)),
}


@pytest.fixture(scope="module")
def models():
    paddle.seed(5)
    jm = JLlama(JConfig.tiny())
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm


def _opts(kw):
    return dict(dict(max_batch_size=1, max_seq_len=96, page_size=8,
                     prompt_pad=8), **kw)


def _run(eng, prompts, news):
    rids = [eng.add_request(p, n) for p, n in zip(prompts, news)]
    res = eng.run()
    return [res[r] for r in rids]


def _port(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", **_opts(kw))


def _trie(eng):
    info = eng.cache_memory_info()
    return {k: info[k] for k in ("prefix_entries", "prefix_pages",
                                 "prefix_hits", "prefix_tokens_reused")}


@pytest.fixture(scope="module")
def jax_runs(models):
    jm, _ = models
    out = {}
    for name, (prompts, news, kw) in CASES.items():
        eng = JEngine(jm, enable_prefix_caching=True, **_opts(kw))
        out[name] = (_run(eng, prompts, news), _trie(eng))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_streams_and_hits_equal_jax(models, jax_runs, name):
    _, tm = models
    prompts, news, kw = CASES[name]
    eng = _port(tm, enable_prefix_caching=True, **kw)
    got = _run(eng, prompts, news)
    want, trie = jax_runs[name]
    assert got == want
    assert _trie(eng) == trie
    eng.check_invariants()
    # the cache changes which rows are prefilled, never the streams
    assert got == _run(_port(tm, **kw), prompts, news)
    # pages are free, cached, or attached to nobody: no double free
    cached = {n["page"] for n in eng._prefix_nodes.values()}
    assert set(eng._free).isdisjoint(cached)
    assert len(set(eng._free)) == len(eng._free)
    assert all(eng._page_rc[p] >= 1 for p in cached)
    assert all(eng._page_rc[p] == 0 for p in eng._free)


def test_match_is_cut_to_a_power_of_two(models, jax_runs):
    """The 3-page match attaches 2 pages, the 2-page match both; the
    whole cached prompt attaches one page less than it has."""
    assert jax_runs["hits"][1]["prefix_tokens_reused"] == 16 + 16
    assert jax_runs["whole_prompt"][1]["prefix_hits"] == 1
    assert jax_runs["whole_prompt"][1]["prefix_tokens_reused"] == 8
    _, tm = models
    eng = _port(tm, enable_prefix_caching=True)
    _run(eng, HIT[:1], [6])
    assert eng._match_prefix(HIT[1]) == eng._match_prefix(BASE + [1])
    assert len(eng._match_prefix(HIT[1])) == 2
    assert eng._match_prefix(HIT[3]) is None


def test_admission_tokens_drop_by_the_reused_tokens(models):
    _, tm = models
    cached = _port(tm, enable_prefix_caching=True)
    plain = _port(tm)
    _run(cached, HIT, [6, 6, 5, 4])
    _run(plain, HIT, [6, 6, 5, 4])
    assert plain.admission_tokens - cached.admission_tokens \
        == cached.prefix_tokens_reused == 32


def test_prefix_run_returns_every_page(models):
    """tests/test_serving.py `TestPageAccounting`: cached pages stay by
    design; once the trie is drained every refcount is zero and the free
    list is every usable page, as on a fresh engine."""
    jm, tm = models
    base = list(range(1, 13))
    prompts, news = [base + [t] for t in (20, 21, 22)], [5] * 3
    kw = dict(max_batch_size=2, max_seq_len=64, page_size=4,
              enable_prefix_caching=True)
    jeng = JEngine(jm, **kw)
    want = _run(jeng, prompts, news)
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    assert _run(eng, prompts, news) == want
    assert eng.prefix_hits == jeng.prefix_hits >= 1
    assert eng.prefix_tokens_reused == jeng.prefix_tokens_reused
    while eng._evict_one():
        pass
    assert not eng._prefix_nodes
    assert not eng._page_rc[1:].any()
    assert sorted(eng._free) == list(range(1, eng.num_pages))
    eng.check_invariants()


def test_entry_budget_caps_the_trie(models):
    _, tm = models
    eng = _port(tm, enable_prefix_caching=True, max_prefix_entries=2)
    _run(eng, HIT[:2], [3, 3])
    assert len(eng._prefix_nodes) == 2
    eng.check_invariants()


def test_reservation_error_unpins(models):
    """tests/test_serving.py `TestPinSafety`: the matched prefix is
    pinned across the reservation, so a reservation that raises must
    unpin it."""
    _, tm = models
    eng = ContinuousBatchingEngine(tm, device="cpu", max_batch_size=1,
                                   max_seq_len=64, page_size=4,
                                   enable_prefix_caching=True)
    base = list(range(1, 13))
    rid0 = eng.add_request(base, 4)
    assert len(eng.run()[rid0]) == 4          # the chain is registered
    rc_before = eng._page_rc.copy()

    def boom(req, shared_pages=0):
        raise RuntimeError("reservation accounting exploded")
    eng._reserve_ok = boom
    eng.add_request(base + [40, 41], 4)       # the match pins
    with pytest.raises(RuntimeError, match="accounting"):
        eng.step()
    del eng._reserve_ok
    assert (eng._page_rc == rc_before).all()
    eng.check_invariants()
    assert len(eng.run()[rid0 + 1]) == 4      # and the engine still serves
    assert eng.prefix_hits == 1


def test_sliding_window_model_warns_and_disables(models):
    _, tm = models
    cfg = LlamaConfig.tiny()
    cfg.sliding_window = 8
    wm = LlamaForCausalLM(cfg, device="cpu", seed=3)
    with pytest.warns(UserWarning, match="prefix caching is DISABLED"):
        eng = ContinuousBatchingEngine(wm, device="cpu", max_batch_size=1,
                                       max_seq_len=64, page_size=4,
                                       enable_prefix_caching=True)
    base = list(range(1, 13))
    out = _run(eng, [base + [3], base + [4]], [4, 4])
    assert eng.prefix_hits == 0 and not eng._prefix_nodes
    assert "prefix_hits" not in eng.cache_memory_info()
    plain = ContinuousBatchingEngine(wm, device="cpu", max_batch_size=1,
                                     max_seq_len=64, page_size=4)
    assert out == _run(plain, [base + [3], base + [4]], [4, 4])


@pytest.mark.parametrize("call", ["install_adapter", "install_weights"])
def test_weight_changes_refuse_with_prefix_caching(models, call):
    """Cached pages are a function of the weights, so, as in JAX, a
    cached engine takes neither adapters nor another checkpoint."""
    _, tm = models
    eng = _port(tm, enable_prefix_caching=True)
    nm = "model.layers.0.self_attn.q_proj.weight"
    k = tm.config.hidden_size
    with pytest.raises(ValueError, match="prefix caching"):
        if call == "install_adapter":
            eng.install_adapter("a1", {nm: (np.zeros((k, 2), np.float32),
                                            np.zeros((2, k), np.float32))})
        else:
            eng.install_weights({n: p.detach() for n, p in
                                 tm.named_parameters()}, "other")
    assert eng.lora_adapters_resident == 0 and eng.model_tag is None
