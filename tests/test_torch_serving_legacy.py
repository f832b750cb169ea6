"""The port's legacy paged path (``attention_impl="legacy"``) with its two
other admissions, against the JAX engine's, on the same seeded
`LlamaConfig.tiny()` weights (crossing as numpy), ``device="cpu"``:

- the prefix cache (≙ `_admit_shared`): a hit attaches the cached pages
  and prefills only its suffix over them; greedy streams,
  ``prefix_hits``, ``prefix_tokens_reused`` and the trie's size equal
  JAX's (a hit, a shorter hit cut to a power-of-two page count, a miss,
  a whole prompt cached, eviction under pool pressure), and equal the
  uncached engine's streams; the suffix programs' ``(shared_len,
  bucket)`` keys in LRU order equal JAX's `_suffix_jits` at
  ``max_prefill_programs=1`` (a cap of 2), through an eviction and a hit
  moving its key to the back;
- ``prefill_chunk`` (≙ `_admit_chunked`): prompts below, at and past
  the chunk, the last one crossing several chunks, through preemption;
  streams equal JAX's and the unchunked engine's, one chunk program;
- every page back after each run (`check_invariants`)."""
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
RNG = np.random.default_rng(18)
BASE = [int(t) for t in RNG.integers(1, VOCAB, 32)]       # 4 pages of 8


def _toks(n):
    return [int(t) for t in RNG.integers(1, VOCAB, n)]


HIT = [BASE + [7, 8, 9],                 # registers 4 pages
       BASE[:24] + [100, 101],           # a 3-page match: 2 attach
       BASE[:16] + _toks(4),             # a 2-page hit
       _toks(10)]                        # a miss
WHOLE = [list(range(1, 17))] * 2         # exactly 2 pages of 8
PRESSURE = [_toks(16) for _ in range(4)]
# (shared_len, bucket) keys: (8, 8), (16, 8), (8, 8) again, (32, 16)
LRU = [BASE + [1], BASE[:8] + _toks(5), BASE[:16] + _toks(3),
       BASE[:8] + _toks(6), BASE + _toks(10)]

# name: (prompts, new tokens each, engine options); batch 1 admits one
# request at a time, so earlier requests register before later ones
PREFIX_CASES = {
    "hits": (HIT, [6, 6, 5, 4], {}),
    "whole_prompt": (WHOLE, [5, 5], {}),
    "pool_pressure": (PRESSURE, [6] * 4, dict(num_pages=8)),
    "lru": (LRU, [4] * 5, dict(max_prefill_programs=1)),
    "two_slots": (HIT + [BASE + [5]], [5] * 5, dict(max_batch_size=2)),
}


@pytest.fixture(scope="module")
def models():
    paddle.seed(8)
    jm = JLlama(JConfig.tiny())
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm


def _opts(kw):
    return dict(dict(max_batch_size=1, max_seq_len=96, page_size=8,
                     prompt_pad=8, attention_impl="legacy"), **kw)


def _run(eng, prompts, news):
    rids = [eng.add_request(p, n) for p, n in zip(prompts, news)]
    res = eng.run()
    eng.check_invariants()
    return [res[r] for r in rids]


def _port(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", **_opts(kw))


def _trie(eng):
    info = eng.cache_memory_info()
    return {k: info[k] for k in ("prefix_entries", "prefix_pages",
                                 "prefix_hits", "prefix_tokens_reused")}


@pytest.fixture(scope="module")
def jax_prefix(models):
    jm, _ = models
    out = {}
    for name, (prompts, news, kw) in PREFIX_CASES.items():
        eng = JEngine(jm, enable_prefix_caching=True, **_opts(kw))
        out[name] = (_run(eng, prompts, news), _trie(eng),
                     list(eng._suffix_jits))
    return out


@pytest.mark.parametrize("name", list(PREFIX_CASES))
def test_prefix_streams_and_hits_equal_jax(models, jax_prefix, name):
    _, tm = models
    prompts, news, kw = PREFIX_CASES[name]
    eng = _port(tm, enable_prefix_caching=True, **kw)
    got = _run(eng, prompts, news)
    want, trie, keys = jax_prefix[name]
    assert got == want
    assert _trie(eng) == trie
    assert list(eng._suffix_programs) == keys
    # the cache changes which rows are prefilled, never the streams
    assert got == _run(_port(tm, **kw), prompts, news)
    # every page comes back once the trie is drained
    while eng._evict_one():
        pass
    assert not eng._page_rc[1:].any()
    assert sorted(eng._free) == list(range(1, eng.num_pages))
    eng.check_invariants()


def test_prefix_hits_are_counted(jax_prefix):
    """The cases hit as designed: the 3-page match attaches 2 pages, the
    2-page match both; the whole cached prompt one page less."""
    assert jax_prefix["hits"][1]["prefix_hits"] == 2
    assert jax_prefix["hits"][1]["prefix_tokens_reused"] == 16 + 16
    assert jax_prefix["whole_prompt"][1]["prefix_tokens_reused"] == 8


def test_suffix_program_lru_at_cap_2(models, jax_prefix):
    """`max_prefill_programs=1`: the suffix family holds 2 programs. The
    keys arrive (8, 8), (16, 8), (8, 8) (a hit: to the back), (32, 16)
    (evicts (16, 8)), as JAX's `_suffix_jits` orders them."""
    assert jax_prefix["lru"][2] == [(8, 8), (32, 16)]
    _, tm = models
    eng = _port(tm, enable_prefix_caching=True, max_prefill_programs=1)
    seen = []
    build = eng._build_suffix_prefill

    def counted(shared_len, bucket):
        seen.append((shared_len, bucket))
        return build(shared_len, bucket)
    eng._build_suffix_prefill = counted
    _run(eng, LRU, [4] * 5)
    # built once each, the hit reusing its program
    assert seen == [(8, 8), (16, 8), (32, 16)]
    assert list(eng._suffix_programs) == [(8, 8), (32, 16)]
    assert eng.prefix_hits == 4


def test_admission_tokens_drop_by_the_reused_tokens(models):
    _, tm = models
    cached = _port(tm, enable_prefix_caching=True)
    plain = _port(tm)
    _run(cached, HIT, [6, 6, 5, 4])
    _run(plain, HIT, [6, 6, 5, 4])
    assert plain.admission_tokens - cached.admission_tokens \
        == cached.prefix_tokens_reused == 32


# below, at and past the 16-token chunk; 70 tokens cross five chunks
CHUNK_LENS = (5, 16, 17, 40, 70, 12)
CHUNK_NEW = (6, 7, 5, 8, 9, 6)


@pytest.fixture(scope="module")
def chunk_prompts():
    rng = np.random.default_rng(6)
    return [rng.integers(0, VOCAB, n) for n in CHUNK_LENS]


@pytest.mark.parametrize("batch", [1, 2])
def test_chunked_streams_equal_jax(models, chunk_prompts, batch):
    jm, tm = models
    kw = dict(max_batch_size=batch, prefill_chunk=16, max_seq_len=96)
    want = _run(JEngine(jm, **_opts(kw)), chunk_prompts, CHUNK_NEW)
    eng = _port(tm, **kw)
    got = _run(eng, chunk_prompts, CHUNK_NEW)
    assert got == want
    assert got == _run(_port(tm, max_batch_size=batch, max_seq_len=96),
                       chunk_prompts, CHUNK_NEW)
    # one chunk program; a chunk is a dispatch
    assert eng._chunk_program is not None
    chunks = sum(-(-n // 16) for n in CHUNK_LENS if n >= 16)
    assert eng._chunk_program.runs == chunks
    assert eng.admission_tokens == sum(CHUNK_LENS)
    assert len(eng._free) == eng.num_pages - 1


def test_chunked_program_equals_eager(models, chunk_prompts):
    _, tm = models
    kw = dict(prefill_chunk=16, max_seq_len=96)
    assert _run(_port(tm, **kw), chunk_prompts, CHUNK_NEW) == \
        _run(_port(tm, _graphs=False, **kw), chunk_prompts, CHUNK_NEW)


def test_chunked_preemption_keeps_streams(models, chunk_prompts,
                                          monkeypatch):
    """With reservation bypassed on a tight pool, lazy page growth runs
    dry and preempts the youngest slot, which re-prefills its prompt and
    its tokens (chunked when that is long enough) and continues the
    same greedy stream, as JAX's engine does."""
    jm, tm = models
    # 40 and 70 tokens grow to 7 and 11 pages of 8: 18 > 16 usable
    prompts, news = chunk_prompts[3:5], [12, 12]
    kw = _opts(dict(max_batch_size=2, prefill_chunk=16, max_seq_len=96,
                    num_pages=17))
    want = _run(JEngine(jm, **kw), prompts, news)
    jeng = JEngine(jm, **kw)
    monkeypatch.setattr(jeng, "_reserve_ok", lambda req, n=0: True)
    assert _run(jeng, prompts, news) == want
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    monkeypatch.setattr(eng, "_reserve_ok", lambda req, n=0: True)
    got = _run(eng, prompts, news)
    assert eng.num_preemptions > 0
    assert got == want
    assert len(eng._free) == eng.num_pages - 1


def test_chunk_must_be_a_page_multiple(models):
    jm, tm = models
    with pytest.raises(ValueError, match="multiple of page_size"):
        JEngine(jm, **_opts(dict(prefill_chunk=12)))
    with pytest.raises(ValueError, match="multiple of page_size"):
        _port(tm, prefill_chunk=12)


def test_chunked_prefix_hit_takes_the_suffix_path(models):
    """A prefix hit admits through the suffix prefill even when its
    prompt is past the chunk (JAX's branch order: shared first)."""
    jm, tm = models
    prompts, news = [BASE + [3], BASE + _toks(20)], [4, 4]
    kw = dict(prefill_chunk=16, enable_prefix_caching=True)
    jeng = JEngine(jm, **_opts(kw))
    want = _run(jeng, prompts, news)
    eng = _port(tm, **kw)
    assert _run(eng, prompts, news) == want
    assert eng.prefix_hits == jeng.prefix_hits == 1
    assert eng._chunk_program.runs == 3            # the first prompt only


def test_programs_dropped_on_weight_change(models, chunk_prompts):
    """The chunk program and the suffix programs bind the weights when
    they are built: `install_weights` drops the chunk program and
    `reset_weights` (which a cached engine allows) the suffix programs,
    and the next run rebuilds them."""
    _, tm = models
    eng = _port(tm, prefill_chunk=16)
    want = _run(eng, chunk_prompts, CHUNK_NEW)
    assert eng._chunk_program is not None
    eng.install_weights({n: p.detach() for n, p in tm.named_parameters()},
                        "same")
    assert eng._chunk_program is None
    assert _run(eng, chunk_prompts, CHUNK_NEW) == want
    assert eng._chunk_program is not None
    eng = _port(tm, enable_prefix_caching=True)
    want = _run(eng, HIT, [6, 6, 5, 4])
    assert eng._suffix_programs
    eng.reset_weights()
    assert not eng._suffix_programs and eng._decode_program is None
