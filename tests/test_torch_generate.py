"""The port's `LlamaForCausalLM.generate()` (`paddle_tpu_torch.models.
generation`, on the CPU) against the JAX package's `GenerationMixin.
generate`, on the same seeded weights carried with
`llama_state_from_numpy`, inputs made with numpy:

- greedy: ids equal and per-token log-probabilities within atol / rtol
  1e-4 (f32), with and without an EOS (past it the row emits EOS at
  log-probability 0), and with ``repetition_penalty``,
  ``min_new_tokens`` and ``no_repeat_ngram_size`` (tests/test_serving.py
  `TestLogitProcessors`, `TestNoRepeatNgram`);
- beam search at K = 2 and 4: ids equal, scores within 1e-4, EOS
  freezing finished beams (`TestBeamSearch`);
- the argument errors;
- sampling: the filter's kept set equal to the support of 4000 JAX draws
  (vmapped keys) on a V = 64 row with ties at the top-k and top-p cuts,
  the total-variation distance of 4000 port draws from JAX's frequencies
  below 0.05, each draw's log-probability equal to JAX's log-softmax
  there, ``top_k=1`` and a near-zero temperature equal to greedy
  (`test_sampling_near_zero_temperature_equals_greedy`), one generator
  seed giving one stream."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import generation as jg
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.models import generation as tg
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

TOL = dict(atol=1e-4, rtol=1e-4)
N_DRAWS = 4000
SMALL = dict(vocab_size=32, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=1, max_position_embeddings=32)


def _pair(seed, **cfg):
    paddle.seed(seed)
    jm = JLlama(JConfig(**cfg) if cfg else JConfig.tiny())
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig(**cfg) if cfg else LlamaConfig.tiny(),
                          device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm


@pytest.fixture(scope="module")
def tiny():
    return _pair(5)


@pytest.fixture(scope="module")
def small():
    """A 32-token vocabulary, where the processors bind."""
    return _pair(31, **SMALL)


def _both(pair, ids, **kw):
    jm, tm = pair
    a, sa = jm.generate(paddle.to_tensor(ids), **kw)
    b, sb = tm.generate(ids, **kw)
    return (np.asarray(a._value), np.asarray(sa._value)), \
        (b.numpy(), sb.numpy())


def _ids(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


@pytest.mark.parametrize("shape", [(1, 5), (3, 9)])
def test_greedy_equals_jax(tiny, shape):
    (ja, js), (ta, ts) = _both(tiny, _ids(1, shape, 512), max_new_tokens=7)
    assert ta.dtype == np.int32 and ta.shape == (shape[0], 7)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(ts, js, **TOL)


def test_greedy_with_eos_equals_jax(tiny):
    ids = _ids(2, (3, 6), 512)
    free, _ = tiny[1].generate(ids, max_new_tokens=8)
    eos = int(free[1, 2])                  # row 1 emits it third
    (ja, js), (ta, ts) = _both(tiny, ids, max_new_tokens=8,
                               eos_token_id=eos)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(ts, js, **TOL)
    assert (ta[1, 2:] == eos).all() and (ts[1, 3:] == 0).all()


def test_one_token_and_a_longer_cache(tiny):
    ids = _ids(3, (2, 4), 512)
    for kw in (dict(max_new_tokens=1), dict(max_new_tokens=5,
                                            max_cache_len=40)):
        (ja, js), (ta, ts) = _both(tiny, ids, **kw)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_allclose(ts, js, **TOL)


@pytest.mark.parametrize("kw", [
    dict(repetition_penalty=1.8),
    dict(repetition_penalty=0.7, no_repeat_ngram_size=3),
    dict(min_new_tokens=4),
    dict(no_repeat_ngram_size=2),
], ids=["repetition_penalty", "rp_below_1_and_ngram3", "min_new_tokens",
        "no_repeat_ngram"])
def test_processors_equal_jax(small, kw):
    ids = np.array([[3, 9, 3], [5, 6, 7]], np.int32)
    if "min_new_tokens" in kw:
        # eos = the unconstrained first greedy token of row 0
        first, _ = small[1].generate(ids, max_new_tokens=1)
        kw = dict(kw, eos_token_id=int(first[0, 0]))
    (ja, js), (ta, ts) = _both(small, ids, max_new_tokens=8, **kw)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(ts, js, **TOL)
    plain, _ = small[1].generate(ids, max_new_tokens=8)
    assert not np.array_equal(ta, plain.numpy())   # the processor binds
    if "min_new_tokens" in kw:
        assert (ta[0, :4] != kw["eos_token_id"]).all()


def test_no_repeat_ngram_matches_the_eager_rule(small):
    """≙ `test_no_repeat_ngram_matches_eager_rule`: no bigram repeats in
    prompt + output."""
    _, tm = small
    out, _ = tm.generate(np.array([[3, 9, 3]], np.int32), max_new_tokens=8,
                         no_repeat_ngram_size=2)
    cur = [3, 9, 3] + out[0].tolist()
    grams = list(zip(cur, cur[1:]))
    assert len(grams) == len(set(grams))


@pytest.mark.parametrize("beams", [2, 4])
@pytest.mark.parametrize("kw", [dict(), dict(length_penalty=0.6),
                                dict(repetition_penalty=1.5,
                                     min_new_tokens=2, eos_token_id=7),
                                dict(no_repeat_ngram_size=2)],
                         ids=["plain", "length_penalty", "processors",
                              "ngram"])
def test_beam_search_equals_jax(small, beams, kw):
    ids = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    (ja, js), (ta, ts) = _both(small, ids, max_new_tokens=6,
                               decode_strategy="beam_search",
                               num_beams=beams, **kw)
    assert ta.shape == (2, 6) and ts.shape == (2,)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(ts, js, **TOL)


@pytest.mark.parametrize("beams", [2, 4])
def test_beam_eos_freezes_beams(beams):
    """≙ `test_eos_freezes_beams`, on a 16-token vocabulary: past EOS a
    beam emits only EOS, and the port's search equals JAX's."""
    pair = _pair(23, **dict(SMALL, vocab_size=16))
    eos = 10                   # the best beam ends with it third
    ids = np.array([[2, 7, 9]], np.int32)
    (ja, js), (ta, ts) = _both(pair, ids, max_new_tokens=10,
                               decode_strategy="beam_search",
                               num_beams=beams, eos_token_id=eos,
                               length_penalty=0.6)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(ts, js, **TOL)
    seq = ta[0].tolist()
    assert seq.index(eos) == 2 and all(t == eos for t in seq[2:])
    assert np.isfinite(ts[0])


def test_beam_wider_than_the_vocabulary():
    """K > V: the dead beams start at -1e30, as in JAX."""
    pair = _pair(23, **dict(SMALL, vocab_size=8))
    (ja, js), (ta, ts) = _both(pair, np.array([[3, 1, 4]], np.int32),
                               max_new_tokens=3,
                               decode_strategy="beam_search", num_beams=12)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(ts, js, **TOL)


@pytest.mark.parametrize("kw,match", [
    (dict(decode_strategy="nucleus"), "decode_strategy"),
    (dict(decode_strategy="beam_search", num_beams=1), "num_beams"),
    (dict(repetition_penalty=0.0), "repetition_penalty"),
    (dict(no_repeat_ngram_size=-1), "no_repeat_ngram_size"),
    (dict(max_cache_len=10), "exceeds cache length"),
], ids=["strategy", "beams", "penalty", "ngram", "cache"])
def test_argument_errors(tiny, kw, match):
    jm, tm = tiny
    ids = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match=match):
        jm.generate(paddle.to_tensor(ids), max_new_tokens=4, **kw)
    with pytest.raises(ValueError, match=match):
        tm.generate(ids, max_new_tokens=4, **kw)


# a V = 64 row: 2 tokens at 3.0, 1 at 2.5, 3 tied at 2.0 (the top-4 cut
# falls inside that tie), 2 at 1.5, the rest below 0
ROW = np.concatenate([[3.0, 3.0, 2.5, 2.0, 2.0, 2.0, 1.5, 1.5],
                      np.random.default_rng(9).uniform(-4, -1, 56)])
ROW = np.random.default_rng(10).permutation(ROW).astype(np.float32)
FILTERS = {
    "top_k_tie": (1.0, 4, 1.0),          # keeps the 3 tied at the cut
    "top_p_tie": (1.0, 0, 0.62),         # cut inside the 2.0 tie
    "temperature_k_p": (0.7, 7, 0.9),
    "top_p_only": (1.3, 0, 0.8),
}


def _jax_draws(temp, k, p, n=N_DRAWS):
    row = jnp.asarray(ROW)[None]

    def one(key):
        return jg._sample_token(row, key, "sampling", temp, k, p)

    toks, lps = jax.jit(jax.vmap(one))(
        jax.random.split(jax.random.PRNGKey(7), n))
    return np.asarray(toks)[:, 0], np.asarray(lps)[:, 0]


@pytest.mark.parametrize("name", list(FILTERS))
def test_sampling_filter_kept_set_and_draws(name):
    temp, k, p = FILTERS[name]
    jtok, jlp = _jax_draws(temp, k, p)
    filtered = tg.filter_logits(torch.from_numpy(ROW)[None], temp, k, p)[0]
    kept = set(np.flatnonzero(filtered.numpy() > tg.NEG_INF / 2).tolist())
    assert kept == set(jtok.tolist())
    gen = torch.Generator().manual_seed(0)
    tok, lp = tg.choose_token(torch.from_numpy(ROW)[None].expand(N_DRAWS, -1),
                              "sampling", gen, temp, k, p)
    tok = tok.numpy()
    assert set(tok.tolist()) <= kept
    freq = np.bincount(tok, minlength=64) / N_DRAWS
    jfreq = np.bincount(jtok, minlength=64) / N_DRAWS
    assert 0.5 * np.abs(freq - jfreq).sum() < 0.05
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(ROW)))
    np.testing.assert_allclose(lp.numpy(), logp[tok], **TOL)
    np.testing.assert_allclose(jlp, logp[jtok], **TOL)


def test_sampling_top_k_1_and_cold_temperature_are_greedy(tiny):
    _, tm = tiny
    ids = _ids(4, (2, 6), 512)
    greedy, gs = tm.generate(ids, max_new_tokens=8)
    for kw in (dict(top_k=1), dict(temperature=1e-4)):
        got, s = tm.generate(ids, max_new_tokens=8,
                             decode_strategy="sampling",
                             generator=torch.Generator().manual_seed(3),
                             **kw)
        assert torch.equal(got, greedy)
        torch.testing.assert_close(s, gs, **TOL)


def test_sampling_seed_gives_one_stream(tiny):
    _, tm = tiny
    ids = _ids(5, (2, 6), 512)
    kw = dict(max_new_tokens=8, decode_strategy="sampling", top_p=0.9)
    a, sa = tm.generate(ids, generator=torch.Generator().manual_seed(11),
                        **kw)
    b, sb = tm.generate(ids, generator=torch.Generator().manual_seed(11),
                        **kw)
    c, _ = tm.generate(ids, generator=torch.Generator().manual_seed(12),
                       **kw)
    assert torch.equal(a, b) and torch.equal(sa, sb)
    assert not torch.equal(a, c)
    # without a generator: one seeded from torch's default generator
    torch.manual_seed(1)
    d, _ = tm.generate(ids, **kw)
    torch.manual_seed(1)
    e, _ = tm.generate(ids, **kw)
    assert torch.equal(d, e)


def test_sampling_scores_are_the_chosen_log_probs(tiny):
    """A sampled stream's scores are each chosen token's log-probability
    under the unfiltered log-softmax: the same stream forced through
    JAX's model gives them back."""
    jm, tm = tiny
    ids = _ids(6, (1, 5), 512)
    toks, scores = tm.generate(ids, max_new_tokens=5,
                               decode_strategy="sampling", top_k=20,
                               generator=torch.Generator().manual_seed(2))
    full = np.concatenate([ids, toks.numpy()], 1)
    with paddle.no_grad():
        logits = np.asarray(jm(paddle.to_tensor(full))._value)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits[0, 4:-1])))
    np.testing.assert_allclose(
        scores.numpy()[0], logp[np.arange(5), toks.numpy()[0]], **TOL)
