"""The port engine's sampling (`ContinuousBatchingEngine(do_sample=True,
temperature=, top_k=, top_p=, seed=)`, ``device="cpu"``) against the
JAX engine's `_sample_token`, on a seeded small Llama (vocab 64, hidden
32, 2 layers) carried with `llama_state_from_numpy`. The port draws its
uniforms from a hash of (seed, dispatch counter) (`generation.
counter_uniform`), JAX from `jax.random`: the bits differ, so the tests
hold the filter and the distribution.

- ``top_k=1`` keeps only the largest logit, so its streams equal the JAX
  greedy engine's on every layout: ragged (with chunk continuations),
  legacy, dense, the legacy prefix cache and legacy chunked prefill;
- one dispatch's selection (the engine's `_picker` on a key from
  `_next_key`) on a V = 64 row with ties at the top-k and top-p cuts: its
  kept set equals the support of 4000 JAX `_sample_token` draws, and the
  total-variation distance of 20000 draws from JAX's filtered softmax
  (softmax of the row under the temperature over that support) is below
  0.05; successive dispatch keys give fresh draws of the same
  distribution;
- a seed gives one stream, eager (``_graphs=False``) and through the
  programs, and another seed another; the counter advances once a
  sampling dispatch;
- the refusals: ``harvest_every > 1`` and ``spec_decode`` are greedy
  only, as in JAX."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import generation as jg
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu_torch.models import generation as tg
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                             SpecConfig)

CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
           num_hidden_layers=2, num_attention_heads=2,
           num_key_value_heads=1, max_position_embeddings=64)
JOBS = [([1, 2, 3], 9), ([4, 5, 6, 7, 8, 9, 1, 2, 3, 4, 5, 6, 7, 8, 9, 1,
                          2, 3, 4], 7), ([6, 7, 8, 9], 5), ([2, 2], 12),
        ([9, 1], 3)]
SHARED = [3, 1, 4, 1, 5, 9, 2, 6]                     # 2 pages of 4
PREFIX_JOBS = [(SHARED + [7, 7], 6), (SHARED + [2, 8, 1], 5),
               (SHARED[:4] + [1, 1], 4), ([8, 8, 8], 4)]
LAYOUTS = {
    "ragged_chunked": (dict(prefill_chunk=16), JOBS),
    "legacy": (dict(attention_impl="legacy"), JOBS),
    "dense": (dict(kv_layout="dense"), JOBS),
    "legacy_prefix": (dict(attention_impl="legacy", max_batch_size=1,
                           enable_prefix_caching=True), PREFIX_JOBS),
    "legacy_chunked": (dict(attention_impl="legacy", prefill_chunk=16),
                       JOBS),
}
SAMPLE = dict(do_sample=True, temperature=0.8, top_p=0.9)
# the filters of tests/test_torch_generate.py, on its V = 64 row: 2
# tokens at 3.0, 1 at 2.5, 3 tied at 2.0, 2 at 1.5, the rest below 0
ROW = np.concatenate([[3.0, 3.0, 2.5, 2.0, 2.0, 2.0, 1.5, 1.5],
                      np.random.default_rng(9).uniform(-4, -1, 56)])
ROW = np.random.default_rng(10).permutation(ROW).astype(np.float32)
FILTERS = {
    "top_k_tie": (1.0, 4, 1.0),
    "top_p_tie": (1.0, 0, 0.62),
    "temperature_k_p": (0.7, 7, 0.9),
}
N_JAX, N_PORT = 4000, 20000


@pytest.fixture(scope="module")
def models():
    paddle.seed(21)
    jm = JLlama(JConfig(**CFG))
    jm.eval()
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm


def _opts(kw):
    return dict(dict(max_batch_size=3, max_seq_len=64, page_size=4,
                     prompt_pad=8), **kw)


def _port(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", **_opts(kw))


def _serve(eng, jobs=JOBS):
    rids = [eng.add_request(p, n) for p, n in jobs]
    out = eng.run()
    eng.check_invariants()
    return [out[r] for r in rids]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_top_k_1_equals_jax_greedy(models, layout):
    jm, tm = models
    kw, jobs = LAYOUTS[layout]
    want = _serve(JEngine(jm, **_opts(kw)), jobs)
    eng = _port(tm, top_k=1, seed=3, **dict(SAMPLE, **kw))
    assert _serve(eng, jobs) == want
    assert eng._sample_ctr > 0


@functools.lru_cache(maxsize=None)
def _jax_draws(temp, k, p):
    row = jnp.asarray(ROW)[None]

    def one(key):
        return jg._sample_token(row, key, "sampling", temp, k, p)[0]

    toks = jax.jit(jax.vmap(one))(jax.random.split(jax.random.PRNGKey(7),
                                                   N_JAX))
    return np.asarray(toks)[:, 0]


def _tv(tok, probs):
    return 0.5 * np.abs(np.bincount(tok, minlength=64) / len(tok)
                        - probs).sum()


@pytest.mark.parametrize("name", list(FILTERS))
def test_dispatch_kept_set_and_distribution(models, name):
    _, tm = models
    temp, k, p = FILTERS[name]
    kept = set(_jax_draws(temp, k, p).tolist())
    filtered = tg.filter_logits(torch.from_numpy(ROW)[None], temp, k, p)[0]
    assert set(np.flatnonzero(filtered.numpy() > tg.NEG_INF / 2)
               .tolist()) == kept
    idx = sorted(kept)
    probs = np.zeros(64)
    probs[idx] = np.exp(ROW[idx] / temp - (ROW[idx] / temp).max())
    probs /= probs.sum()
    eng = _port(tm, do_sample=True, temperature=temp, top_k=k, top_p=p,
                seed=11)
    pick = eng._picker()
    rows = torch.from_numpy(ROW)[None].expand(N_PORT, -1)
    tok = pick(rows, torch.from_numpy(eng._next_key())).numpy()
    assert tok.dtype == np.int32 and set(tok.tolist()) <= kept
    assert _tv(tok, probs) < 0.05
    # the next dispatch's key: other draws, the same distribution
    tok2 = pick(rows, torch.from_numpy(eng._next_key())).numpy()
    assert (tok2 != tok).any() and _tv(tok2, probs) < 0.05
    assert eng._sample_ctr == 2


def test_one_row_over_successive_dispatches(models):
    """One row, one draw a dispatch, 4000 dispatch keys: the counter's
    stream alone has the filtered softmax's distribution."""
    _, tm = models
    temp, k, p = FILTERS["temperature_k_p"]
    eng = _port(tm, do_sample=True, temperature=temp, top_k=k, top_p=p,
                seed=5)
    pick = eng._picker()
    row = torch.from_numpy(ROW)[None]
    tok = np.array([int(pick(row, torch.from_numpy(eng._next_key()))[0])
                    for _ in range(N_JAX)])
    jtok = _jax_draws(temp, k, p)
    assert set(tok.tolist()) <= set(jtok.tolist())
    assert _tv(tok, np.bincount(jtok, minlength=64) / N_JAX) < 0.05


@pytest.mark.parametrize("layout", ["ragged_chunked", "legacy_chunked"])
def test_seed_reproduces_eager_and_programmed(models, layout):
    _, tm = models
    kw, jobs = LAYOUTS[layout]
    runs = {}
    for seed, graphs in ((0, True), (0, False), (1, True)):
        eng = _port(tm, seed=seed, _graphs=graphs, **dict(SAMPLE, **kw))
        runs[seed, graphs] = (_serve(eng, jobs), eng._sample_ctr)
        if layout == "ragged_chunked":
            # every dispatch draws once, a chunk continuation too (JAX
            # splits its key for each)
            assert eng._sample_ctr == eng.num_dispatches
    assert runs[0, True] == runs[0, False]
    assert runs[1, True][0] != runs[0, True][0]
    assert [len(s) for s in runs[0, True][0]] == [n for _, n in jobs]


def test_greedy_only_refusals(models):
    jm, tm = models
    for kw in (dict(harvest_every=2),
               dict(spec_decode=SpecConfig(tm, k=2))):
        with pytest.raises(ValueError, match="greedy"):
            _port(tm, **dict(SAMPLE, **kw))
    with pytest.raises(ValueError, match="greedy"):
        JEngine(jm, **_opts(dict(SAMPLE, harvest_every=2)))
