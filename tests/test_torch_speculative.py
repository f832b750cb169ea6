"""The port's speculative decoding core (`paddle_tpu_torch.models.
speculative`, on the CPU) against the JAX package's
`paddle_tpu.models.speculative`, on the same seeded weights carried with
`llama_state_from_numpy`, inputs made with numpy:

- `spec_accept_greedy`: accepted counts and bonus tokens equal JAX's on
  seeded proposals, on numpy arrays and on tensors, rows padded with
  never-matching sentinels included (tests/test_spec_decode.py
  `TestAcceptanceCore`);
- `_spec_accept`: the token emitted at the first position, over 40000
  rows drawn from q, within total variation 0.02 of JAX's empirical
  distribution on the same p, q and proposals, and of p itself
  (rejection sampling emits p for any q);
- `speculative_generate` greedy: ids equal JAX's and the port's
  `generate()`, for a random draft and for the target as its own draft
  (acceptance exactly 1.0, as in JAX), and with an EOS in a one-row
  batch (the row emits 0 past it, as in JAX; the acceptance rate equal
  to JAX's);
- the argument errors, as JAX words them;
- sampling: one generator seed, one stream; another seed, another."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import speculative as js
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu_torch.models import speculative as ts
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

TARGET = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=1, max_position_embeddings=64)
DRAFT = dict(TARGET, hidden_size=16, intermediate_size=32,
             num_hidden_layers=1)
# first-token distribution: rows drawn, and the TV bound on 40000 draws
# of V = 6 (the two empirical distributions each sit ~0.007 off p)
N_ROWS = 40000
TV_BOUND = 0.02


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


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 64, shape) \
        .astype(np.int32)


# -- acceptance cores ---------------------------------------------------
def _accept_cases():
    rng = np.random.default_rng(0)
    cases = []
    for r, k in ((5, 1), (7, 3), (16, 4)):
        g = rng.integers(0, 4, (r, k + 1)).astype(np.int32)
        # proposals agreeing with g for a random prefix, then random
        p = g[:, :k].copy()
        cut = rng.integers(0, k + 1, r)
        for i in range(r):
            p[i, cut[i]:] = rng.integers(0, 4, k - cut[i])
        cases.append((g, p))
    # ragged rows: budgets k_i padded with -1 proposals / -2 picks
    g = np.array([[1, 2, -2, -2], [4, 5, 6, 7], [3, -2, -2, -2]], np.int32)
    p = np.array([[1, -1, -1], [4, 5, 6], [-1, -1, -1]], np.int32)
    cases.append((g, p))
    return cases


@pytest.mark.parametrize("case", range(4))
def test_spec_accept_greedy_equals_jax(case):
    g, p = _accept_cases()[case]
    jj, jb = (np.asarray(x) for x in js.spec_accept_greedy(jnp.asarray(g),
                                                           jnp.asarray(p)))
    j, b = ts.spec_accept_greedy(g, p)
    assert j.dtype == np.int32 and b.dtype == np.int32
    np.testing.assert_array_equal(j, jj)
    np.testing.assert_array_equal(b, jb)
    tj, tb = ts.spec_accept_greedy(torch.from_numpy(g), torch.from_numpy(p))
    np.testing.assert_array_equal(tj.numpy(), jj)
    np.testing.assert_array_equal(tb.numpy(), jb)
    if case == 3:                 # the sentinels cap j at k_i
        assert j.tolist() == [1, 3, 0] and b.tolist() == [2, 7, 3]


def test_spec_accept_emits_p_at_the_first_position():
    """Rejection sampling: whatever q proposes, the first emitted token
    (the first proposal if accepted, else the residual draw) is
    distributed as p_0 (JAX's and the port's each within TV_BOUND of p_0
    and of each other)."""
    rng = np.random.default_rng(1)
    v, k = 6, 2
    p = rng.dirichlet(np.ones(v), k + 1).astype(np.float32)
    q = rng.dirichlet(np.ones(v) * 0.5, k).astype(np.float32)
    props = np.stack([rng.choice(v, N_ROWS, p=q[i] / q[i].sum())
                      for i in range(k)], 1).astype(np.int32)
    p_logp = np.broadcast_to(np.log(p), (N_ROWS, k + 1, v))
    q_logp = np.broadcast_to(np.log(q), (N_ROWS, k, v))
    jj, jr = js._spec_accept(jnp.asarray(p_logp), jnp.asarray(q_logp),
                             jnp.asarray(props), jax.random.PRNGKey(3))
    tj, tr = ts._spec_accept(torch.from_numpy(p_logp.copy()),
                             torch.from_numpy(q_logp.copy()),
                             torch.from_numpy(props),
                             torch.Generator().manual_seed(3))
    assert tj.dtype == torch.int32 and tr.dtype == torch.int32

    def first(j, repl):
        j, repl = np.asarray(j), np.asarray(repl)
        return np.where(j >= 1, props[:, 0], repl)

    freq = np.bincount(first(tj, tr), minlength=v) / N_ROWS
    jfreq = np.bincount(first(jj, jr), minlength=v) / N_ROWS
    p0 = p[0] / p[0].sum()
    assert 0.5 * np.abs(freq - jfreq).sum() < TV_BOUND
    assert 0.5 * np.abs(freq - p0).sum() < TV_BOUND
    assert 0.5 * np.abs(jfreq - p0).sum() < TV_BOUND


# -- speculative_generate --------------------------------------------------
def _both(models, ids, self_draft=False, **kw):
    (jt, tt), (jd, td) = models
    if self_draft:
        jd, td = jt, tt
    a, ra = js.speculative_generate(jt, jd, paddle.to_tensor(ids), **kw)
    b, rb = ts.speculative_generate(tt, td, ids, **kw)
    return (np.asarray(a._value), float(np.asarray(ra._value))), \
        (b.numpy(), float(rb))


@pytest.mark.parametrize("self_draft", [False, True],
                         ids=["draft", "self_draft"])
def test_greedy_ids_equal_jax_and_generate(models, self_draft):
    ids = _ids(2, (3, 6))
    (ja, jr), (ta, tr) = _both(models, ids, self_draft,
                               max_new_tokens=12, num_draft_tokens=3)
    assert ta.dtype == np.int32 and ta.shape == (3, 12)
    np.testing.assert_array_equal(ta, ja)
    greedy, _ = models[0][1].generate(ids, max_new_tokens=12)
    np.testing.assert_array_equal(ta, greedy.numpy())
    if self_draft:
        assert tr == jr == 1.0


def test_eos_and_one_row_rate_equal_jax(models):
    """A one-row batch stopping at an EOS: every round is live in both
    loops until then, so the acceptance rates agree too (in a batch whose
    rows end in different rounds JAX also counts the rounds a row rides
    past its max_new_tokens; the port does not)."""
    ids = _ids(2, (1, 6))
    greedy, _ = models[0][1].generate(ids, max_new_tokens=12)
    eos = int(greedy[0, 6])
    (ja, jr), (ta, tr) = _both(models, ids, max_new_tokens=12,
                               num_draft_tokens=2, eos_token_id=eos)
    np.testing.assert_array_equal(ta, ja)
    stop = list(ta[0]).index(eos)
    assert stop <= 6 and (ta[0, stop + 1:] == 0).all()
    assert tr == pytest.approx(jr, abs=1e-7)


@pytest.mark.parametrize("kw,match", [
    (dict(num_draft_tokens=0), "num_draft_tokens must be >= 1"),
    (dict(do_sample=True, temperature=0.0), "temperature must be > 0"),
    (dict(max_cache_len=20), "exceeds cache length"),
    (dict(vocab=True), "vocab"),
], ids=["k0", "temperature", "cache", "vocab"])
def test_argument_errors_match_jax(models, kw, match):
    (jt, tt), (jd, td) = models
    if kw.pop("vocab", False):
        cfg = dict(DRAFT, vocab_size=32)
        jd, td = JLlama(JConfig(**cfg)), LlamaForCausalLM(
            LlamaConfig(**cfg), device="cpu")
    ids = _ids(4, (1, 8))
    with pytest.raises(ValueError, match=match):
        js.speculative_generate(jt, jd, paddle.to_tensor(ids),
                                max_new_tokens=10, **kw)
    with pytest.raises(ValueError, match=match):
        ts.speculative_generate(tt, td, ids, max_new_tokens=10, **kw)


def test_sampling_reproducible_from_a_seed(models):
    (_, tt), (_, td) = models
    ids = _ids(5, (2, 6))
    kw = dict(max_new_tokens=10, num_draft_tokens=3, do_sample=True,
              temperature=0.8)
    runs = [ts.speculative_generate(tt, td, ids, generator=torch.Generator()
                                    .manual_seed(s), **kw)
            for s in (3, 3, 4)]
    (a, ra), (b, rb), (c, _) = runs
    assert a.shape == (2, 10) and a.dtype == torch.int32
    assert torch.equal(a, b) and float(ra) == float(rb)
    assert not torch.equal(a, c)
    assert 0.0 <= float(ra) <= 1.0
    assert int(a.min()) >= 0 and int(a.max()) < 64
