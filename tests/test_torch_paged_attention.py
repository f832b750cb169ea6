"""The legacy paged path of the PyTorch port against the JAX package, on
the CPU: `ops.paged_attention` (``paged_attention_ref`` and the two pool
writes) and ``ContinuousBatchingEngine(attention_impl="legacy")`` of
`paddle_tpu_torch` (``device="cpu"``).

- `paged_attention_values` on the CPU (the plain version) against the
  JAX `paged_attention_values` in interpret mode (``use_kernel=True``)
  and through its XLA path, with and without a sliding window, GQA
  groups 1, 2 and 4, f32: atol 2e-5 (f32 sums in another order, the
  tolerance tests/test_ragged_attention.py holds the two JAX paths to),
  and against the port's own ragged attention at block_q = 1 within the
  same tolerance;
- `paged_append_values` and `paged_prefill_scatter`: pools equal to
  JAX's bitwise outside trash page 0 (which takes the repeated writes
  of padding rows and inactive slots, in an unspecified order);
- engines on the small Llama of tests/test_ragged_attention.py (vocab
  64, hidden 32, page_size 4) and on `LlamaConfig.tiny()`: the port's
  legacy streams equal the JAX legacy engine's and the port's ragged
  engine's, in the clean run, through preemption under a small
  ``num_pages``, and with a ``sliding_window`` config; one prefill
  dispatch per admitted request; the ``quant=`` refusal (the dense
  layout, the prefix cache and ``prefill_chunk`` on this path:
  tests/test_torch_serving_dense.py, tests/test_torch_serving_legacy.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.ops import paged_attention as jpa
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                             QuantServingConfig)
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.ops.ragged_paged_attention import \
    ragged_paged_attention_values

ATOL = 2e-5
JOBS = [([5, 4, 3, 2, 6, 7], 8), ([9, 1, 2], 6), ([7, 7, 1, 2], 5)]


def _case(rng, hk=2, g=2, d=16, ps=4, ctx=(9, 6, 2, 1), pps=4):
    """Decode queries over shuffled pages: sequence b owns its first
    ceil(ctx/ps) block-table entries, the rest trash-route to page 0."""
    b = len(ctx)
    need = [-(-c // ps) for c in ctx]
    n_pages = sum(need) + 2
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((b, pps), np.int32)
    k = 0
    for s, n in enumerate(need):
        bt[s, :n] = perm[k:k + n]
        k += n
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (f(b, hk * g, d), f(hk, n_pages, ps, d), f(hk, n_pages, ps, d),
            np.asarray(ctx, np.int32), bt)


CASES = [("g2", 2, 2, None), ("g2_window3", 2, 2, 3), ("g1", 4, 1, None),
         ("g4_window6", 1, 4, 6)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_attention_matches_jax(case):
    _, hk, g, window = case
    arrays = _case(np.random.default_rng(hk * 10 + g), hk, g)
    got = pa.paged_attention_values(*(torch.from_numpy(a) for a in arrays),
                                    window=window).numpy()
    jargs = [jnp.asarray(a) for a in arrays]
    for use_kernel in (True, False):
        want = np.asarray(jpa.paged_attention_values(
            *jargs, window=window, use_kernel=use_kernel))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # the same work through the ragged attention at block_q = 1
    q, kp, vp, ctx, bt = (torch.from_numpy(a) for a in arrays)
    b = q.shape[0]
    idx = torch.arange(b, dtype=torch.int32)
    ragged = ragged_paged_attention_values(
        q, kp, vp, idx, torch.ones(b, dtype=torch.int32), ctx, bt,
        window=window, block_q=1)
    np.testing.assert_allclose(got, ragged.numpy(), atol=ATOL, rtol=0)


def test_sequence_without_keys_outputs_zero():
    arrays = list(_case(np.random.default_rng(0), ctx=(0, 5)))
    out = pa.paged_attention_values(*(torch.from_numpy(a) for a in arrays))
    assert torch.all(out[0] == 0) and torch.all(torch.isfinite(out))


def test_append_equals_jax_bitwise():
    rng = np.random.default_rng(1)
    _, kp, vp, _, bt = _case(rng)
    bt[3] = 0                                   # an inactive slot
    k = rng.standard_normal((4, 2, 16)).astype(np.float32)
    v = rng.standard_normal((4, 2, 16)).astype(np.float32)
    pos = np.array([8, 5, 1, 3], np.int32)
    jk, jv = jpa.paged_append_values(jnp.asarray(kp), jnp.asarray(vp),
                                     jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(bt), jnp.asarray(pos))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = pa.paged_append_values(tk, tv, torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(bt),
                                 torch.from_numpy(pos))
    assert out[0] is tk and out[1] is tv                  # in place
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])


@pytest.mark.parametrize("true_len", [1, 7, 12])
def test_prefill_scatter_equals_jax_bitwise(true_len):
    rng = np.random.default_rng(true_len)
    _, kp, vp, _, bt = _case(rng, ctx=(12, 1), pps=4)
    rows = rng.standard_normal((2, 12, 2, 16)).astype(np.float32)
    jk, jv = jpa.paged_prefill_scatter(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(rows[0]),
        jnp.asarray(rows[1]), jnp.asarray(bt[0]), true_len)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    pa.paged_prefill_scatter(tk, tv, torch.from_numpy(rows[0]),
                             torch.from_numpy(rows[1]),
                             torch.from_numpy(bt[0]), true_len)
    np.testing.assert_array_equal(tk.numpy()[:, 1:], np.asarray(jk)[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], np.asarray(jv)[:, 1:])


# -- engines -----------------------------------------------------------
def _small_kw(**over):
    kw = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=1, max_position_embeddings=64)
    kw.update(over)
    return kw


def _pair(cfg_kw, seed=7, tiny=False):
    paddle.seed(seed)
    jcfg = JConfig.tiny() if tiny else JConfig(**cfg_kw)
    jm = JLlama(jcfg)
    jm.eval()
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tcfg = LlamaConfig.tiny() if tiny else LlamaConfig(**cfg_kw)
    tm = LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm


@pytest.fixture(scope="module")
def small():
    return _pair(_small_kw())


@pytest.fixture(scope="module")
def windowed():
    return _pair(_small_kw(sliding_window=5), seed=3)


def _run(eng, jobs=JOBS):
    rids = [eng.add_request(p, n) for p, n in jobs]
    out = eng.run()
    if hasattr(eng, "check_invariants"):
        eng.check_invariants()
    return [out[r] for r in rids]


def _port(tm, impl="legacy", **kw):
    kw.setdefault("max_batch_size", 2)
    return ContinuousBatchingEngine(tm, max_seq_len=64, page_size=4,
                                    device="cpu", attention_impl=impl, **kw)


def _jax(jm, **kw):
    return JEngine(jm, max_batch_size=2, max_seq_len=64, page_size=4,
                   attention_impl="legacy", **kw)


@pytest.mark.parametrize("fixture", ["small", "windowed"])
def test_legacy_streams_equal_jax_and_ragged(request, fixture):
    jm, tm = request.getfixturevalue(fixture)
    want = _run(_jax(jm))
    eng, ragged = _port(tm), _port(tm, "ragged")
    assert _run(eng) == want
    assert _run(ragged) == want
    # one prefill dispatch per admitted request, then the decode steps;
    # both engines prefill every prompt token once
    assert eng.num_admission_dispatches == len(JOBS)
    assert eng.decode_tokens == sum(len(s) - 1 for s in want)
    assert eng.admission_tokens == ragged.admission_tokens \
        == sum(len(p) for p, _ in JOBS)
    assert eng.admission_seconds > 0


def test_legacy_streams_equal_jax_on_tiny():
    jm, tm = _pair(None, seed=5, tiny=True)
    rng = np.random.default_rng(0)
    jobs = [(list(rng.integers(0, 512, n)), m)
            for n, m in ((5, 6), (20, 9), (40, 5), (60, 8), (13, 7))]
    want = _run(JEngine(jm, max_batch_size=2, max_seq_len=64,
                        attention_impl="legacy"), jobs)
    got = _run(ContinuousBatchingEngine(tm, max_batch_size=2, max_seq_len=64,
                                        device="cpu",
                                        attention_impl="legacy"), jobs)
    assert got == want


@pytest.mark.parametrize("fixture", ["small", "windowed"])
def test_legacy_streams_through_preemption(request, fixture, monkeypatch):
    """With the reservation bypassed on a tight pool, lazy page growth
    runs dry and preempts the youngest slot, which re-prefills its
    prompt plus its tokens once pages free (a generous
    ``max_preemptions`` lets it wait): the streams stay the JAX legacy
    engine's on an ample pool."""
    jm, tm = request.getfixturevalue(fixture)
    jobs = [([5, 4, 3, 2, 6, 7, 1, 1, 2, 3], 10),
            ([9, 1, 2, 4, 4, 5, 6, 7, 8], 10)]
    want = _run(_jax(jm), jobs)
    eng = _port(tm, num_pages=6, max_preemptions=50)
    monkeypatch.setattr(eng, "_reserve_ok", lambda req: True)
    assert _run(eng, jobs) == want
    assert eng.num_preemptions > 0
    assert len(eng._free) == eng.num_pages - 1


def test_bucket_matches_jax(small):
    jm, tm = small
    j, t = _jax(jm, prompt_pad=8), _port(tm, prompt_pad=8)
    for n in (1, 7, 8, 9, 60, 63):
        assert t._bucket(n) == j._bucket(n)


def test_legacy_gates(small):
    _, tm = small
    with pytest.raises(ValueError, match="paged.*ragged"):
        _port(tm, quant=QuantServingConfig("int8", None))
