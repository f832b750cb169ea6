"""Every (k, v) tuple-cache form of the port's `LlamaAttention.forward`
against the JAX model's, on `LlamaConfig.tiny()` built in JAX from a seed
(weights carried with `llama_state_from_numpy`) and (B, 32, HK, D) caches
pre-filled with seeded noise, so that a wrong key shows: logits and both
caches after the call within atol / rtol 1e-4 in f32.

The forms: a prefill at an int offset, with and without a key-validity
mask (without one it goes through `flash_attention_values`, once a
layer; with one it never does); two chunks equal to one shot
(tests/test_serving.py `test_chunked_prefill_matches_full`); a decode
step (S == 1) at an int, a 0-d and a (B,) offset, with a mask too; the
traced branch (S > 1 at a 0-d or a (B,) offset), with a mask shorter
than the cache padded; each again under a sliding window."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import llama_state_from_numpy

TOL = dict(atol=1e-4, rtol=1e-4)
S_MAX = 32

# name: (B, S, offset, key-validity mask width or None); an offset is an
# int, ("0d", n) or ("vec", [n per row])
CASES = {
    "prefill_at_0": (2, 8, 0, None),
    "prefill_at_5": (2, 6, 5, None),
    "prefill_masked": (2, 6, 4, 10),
    "decode_int": (2, 1, 9, None),
    "decode_int_masked": (2, 1, 9, S_MAX),
    "decode_0d": (2, 1, ("0d", 12), None),
    "decode_vec": (3, 1, ("vec", [3, 17, 30]), None),
    "decode_vec_masked": (2, 1, ("vec", [4, 20]), S_MAX),
    "traced_0d": (2, 5, ("0d", 7), None),
    "traced_vec": (2, 3, ("vec", [2, 11]), None),
    "traced_vec_short_mask": (2, 4, ("vec", [6, 9]), 10),
    "traced_0d_full_mask": (1, 4, ("0d", 3), S_MAX),
}


def _pair(window=None):
    paddle.seed(11)
    jcfg, tcfg = jl.LlamaConfig.tiny(), tl.LlamaConfig.tiny()
    jcfg.sliding_window = tcfg.sliding_window = window
    jm = jl.LlamaForCausalLM(jcfg)
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tl.LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def windowed():
    return _pair(window=4)


def _inputs(cfg, b, s, width, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    shape = (b, S_MAX, cfg.num_key_value_heads, cfg.head_dim)
    caches = [tuple(rng.normal(size=shape).astype(np.float32)
                    for _ in range(2))
              for _ in range(cfg.num_hidden_layers)]
    mask = None
    if width is not None:
        mask = rng.random((b, width)) > 0.25
        mask[:, 0] = True                 # every row keeps a key
    return ids, caches, mask


def _offsets(off):
    """(JAX offset, port offset) for an int, ("0d", n) or ("vec", ns)."""
    if isinstance(off, int):
        return off, off
    kind, val = off
    arr = np.asarray(val, np.int32)
    return Tensor(jnp.asarray(arr)), torch.from_numpy(arr)


def _run_jax(jm, ids, caches, off, mask):
    with paddle.no_grad():
        logits, new = jm(
            Tensor(jnp.asarray(ids)),
            past_key_values=[(Tensor(jnp.asarray(k)), Tensor(jnp.asarray(v)))
                             for k, v in caches],
            position_offset=off,
            attention_mask=None if mask is None
            else Tensor(jnp.asarray(mask)), use_cache=True)
    return np.asarray(logits._value), [
        (np.asarray(k._value), np.asarray(v._value)) for k, v in new]


def _run_port(tm, ids, caches, off, mask):
    tc = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
          for k, v in caches]
    with torch.no_grad():
        logits = tm(torch.from_numpy(ids), tc, position_offset=off,
                    attention_mask=None if mask is None
                    else torch.from_numpy(mask))
    return logits.numpy(), [(k.numpy(), v.numpy()) for k, v in tc]


def _check(pair, name, seed, monkeypatch):
    jm, tm = pair
    b, s, off, width = CASES[name]
    ids, caches, mask = _inputs(tm.config, b, s, width, seed)
    joff, toff = _offsets(off)
    calls = []
    real = tl.flash_attention_values

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(tl, "flash_attention_values", counted)
    want, wcaches = _run_jax(jm, ids, caches, joff, mask)
    got, gcaches = _run_port(tm, ids, caches, toff, mask)
    np.testing.assert_allclose(got, want, **TOL)
    for (gk, gv), (wk, wv) in zip(gcaches, wcaches):
        np.testing.assert_allclose(gk, wk, **TOL)
        np.testing.assert_allclose(gv, wv, **TOL)
    return calls


@pytest.mark.parametrize("name", list(CASES))
def test_cache_forms_equal_jax(models, name, monkeypatch):
    calls = _check(models, name, 1, monkeypatch)
    b, s, off, width = CASES[name]
    # the flash route: an int-offset prefill without a mask (and no
    # window), once a layer; every other form stays plain
    flash = isinstance(off, int) and s > 1 and width is None
    assert len(calls) == (models[1].config.num_hidden_layers if flash
                          else 0)


@pytest.mark.parametrize("name", ["prefill_at_0", "prefill_at_5",
                                  "prefill_masked", "decode_int",
                                  "decode_vec", "traced_0d",
                                  "traced_vec_short_mask"])
def test_cache_forms_under_a_window_equal_jax(windowed, name, monkeypatch):
    calls = _check(windowed, name, 2, monkeypatch)
    assert calls == []            # a window takes the plain masked path


def test_two_chunks_equal_one_shot(models):
    """≙ `test_chunked_prefill_matches_full`: a two-chunk prefill through
    the cache (the second chunk at offset 8, end-aligned causal over the
    filled prefix) gives the one-shot forward's last logits, and the
    JAX model's two chunks' logits."""
    jm, tm = models
    cfg = tm.config
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 16)) \
        .astype(np.int32)
    zeros = [tuple(np.zeros((1, S_MAX, cfg.num_key_value_heads,
                             cfg.head_dim), np.float32) for _ in range(2))
             for _ in range(cfg.num_hidden_layers)]
    tc = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
          for k, v in zeros]
    with torch.no_grad():
        tm(torch.from_numpy(ids[:, :8]), tc, position_offset=0)
        l2 = tm(torch.from_numpy(ids[:, 8:]), tc, position_offset=8)
        full = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(l2[:, -1].numpy(), full[:, -1].numpy(), **TOL)
    _, jc = _run_jax(jm, ids[:, :8], zeros, 0, None)
    jl2, _ = _run_jax(jm, ids[:, 8:], jc, 8, None)
    np.testing.assert_allclose(l2.numpy(), jl2, **TOL)


def test_rope_offsets_equal_jax(models):
    """`apply_rope` at an int, a 0-d and a (B,) offset over S = 1 and S >
    1 rows against the JAX function."""
    jm, tm = models
    x = np.random.default_rng(3).normal(size=(2, 5, 4, 32)).astype(np.float32)
    jcos, jsin = jm.model.rope_cos, jm.model.rope_sin
    tcos, tsin = tm.model.rope_cos, tm.model.rope_sin
    for off in (3, ("0d", 9), ("vec", [1, 30])):
        joff, toff = _offsets(off)
        for s in (1, 5):
            want = jl.apply_rope(Tensor(jnp.asarray(x[:, :s])), jcos, jsin,
                                 joff)
            got = tl.apply_rope(torch.from_numpy(x[:, :s]), tcos, tsin, toff)
            np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                       **TOL)


def test_cache_writes_equal_jax():
    """`_update_kv_cache` at every offset form, bitwise: in place on the
    port's cache, functional in JAX."""
    rng = np.random.default_rng(8)
    cache = rng.normal(size=(2, 16, 2, 4)).astype(np.float32)
    for off, s in ((5, 3), (("0d", 4), 3), (("0d", 15), 3),
                   (("vec", [2, 13]), 1), (("vec", [0, 9]), 4)):
        new = rng.normal(size=(2, s, 2, 4)).astype(np.float32)
        joff, toff = _offsets(off)
        want = jl._update_kv_cache(Tensor(jnp.asarray(cache)),
                                   Tensor(jnp.asarray(new)), joff)
        got = torch.from_numpy(cache.copy())
        tl._update_kv_cache(got, torch.from_numpy(new), toff)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want._value))
