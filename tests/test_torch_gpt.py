"""GPT training and generation of the port (`paddle_tpu_torch.models.gpt`)
against the JAX package's `paddle_tpu.models.gpt`, on the CPU, with a
JAX model's weights carried by `gpt_state_from_numpy` and the same
tokens from numpy seeds:

- `GPTConfig.tiny()`: logits, the loss with ``labels=`` (and ignored
  labels) and every parameter's gradient (``wte`` gathers both its uses:
  the lookup and the tied head);
- three AdamW `TrainStep`s against the JAX `TrainStep`: each step's loss
  and every parameter after the third;
- the cached forms: a prefill into zeroed caches then one decode step at
  a time (int and 0-d offsets) against the uncached forward's logits,
  the caches against the keys and values the uncached forward makes, and
  the JAX refusal of a prefill at a tensor offset;
- greedy `generate` ids equal to JAX's (log-probabilities within 1e-4),
  and beam search on tests/test_serving.py
  `TestGPTGenerate.test_beam_search_runs_on_gpt`'s config: ids equal,
  score within 1e-4;
- `synthetic_lm_batch` id for id.

On the CPU JAX attends through `_sdpa_xla` and the port through the plain
version of its flash kernel (and the plain `masked_multihead_attention`
on decode steps, as JAX). Tolerances, f32 (those of
tests/test_torch_bert.py): loss rtol 1e-5; logits rtol 1e-5 plus atol
2e-6 of the largest |logit|; gradients atol 1e-5 plus rtol 1e-4 (sums
over the batch in another order); parameters after three AdamW steps
atol 3e-5 (tests/test_torch_train.py: 1% of three steps' movement at lr
1e-3) on every element but the key biases, whose true gradient is zero
(softmax ignores q.b_k, the same for every key: Adam steps them by
rounding noise, measured 1.8e-3 apart), held under 1e-6 instead;
cached against uncached logits atol 1e-5 of the largest |logit| (the
same products, summed over fewer or padded keys); generation
log-probabilities and beam scores atol / rtol 1e-4
(tests/test_torch_generate.py)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jg
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt as tg
from paddle_tpu_torch.models.convert import (gpt_grads_to_numpy,
                                             gpt_state_from_numpy,
                                             gpt_state_to_numpy)
from paddle_tpu_torch.optimizer import AdamW

LOGIT_ATOL = 2e-6
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_ATOL = 3e-5
GEN_TOL = dict(atol=1e-4, rtol=1e-4)
# tests/test_serving.py::TestGPTGenerate::test_beam_search_runs_on_gpt
BEAM_CFG = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=32)


def _pair(seed, **cfg):
    paddle.seed(seed)
    jm = jg.GPTForCausalLM(jg.GPTConfig(**cfg) if cfg
                           else jg.GPTConfig.tiny())
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tg.GPTForCausalLM(tg.GPTConfig(**cfg) if cfg
                           else tg.GPTConfig.tiny(), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(sd, tm))
    return jm, tm


def _batch(b=2, s=32, seed=0):
    x, y = jg.synthetic_lm_batch(b, s, 512, seed=seed)
    return np.array(x._value), np.array(y._value)


@pytest.fixture(scope="module")
def grads_oracle():
    """The JAX model's logits, loss and gradients on one batch, with the
    port model carrying its weights."""
    jm, tm = _pair(7)
    x, y = _batch()
    y = y.copy()
    y[1, :5] = -100
    loss, logits = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    loss.backward()
    grads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()
             if p.grad is not None}
    return tm, x, y, float(loss), np.asarray(logits._value), grads


def test_logits_loss_and_every_grad_match_jax(grads_oracle):
    tm, x, y, jloss, jlogits, jgrads = grads_oracle
    tloss, tlogits = tm(torch.from_numpy(x), labels=torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), jlogits, rtol=1e-5,
                               atol=LOGIT_ATOL * np.abs(jlogits).max())
    np.testing.assert_allclose(float(tloss.detach()), jloss, rtol=1e-5)
    tgrads = gpt_grads_to_numpy(tm)
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name], g, err_msg=name,
                                   **GRAD_TOL)
        if name.endswith("attn.qkv.bias"):
            h = tm.config.hidden_size
            assert np.abs(tgrads[name][h:2 * h]).max() < 1e-6
    tm.zero_grad(set_to_none=True)


def test_three_adamw_train_steps_match_jax():
    jm, tm = _pair(8)
    x, y = _batch(seed=1)
    jopt = JAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                  weight_decay=0.01)
    jstep = paddle.jit.TrainStep(jm, jopt,
                                 loss_fn=lambda m, a, b: m(a, labels=b)[0])
    topt = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                 weight_decay=0.01)
    tstep = TrainStep(tm, topt, loss_fn=lambda m, a, b: m(a, labels=b)[0])
    jl_, tl_ = [], []
    for _ in range(3):
        jl_.append(float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))))
        tl_.append(float(tstep(torch.from_numpy(x), torch.from_numpy(y))))
    np.testing.assert_allclose(tl_, jl_, rtol=1e-5)
    assert tl_[-1] < tl_[0]
    jsd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tsd = gpt_state_to_numpy(tm)
    assert sorted(tsd) == sorted(jsd)
    h = tm.config.hidden_size
    for name, w in tsd.items():
        want = jsd[name]
        if name.endswith("attn.qkv.bias"):
            # the key bias's true gradient is zero (softmax ignores q.b_k,
            # the same for every key), so Adam's step there follows
            # rounding noise: its gradient is held under 1e-6 instead
            keys = np.s_[h:2 * h]
            w, want = np.delete(w, keys), np.delete(want, keys)
        np.testing.assert_allclose(w, want, atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)


def test_cached_prefill_and_decode_match_the_uncached_forward():
    _, tm = _pair(9)
    cfg = tm.config
    x, _ = _batch(b=2, s=20, seed=2)
    ids = torch.from_numpy(x)
    with torch.no_grad():
        full = tm(ids)
        caches = tm._zero_caches(ids, 24)
        got = [tm(ids[:, :12], caches, position_offset=0)]
        for i in range(12, 20):
            off = i if i % 2 else torch.tensor(i)      # int and 0-d offsets
            got.append(tm(ids[:, i:i + 1], caches, position_offset=off))
        logits, same = tm(ids[:, :1], caches, position_offset=20,
                          use_cache=True)
        # the keys and values the uncached forward makes, layer 0
        h0 = tm.transformer.wte(ids.long()) + tm.transformer.wpe(
            torch.arange(20))
        qkv = tm.transformer.h[0].attn.qkv(tm.transformer.h[0].ln_1(h0))
        k0 = qkv.reshape(2, 20, 3, cfg.num_attention_heads,
                         cfg.head_dim)[:, :, 1]
    atol = 1e-5 * full.abs().max().item()
    torch.testing.assert_close(torch.cat(got, 1), full, rtol=0, atol=atol)
    torch.testing.assert_close(caches[0][0][:, :20], k0, rtol=0, atol=1e-5)
    assert same[0][0] is caches[0][0] and logits.shape == (2, 1, 512)
    with pytest.raises(ValueError, match="static position_offset"):
        tm(ids[:, :2], tm._zero_caches(ids, 24),
           position_offset=torch.tensor(0))


@pytest.mark.parametrize("shape", [(1, 5), (3, 9)])
def test_greedy_generate_equals_jax(shape):
    jm, tm = _pair(5)
    ids = np.random.default_rng(shape[1]).integers(0, 512, shape) \
        .astype(np.int32)
    a, sa = jm.generate(paddle.to_tensor(ids), max_new_tokens=6)
    b, sb = tm.generate(ids, max_new_tokens=6)
    assert b.shape == (shape[0], 6)
    np.testing.assert_array_equal(b.numpy(), np.asarray(a._value))
    np.testing.assert_allclose(sb.numpy(), np.asarray(sa._value),
                               **GEN_TOL)


def test_beam_search_equals_jax():
    jm, tm = _pair(4, **BEAM_CFG)
    ids = np.array([[3, 5, 7]], np.int32)
    kw = dict(max_new_tokens=6, decode_strategy="beam_search", num_beams=3)
    a, sa = jm.generate(paddle.to_tensor(ids), **kw)
    b, sb = tm.generate(ids, **kw)
    assert b.shape == (1, 6) and np.isfinite(float(sb[0]))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a._value))
    np.testing.assert_allclose(sb.numpy(), np.asarray(sa._value),
                               **GEN_TOL)


def test_synthetic_batch_and_tied_head():
    for seed in (0, 3):
        jx, jy = jg.synthetic_lm_batch(3, 17, 512, seed=seed)
        tx, ty = tg.synthetic_lm_batch(3, 17, 512, seed=seed)
        assert tx.dtype == ty.dtype == torch.int32
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx._value))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy._value))
    tm = tg.GPTForCausalLM(tg.GPTConfig.tiny(), device="cpu")
    assert tm.lm_head is None and tm.model is tm.transformer
    assert tm.config.num_params() == sum(p.numel()
                                         for p in tm.parameters())
    untied = tg.GPTConfig.tiny()
    untied.tie_word_embeddings = False
    um = tg.GPTForCausalLM(untied, device="cpu")
    assert um.config.num_params() == sum(p.numel()
                                         for p in um.parameters())
