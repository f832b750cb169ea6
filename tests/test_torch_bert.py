"""BERT masked-LM training of the port (`paddle_tpu_torch.models.bert`,
`optimizer.lr`, `text`, the `bert_mlm` recipe) against the JAX
package's, on the CPU, with a JAX model's weights carried by
`bert_state_from_numpy` and the same tokens from numpy seeds.

- the tiny `BertForMaskedLM` with dropout 0: logits, loss with
  ``labels=`` and every gradient (the word embedding's gathers both its
  uses: lookup and tied decoder), with and without an attention mask;
- three `AdamW` `TrainStep`s under `LinearWarmup` against JAX's, and the
  scheduler's rates step by step;
- `ByteTokenizer` ids and `MLMBlockDataset` items equal JAX's;
- dropout: the keep rate and the 1/(1 - p) scaling from a fixed
  `torch.Generator`, the identity at inference, attention dropout as the
  plain path with the same mask on P, and one seed giving the same
  training run twice;
- the ported recipe at ``--size tiny --steps 2 --device cpu``.

Parity with JAX holds at dropout 0 only: the two draw their dropout
masks from different generators. On the CPU JAX attends through
`_sdpa_xla` and the port through the plain version of its flash kernel.
Tolerances, f32: loss rtol 1e-5, logits rtol 1e-5 plus atol 2e-6 of
the largest |logit| (~30: the decoder is the Normal(0, 1) embedding;
measured 2.1e-5 absolute at most); gradients atol 1e-5 plus rtol 1e-4
(sums over the batch in another order); parameters after three steps
atol 1e-4 as tests/test_torch_moe.py (3% of the 3e-3 three steps can
move a weight; measured 3.6e-5 at most), on every element whose first
gradient is not rounding noise (at least `NOISE_RATIO` times its
difference between the two): Adam's normalised step moves an element by
about lr whatever its gradient's size, so where the gradient is noise
(one linear2 weight element at 7.6e-8) the two take steps of either
sign, and at most 0.01% of the elements may be such; each key bias's
true gradient is zero (softmax ignores q.b_k, the same for every key),
so its gradient is checked to be under 1e-6 instead."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as jb
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer.lr import LinearWarmup as JLinearWarmup
from paddle_tpu.text import ByteTokenizer as JByteTokenizer
from paddle_tpu.text import MLMBlockDataset as JMLMBlockDataset
from paddle_tpu.text import SyntheticTokens as JSyntheticTokens
from paddle_tpu_torch import text as tt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import bert as tb
from paddle_tpu_torch.models.convert import (bert_grads_to_numpy,
                                             bert_state_from_numpy,
                                             bert_state_to_numpy)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.layers import Dropout
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import LinearWarmup
from paddle_tpu_torch.recipes import bert_mlm

LOGIT_ATOL = 2e-6
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# an element whose gradient is under 10x its difference between the two
# (f32 sums in another order) has no sign to compare
NOISE_RATIO = 10
PARAM_ATOL = 1e-4


def _no_dropout(cfg):
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _models(seed=7):
    paddle.seed(seed)
    jm = jb.BertForMaskedLM(_no_dropout(jb.BertConfig.tiny()))
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tb.BertForMaskedLM(_no_dropout(tb.BertConfig.tiny()), device="cpu")
    tm.load_state_dict(bert_state_from_numpy(sd, tm))
    return jm, tm


def _batch(b=2, s=32, seed=0):
    src = tt.SyntheticTokens(261, b * s * 4, seed=seed)
    ds = tt.MLMBlockDataset(src, s, mask_id=260, vocab_size=261, seed=seed)
    items = [ds[i] for i in range(b)]
    return (np.stack([a for a, _ in items]),
            np.stack([c for _, c in items]))


MASK = np.ones((2, 32), np.int32)
MASK[1, 20:] = 0                   # sequence 1: its last 12 keys padding


@pytest.mark.parametrize("mask", [None, MASK], ids=["no_mask", "key_mask"])
def test_tiny_logits_loss_and_every_grad_match_jax(mask):
    jm, tm = _models()
    x, y = _batch()
    jkw = {} if mask is None else dict(attention_mask=paddle.to_tensor(mask))
    tkw = {} if mask is None else dict(attention_mask=torch.from_numpy(mask))
    jloss, jlogits = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y),
                        **jkw)
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()
              if p.grad is not None}
    tloss, tlogits = tm(torch.from_numpy(x), labels=torch.from_numpy(y),
                        **tkw)
    tloss.backward()
    want = np.asarray(jlogits._value)
    np.testing.assert_allclose(tlogits.detach().numpy(), want, rtol=1e-5,
                               atol=LOGIT_ATOL * np.abs(want).max())
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    tgrads = bert_grads_to_numpy(tm)
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name], g, err_msg=name,
                                   **GRAD_TOL)


def test_three_adamw_steps_under_linear_warmup_match_jax():
    jm, tm = _models(seed=8)
    x, y = _batch(seed=1)
    # the first step's gradients (at the initial weights, on both sides)
    # mark the elements whose Adam step follows rounding noise
    jloss, _ = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    jloss.backward()
    tm(torch.from_numpy(x), labels=torch.from_numpy(y))[0].backward()
    tg0 = bert_grads_to_numpy(tm)
    noise = {n: np.abs(np.asarray(p.grad._value))
             < NOISE_RATIO * np.abs(tg0[n] - np.asarray(p.grad._value))
             for n, p in jm.named_parameters() if p.grad is not None}
    jm.clear_gradients()
    jsched = JLinearWarmup(1e-3, warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    tsched = LinearWarmup(1e-3, warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    jopt = JAdamW(learning_rate=jsched, parameters=jm.parameters(),
                  weight_decay=0.01)
    topt = AdamW(learning_rate=tsched, parameters=tm.parameters(),
                 weight_decay=0.01)
    jstep = paddle.jit.TrainStep(jm, jopt,
                                 loss_fn=lambda m, a, b: m(a, labels=b)[0])
    tstep = TrainStep(tm, topt, loss_fn=lambda m, a, b: m(a, labels=b)[0])
    jl_, tl_, rates = [], [], []
    for _ in range(3):
        rates.append((jopt.get_lr(), topt.get_lr()))
        jl_.append(float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))))
        tl_.append(float(tstep(torch.from_numpy(x), torch.from_numpy(y))))
        jsched.step()
        tsched.step()
    assert [t for _, t in rates] == [j for j, _ in rates] == [0.0, 5e-4,
                                                              1e-3]
    np.testing.assert_allclose(tl_, jl_, rtol=1e-5)
    assert tl_[-1] < tl_[0]
    jsd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    noisy = total = 0
    for name, w in bert_state_to_numpy(tm).items():
        # an element whose gradient is within NOISE_RATIO of its
        # difference between the two takes a step of either sign on either
        # side; so does every key bias element at every step: its true
        # gradient is zero (softmax ignores q.b_k, the same for every key)
        if name.endswith("k_proj.bias"):
            assert np.abs(tg0[name]).max() < 1e-6
            continue
        keep = ~noise[name] if name in noise else np.ones(w.shape, bool)
        noisy += int((~keep).sum())
        total += keep.size
        np.testing.assert_allclose(w[keep], jsd[name][keep],
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)
    assert noisy <= 1e-4 * total


def test_linear_warmup_rates_match_jax():
    j = JLinearWarmup(0.1, warmup_steps=4, start_lr=0.01, end_lr=0.1)
    t = LinearWarmup(0.1, warmup_steps=4, start_lr=0.01, end_lr=0.1)
    for _ in range(7):
        assert t() == j() and t.last_epoch == j.last_epoch
        j.step()
        t.step()


def test_tokenizer_and_mlm_blocks_match_jax():
    jt, tk = JByteTokenizer(), tt.ByteTokenizer()
    text = "BERT on the H100 — ünïcode"
    np.testing.assert_array_equal(tk.encode(text, True, True),
                                  jt.encode(text, True, True))
    assert tk.decode(tk.encode(text)) == text
    assert (tk.vocab_size, tk.mask_id, tk.pad_id) == (jt.vocab_size,
                                                       jt.mask_id, jt.pad_id)
    js = JMLMBlockDataset(JSyntheticTokens(261, 5000, seed=3), 64,
                          mask_id=260, vocab_size=261, seed=3)
    ts = tt.MLMBlockDataset(tt.SyntheticTokens(261, 5000, seed=3), 64,
                            mask_id=260, vocab_size=261, seed=3)
    assert len(ts) == len(js) == 78
    for i in range(len(js)):
        for a, b in zip(ts[i], js[i]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        ts[len(ts)]


def test_dropout_rate_scaling_and_generator():
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(0)
    y = TF.dropout(x, 0.1, training=True, generator=g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) < 0.005   # 1e5 draws
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.9))
    y2 = TF.dropout(x, 0.1, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    assert TF.dropout(x, 0.1, training=False) is x
    layer = Dropout(0.5)
    layer.eval()
    assert layer(x) is x


def test_attention_dropout_is_the_plain_path_with_a_mask_on_p():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 6, 2, 8))
                                .astype(np.float32)) for _ in range(3))
    out = TF.scaled_dot_product_attention(
        q, k, v, dropout_p=0.25, generator=torch.Generator().manual_seed(1))
    keep = torch.rand((2, 2, 6, 6),
                      generator=torch.Generator().manual_seed(1)) < 0.75
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
    p = torch.where(keep, torch.softmax(logits, -1) / 0.75, 0.0)
    torch.testing.assert_close(out, torch.einsum("bhqk,bkhd->bqhd", p, v))
    # at inference, and at p = 0, no dropout
    torch.testing.assert_close(
        TF.scaled_dot_product_attention(q, k, v, dropout_p=0.25,
                                        training=False),
        TF.scaled_dot_product_attention(q, k, v))


def test_one_seed_repeats_a_training_run_with_dropout():
    def run(seed):
        tm = tb.BertForMaskedLM(tb.BertConfig.tiny(), device="cpu",
                                seed=seed)
        opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
        step = TrainStep(tm, opt, loss_fn=lambda m, a, b: m(a, labels=b)[0])
        x, y = _batch(seed=2)
        return [float(step(torch.from_numpy(x), torch.from_numpy(y)))
                for _ in range(2)]
    a, b, c = run(3), run(3), run(4)
    assert a == b and a != c
    # the dropout masks matter: eval mode gives another loss
    tm = tb.BertForMaskedLM(tb.BertConfig.tiny(), device="cpu", seed=3)
    x, y = _batch(seed=2)
    tm.eval()
    with torch.no_grad():
        assert float(tm(torch.from_numpy(x), labels=torch.from_numpy(y))[0]) \
            != a[0]


def test_layers_start_equal_and_the_decoder_is_tied():
    tm = tb.BertForMaskedLM(tb.BertConfig.tiny(), device="cpu")
    l0, l1 = tm.bert.encoder.layers
    for (n, a), (_, b) in zip(l0.named_parameters(), l1.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    assert tm.cls._embedding[0].weight is \
        tm.bert.embeddings.word_embeddings.weight
    assert tm.config.num_params() == sum(p.numel()
                                         for p in tm.parameters())


def test_recipe_tiny_on_cpu(capsys):
    r = bert_mlm.main(["--size", "tiny", "--steps", "2", "--device", "cpu"])
    assert r.steps == 2 and len(r.step_seconds) == 2
    assert np.isfinite(r.final_loss)
    assert "step    1" in capsys.readouterr().out
    for flag in (["--save", "x.pt"], ["--data", "x.txt"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            bert_mlm.main(["--size", "tiny", "--device", "cpu", *flag])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            bert_mlm.main(["--size", "tiny", "--steps", "1"])
