"""ERNIE on one device in the port (`paddle_tpu_torch.models.ernie`, the
`ernie_4d` recipe) against the JAX package's `paddle_tpu.models.ernie`,
on the CPU, with a JAX model's weights carried by
`ernie_state_from_numpy` and the same ids from
`synthetic_ernie_batch`'s numpy draws:

- `ErnieForPretraining` on `ErnieConfig.tiny()` at dropout 0: the MLM
  logits, the sentence-order logits, the loss with ``labels=`` and
  ``sop_labels=`` and every gradient, with token-type ids, without an
  attention mask (flash attention) and with one (the plain masked path),
  as JAX routes them;
- `ErnieForSequenceClassification`: logits, loss and every gradient;
- `synthetic_ernie_batch` id for id;
- the ported recipe at ``--size tiny --steps 2 --device cpu`` with
  ``--save``, ``--mesh`` refused, and `shard_ernie` refused.

Parity with JAX holds at dropout 0 only: the two draw their dropout masks
from different generators. On the CPU JAX attends through `_sdpa_xla`
and the port through the plain version of its flash kernel (no mask) or
`_sdpa` (mask). Tolerances, f32 (those of tests/test_torch_bert.py):
loss rtol 1e-5; logits rtol 1e-5 plus atol 2e-6 of the largest |logit|;
gradients atol 1e-5 plus rtol 1e-4 (sums over the batch in another
order); each key bias's true gradient is zero (softmax ignores q.b_k),
and both sides read it within the atol."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import ernie as je
import paddle_tpu_torch
from paddle_tpu_torch.models import ernie as te
from paddle_tpu_torch.models.convert import (ernie_grads_to_numpy,
                                             ernie_state_from_numpy)
from paddle_tpu_torch.recipes import ernie_4d

LOGIT_ATOL = 2e-6
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
B, S = 2, 32
MASK = np.ones((B, S), np.int32)
MASK[1, 20:] = 0                   # sequence 1: its last 12 keys padding


def _no_dropout(cfg):
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _pair(jcls, tcls, seed, **kw):
    paddle.seed(seed)
    jm = jcls(_no_dropout(je.ErnieConfig.tiny()), **kw)
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tcls(_no_dropout(te.ErnieConfig.tiny()), device="cpu", **kw)
    tm.load_state_dict(ernie_state_from_numpy(sd, tm))
    return jm, tm


def _inputs(seed=0):
    ids, lbl, sop = (np.array(t._value) for t in
                     je.synthetic_ernie_batch(B, S, 1024, seed=seed))
    tt = np.random.default_rng(seed).integers(0, 4, (B, S)) \
        .astype(np.int32)
    return ids, lbl, sop, tt


def _grads(jm):
    return {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()
            if p.grad is not None}


@pytest.fixture(scope="module", params=["no_mask", "key_mask"])
def pretraining_oracle(request):
    """The JAX pretraining model's logits, SOP logits, loss and
    gradients, with and without the key mask."""
    jm, tm = _pair(je.ErnieForPretraining, te.ErnieForPretraining, 7)
    ids, lbl, sop, tt = _inputs()
    mask = MASK if request.param == "key_mask" else None
    jkw = dict(token_type_ids=paddle.to_tensor(tt))
    if mask is not None:
        jkw["attention_mask"] = paddle.to_tensor(mask)
    jlogits, jsop = jm(paddle.to_tensor(ids), **jkw)
    jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(lbl),
                  sop_labels=paddle.to_tensor(sop), **jkw)
    jloss.backward()
    want = dict(logits=np.asarray(jlogits._value),
                sop=np.asarray(jsop._value), loss=float(jloss),
                grads=_grads(jm))
    return tm, (ids, lbl, sop, tt, mask), want


def _close_logits(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=LOGIT_ATOL * np.abs(want).max())


def _close_grads(tgrads, jgrads):
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name], g, err_msg=name,
                                   **GRAD_TOL)


def test_pretraining_logits_loss_and_every_grad_match_jax(
        pretraining_oracle):
    tm, (ids, lbl, sop, tt, mask), want = pretraining_oracle
    kw = dict(token_type_ids=torch.from_numpy(tt))
    if mask is not None:
        kw["attention_mask"] = torch.from_numpy(mask)
    with torch.no_grad():
        logits, sop_logits = tm(torch.from_numpy(ids), **kw)
    _close_logits(logits, want["logits"])
    _close_logits(sop_logits, want["sop"])
    loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(lbl),
                 sop_labels=torch.from_numpy(sop), **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want["loss"],
                               rtol=1e-5)
    _close_grads(ernie_grads_to_numpy(tm), want["grads"])
    tm.zero_grad(set_to_none=True)


def test_sequence_classification_matches_jax():
    jm, tm = _pair(je.ErnieForSequenceClassification,
                   te.ErnieForSequenceClassification, 8, num_classes=3)
    ids, _, _, tt = _inputs(seed=1)
    y = np.array([2, 0], np.int32)
    jloss, jlogits = jm(paddle.to_tensor(ids),
                        token_type_ids=paddle.to_tensor(tt),
                        attention_mask=paddle.to_tensor(MASK),
                        labels=paddle.to_tensor(y))
    jloss.backward()
    tloss, tlogits = tm(torch.from_numpy(ids),
                        token_type_ids=torch.from_numpy(tt),
                        attention_mask=torch.from_numpy(MASK),
                        labels=torch.from_numpy(y))
    tloss.backward()
    assert tlogits.shape == (B, 3)
    _close_logits(tlogits, np.asarray(jlogits._value))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    _close_grads(ernie_grads_to_numpy(tm), _grads(jm))
    with torch.no_grad():
        assert tm(torch.from_numpy(ids)).shape == (B, 3)


def test_synthetic_batch_matches_jax():
    for seed in (0, 5):
        for a, b in zip(te.synthetic_ernie_batch(3, 40, 1024, seed=seed),
                        je.synthetic_ernie_batch(3, 40, 1024, seed=seed)):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b._value))


def test_recipe_tiny_on_cpu(capsys, tmp_path):
    path = tmp_path / "ernie.pdparams"
    r = ernie_4d.main(["--size", "tiny", "--steps", "2", "--device", "cpu",
                       "--save", str(path)])
    assert r.steps == 2 and len(r.losses) == 2
    assert np.isfinite(r.final_loss)
    out = capsys.readouterr().out
    assert "step    1" in out and f"saved {path}" in out
    tm = te.ErnieForPretraining(te.ErnieConfig.tiny(), device="cpu")
    tm.load_state_dict(paddle_tpu_torch.load(str(path), device="cpu"))
    with pytest.raises(NotImplementedError, match="item 9"):
        ernie_4d.main(["--size", "tiny", "--device", "cpu", "--mesh",
                       "dp=2,mp=2"])
    with pytest.raises(NotImplementedError, match="item 9"):
        te.shard_ernie(tm, None)
