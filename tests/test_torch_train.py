"""Training of the port's tiny Llama (`paddle_tpu_torch`) against the JAX
package's, on the CPU: `LlamaConfig.tiny()` (D = 32, GQA 4:2) built in
JAX from a seed, its weights carried with `llama_state_from_numpy`, the
same (B, S) tokens from numpy through both.

- the loss with ``labels=`` and every parameter's gradient (the port's
  through `llama_grads_to_numpy`), causal, with a sliding window and
  under a key mask;
- three `TrainStep`s with `AdamW` against the JAX `TrainStep`: the loss
  of each step and every parameter after the third;
- ``accumulate_steps=2`` against 1;
- the ported recipe at ``--size tiny --steps 2 --device cpu``.

On the CPU JAX attends through `_sdpa_xla` (no mask, no window), the
interpret-mode Pallas flash kernels (window) or the masked XLA path; the
port through the plain versions of its flash kernels and `_sdpa`.
Tolerances, f32: loss rtol 1e-5; gradients atol 1e-5 plus rtol 1e-4
(sums over the batch's 64 tokens and the vocab in another order);
parameters after three AdamW steps atol 3e-5 (Adam's normalised update
moves every weight by about lr a step, and an element whose gradient is
near zero may take a visibly different step: 3e-5 is 1% of three
steps' movement; one element of 16384 measured 1.8e-5 off)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import llama as jl
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import (llama_grads_to_numpy,
                                             llama_state_from_numpy,
                                             llama_state_to_numpy)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.recipes import llama_pretrain

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _models(window=None):
    jcfg = jl.LlamaConfig.tiny()
    tcfg = tl.LlamaConfig.tiny()
    jcfg.sliding_window = tcfg.sliding_window = window
    paddle.seed(11)
    jm = jl.LlamaForCausalLM(jcfg)
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tl.LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm


def _batch(b=2, s=32, seed=0):
    ids = np.random.default_rng(seed).integers(0, 512, (b, s + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


def _jax_grads(jm, x, y, mask=None):
    kw = {} if mask is None else dict(attention_mask=paddle.to_tensor(mask))
    loss, _ = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y), **kw)
    loss.backward()
    return float(loss), {n: np.asarray(p.grad._value)
                         for n, p in jm.named_parameters()}


def _port_grads(tm, x, y, mask=None):
    kw = {} if mask is None else dict(attention_mask=torch.from_numpy(mask))
    loss, logits = tm(torch.from_numpy(x), labels=torch.from_numpy(y), **kw)
    assert logits.shape == (*x.shape, tm.config.vocab_size)
    loss.backward()
    return float(loss.detach()), llama_grads_to_numpy(tm)


MASK = np.ones((2, 1, 1, 32), bool)
MASK[0, ..., 28:] = False       # sequence 0: its last 4 keys are padding
GRAD_CASES = [("causal", None, None), ("window", 8, None),
              ("key_mask", None, MASK)]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_loss_and_every_grad_match_jax(case):
    _, window, mask = case
    jm, tm = _models(window)
    x, y = _batch()
    jloss, jgrads = _jax_grads(jm, x, y, mask)
    tloss, tgrads = _port_grads(tm, x, y, mask)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name], g, err_msg=name,
                                   **GRAD_TOL)


def test_window_with_a_key_mask_is_the_band_and_the_mask():
    """The JAX windowed branch under a mask cannot run (it reads
    `paddle.bool`, which the package does not define), so the port's is
    held against itself: a sliding window with a (B, 1, 1, S) key mask
    gives the logits of no window under the band ANDed with the mask."""
    _, tw = _models(8)
    _, tm = _models()
    x, _ = _batch()
    band = torch.from_numpy(tl._window_band(32, 32, 0, 8))
    with torch.no_grad():
        a = tw(torch.from_numpy(x), attention_mask=torch.from_numpy(MASK))
        b = tm(torch.from_numpy(x),
               attention_mask=torch.from_numpy(MASK) & band)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ignored_labels_are_left_out_of_the_mean():
    jm, tm = _models()
    x, y = _batch()
    y = y.copy()
    y[0, :10] = -100
    jloss, _ = _jax_grads(jm, x, y)
    tloss, _ = _port_grads(tm, x, y)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)


def test_three_adamw_train_steps_match_jax():
    jm, tm = _models()
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
    assert all(p.grad is None for p in tm.parameters())
    jsd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    for name, w in llama_state_to_numpy(tm).items():
        np.testing.assert_allclose(w, jsd[name], atol=3e-5, rtol=0,
                                   err_msg=name)


def test_accumulate_steps_2_matches_1():
    """Two micro-batches of 2, each loss scaled by 1/2, one AdamW step:
    the mean micro-loss equals the full batch's loss and the parameters
    the k = 1 step's, within f32 sums in another order. The logits a
    `loss_fn` returns come back concatenated over the micro-batches."""
    x, y = _batch(b=4, seed=2)
    out = {}
    for k in (1, 2):
        _, tm = _models()
        opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
        step = TrainStep(tm, opt, loss_fn=lambda m, a, b: m(a, labels=b),
                         accumulate_steps=k)
        losses = []
        for _ in range(2):
            loss, logits = step(torch.from_numpy(x), torch.from_numpy(y))
            losses.append(float(loss))
        assert logits.shape == (4, 32, 512) and not logits.requires_grad
        out[k] = losses, llama_state_to_numpy(tm)
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-6)
    for name, w in out[1][1].items():
        np.testing.assert_allclose(out[2][1][name], w, atol=1e-6, rtol=0,
                                   err_msg=name)
    with pytest.raises(ValueError, match="does not divide"):
        step(torch.from_numpy(x[:3]), torch.from_numpy(y[:3]))


def test_recipe_tiny_on_cpu(capsys):
    r = llama_pretrain.main(["--size", "tiny", "--steps", "2",
                             "--device", "cpu"])
    assert r.steps == 2 and len(r.step_seconds) == 2
    assert np.isfinite(r.final_loss)
    assert "step    1" in capsys.readouterr().out
    for flag in (["--mesh", "dp=2"], ["--save", "x.pt"], ["--resume-drill"],
                 ["--recompute"], ["--data", "x.bin"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            llama_pretrain.main(["--size", "tiny", "--device", "cpu",
                                 *flag])


def test_recipe_needs_a_card_or_a_device():
    """Without ``--device`` the recipe builds on the CUDA card, and
    without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        llama_pretrain.main(["--size", "tiny", "--steps", "1"])
