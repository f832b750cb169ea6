"""MoE of the port (`paddle_tpu_torch.incubate.moe`, `models.moe`, the
`moe_train` recipe) against the JAX package's, on the CPU, with weights
and inputs from numpy seeds (or a JAX model's weights carried with
`moe_state_from_numpy`).

- gating: dispatch, combine and aux loss of `moe_gating_values`, exact
  ties included (JAX's `top_k` puts the lower index first), and the
  capacity path's output, aux and drop count with a capacity small
  enough to drop;
- `MoELayer` forward (out, aux) and every gradient, input included, with
  shared experts, on the dropless and the capacity path;
- the tiny `MoEForCausalLM`: loss with ``labels=`` and every parameter's
  gradient, both paths; three `AdamW` `TrainStep`s against JAX's;
- the ported recipe at ``--size tiny --steps 2 --device cpu``, with and
  without ``--dropless``, and its refusals.

On the CPU the JAX dropless path runs `jax.lax.ragged_dot` (no padding:
the Pallas kernel is TPU-only) and the port `gmm_plain`. Tolerances,
f32: outputs and losses rtol 1e-5 plus atol 1e-6; gradients atol 1e-5
plus rtol 1e-4 (sums over the batch's tokens and experts in another
order); parameters after three AdamW steps atol 1e-4, 3% of the 3e-3
that three steps at lr 1e-3 can move a weight (as
tests/test_torch_train.py says, an element whose gradient is near zero
may take a visibly different Adam step: one w_down element of 24576
measured 5.0e-5 off on the dropless path, the rest under 3e-5). Integer
outputs (drop counts, dispatch) exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import moe as jmoe
from paddle_tpu.models import moe as jmm
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.incubate import moe as tmoe
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import moe as tmm
from paddle_tpu_torch.models.convert import (moe_grads_to_numpy,
                                             moe_state_from_numpy,
                                             moe_state_to_numpy)
from paddle_tpu_torch.ops import launch_counts
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.recipes import moe_train

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_ATOL = 1e-4


def _logits(t, e, seed):
    return np.random.default_rng(seed).standard_normal((t, e)) \
        .astype(np.float32)


@pytest.mark.parametrize("top_k,capacity", [(1, 3), (2, 4), (2, 16)])
def test_gating_matches_jax(top_k, capacity):
    lg = _logits(12, 4, seed=top_k * capacity)
    jd, jc, ja = jmoe.moe_gating_values(jnp.asarray(lg), top_k, capacity)
    td, tc, ta = tmoe.moe_gating_values(torch.from_numpy(lg), top_k,
                                        capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **OUT_TOL)
    np.testing.assert_allclose(float(ta), float(ja), **OUT_TOL)


def test_top_k_ties_take_the_lower_index_first():
    lg = np.zeros((3, 6), np.float32)
    lg[0, [1, 4]] = 2.0            # a tie for first place
    lg[1, [0, 2, 5]] = 1.0         # a three-way tie
    lg[2, :] = [0.5, 0.5, 0.5, 0.5, 0.5, 0.5]
    probs = jax.nn.softmax(jnp.asarray(lg), axis=-1)
    jv, ji = jax.lax.top_k(probs, 3)
    tv, ti = tmoe._top_k(torch.softmax(torch.from_numpy(lg), -1), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **OUT_TOL)


def _experts(h, i, e, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((h, e)).astype(np.float32),
            (0.3 * rng.standard_normal((e, h, i))).astype(np.float32),
            (0.3 * rng.standard_normal((e, h, i))).astype(np.float32),
            (0.3 * rng.standard_normal((e, i, h))).astype(np.float32))


@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
def test_capacity_ffn_and_drops_match_jax(cf):
    t, h, i, e, k = 16, 8, 12, 4, 2
    x = np.random.default_rng(1).standard_normal((t, h)).astype(np.float32)
    ws = _experts(h, i, e, seed=2)
    jo, ja, jdrops = jmoe.moe_ffn_values(jnp.asarray(x),
                                         *map(jnp.asarray, ws), k, cf)
    to, ta, tdrops = tmoe.moe_ffn_values(torch.from_numpy(x),
                                         *map(torch.from_numpy, ws), k, cf)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **OUT_TOL)
    np.testing.assert_allclose(float(ta), float(ja), **OUT_TOL)
    assert int(tdrops) == int(jdrops)
    if cf == 0.5:
        assert int(tdrops) > 0


def test_dropless_ffn_matches_jax():
    t, h, i, e, k = 24, 8, 12, 4, 2
    x = np.random.default_rng(3).standard_normal((t, h)).astype(np.float32)
    ws = _experts(h, i, e, seed=4)
    jo, ja = jmoe.moe_ffn_dropless_values(jnp.asarray(x),
                                          *map(jnp.asarray, ws), k)
    before = dict(launch_counts)
    to, ta = tmoe.moe_ffn_dropless_values(torch.from_numpy(x),
                                          *map(torch.from_numpy, ws), k)
    assert launch_counts == before
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **OUT_TOL)
    np.testing.assert_allclose(float(ta), float(ja), **OUT_TOL)


def _layers(dropless, seed=5):
    paddle.seed(seed)
    jl = jmoe.MoELayer(16, 24, 4, top_k=2, capacity_factor=1.0,
                       shared_intermediate_size=20, dropless=dropless)
    tl = tmoe.MoELayer(16, 24, 4, top_k=2, capacity_factor=1.0,
                       shared_intermediate_size=20, dropless=dropless,
                       device="cpu")
    sd = {n: np.asarray(p._value) for n, p in jl.state_dict().items()}
    with torch.no_grad():
        for n, p in tl.named_parameters():
            a = torch.from_numpy(sd[n].copy())
            p.copy_(a.T if n.startswith("shared_") else a)
    return jl, tl


@pytest.mark.parametrize("dropless", [True, False],
                         ids=["dropless", "capacity"])
def test_moe_layer_forward_and_grads_match_jax(dropless):
    jl, tl = _layers(dropless)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32)
    g = rng.standard_normal((2, 10, 16)).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jo, ja = jl(jx)
    (paddle.sum(jo * paddle.to_tensor(g)) + ja).backward()
    tx = torch.from_numpy(x).requires_grad_()
    to, ta = tl(tx)
    ((to * torch.from_numpy(g)).sum() + ta).backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo._value),
                               **OUT_TOL)
    np.testing.assert_allclose(float(ta.detach()), float(ja._value),
                               **OUT_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._value),
                               **GRAD_TOL)
    jgrads = {n: np.asarray(p.grad._value) for n, p in jl.named_parameters()}
    for n, p in tl.named_parameters():
        want = jgrads[n].T if n.startswith("shared_") else jgrads[n]
        np.testing.assert_allclose(p.grad.numpy(), want, err_msg=n,
                                   **GRAD_TOL)
    assert tl.last_drop_count == jl.last_drop_count
    if dropless:
        assert tl.last_drop_count == 0


def _models(dropless, seed=11):
    jcfg, tcfg = jmm.MoEConfig.tiny(), tmm.MoEConfig.tiny()
    jcfg.dropless = tcfg.dropless = dropless
    paddle.seed(seed)
    jm = jmm.MoEForCausalLM(jcfg)
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tmm.MoEForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(moe_state_from_numpy(sd, tm))
    return jm, tm


def _batch(b=2, s=32, seed=0):
    ids = np.random.default_rng(seed).integers(0, 512, (b, s + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


@pytest.mark.parametrize("dropless", [True, False],
                         ids=["dropless", "capacity"])
def test_tiny_model_loss_and_every_grad_match_jax(dropless):
    jm, tm = _models(dropless)
    x, y = _batch()
    jloss, _ = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    tloss, logits = tm(torch.from_numpy(x), labels=torch.from_numpy(y))
    assert logits.shape == (2, 32, 512)
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    tgrads = moe_grads_to_numpy(tm)
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name], g, err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("dropless", [True, False],
                         ids=["dropless", "capacity"])
def test_three_adamw_train_steps_match_jax(dropless):
    jm, tm = _models(dropless)
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
    for name, w in moe_state_to_numpy(tm).items():
        np.testing.assert_allclose(w, jsd[name], atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)


def test_config_counts():
    """Parameter counts of the A14B width (one layer) add up: every
    parameter, and the active ones (top-8 routed + shared + attention +
    router + lm_head) that a token multiplies by."""
    cfg = moe_train.train_a14b_config()
    assert cfg.dropless and cfg.num_hidden_layers == 1
    h, v = 3584, 151936
    attn = 2 * h * h + 2 * h * 512
    experts = 3 * h * 2560
    assert cfg.num_params() == (attn + h * 64 + 64 * experts
                                + 3 * h * 20480 + 2 * h) + 2 * v * h + h
    assert cfg.active_params() == (attn + h * 64 + 8 * experts
                                   + 3 * h * 20480) + v * h
    tm = tmm.MoEForCausalLM(tmm.MoEConfig.tiny(), device="cpu")
    assert tm.config.num_params() == sum(p.numel() for p in tm.parameters())


@pytest.mark.parametrize("dropless", [[], ["--dropless"]],
                         ids=["capacity", "dropless"])
def test_recipe_tiny_on_cpu(dropless, capsys):
    r = moe_train.main(["--size", "tiny", "--steps", "2", "--device", "cpu",
                        *dropless])
    assert r.steps == 2 and len(r.step_seconds) == 2
    assert np.isfinite(r.final_loss)
    assert "step    1" in capsys.readouterr().out


def test_recipe_refusals():
    for flag in (["--mesh", "dp=2,ep=4"], ["--save", "x.pt"],
                 ["--data", "x.bin"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            moe_train.main(["--size", "tiny", "--device", "cpu", *flag])
    with pytest.raises(NotImplementedError, match="mesh"):
        tmoe.shard_moe(None, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            moe_train.main(["--size", "tiny", "--steps", "1"])
