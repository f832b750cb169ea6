"""DiT in the port (`paddle_tpu_torch.models.dit`, the `dit_train` recipe)
against the JAX package's `paddle_tpu.models.dit`, on the CPU, with a
JAX model's weights carried by `dit_state_from_numpy` and the same
inputs from `synthetic_dit_batch`'s numpy draws.

adaLN-Zero makes an untrained DiT's output exactly zero (``ada`` and
``final_layer`` start at 0, so every gate is 0 and attention adds
nothing), and a parity check there cannot fail. Every check here first
sets each ``ada`` and ``final_layer`` weight and bias to the same seeded
non-zero numpy arrays on both sides (`_nonzero`), and a planted wrong
attention scale on the port's side is shown to break the forward check.

- `timestep_embedding` (cos before sin) and the 2-D sin-cos
  ``pos_embed``;
- `DiTConfig.tiny()`: the forward, `training_loss` with the same
  ``noise`` and every parameter's gradient;
- DDIM at eta 0 from JAX's own x_T (``k_init, _ =
  jax.random.split(jax.random.key(seed))``; ``jax.random.normal(k_init,
  shape, float32)``) through the port's `_ddim_loop`, against
  `GaussianDiffusion.ddim_sample(..., seed=seed)` of the JAX package;
- the eta > 0 branch against a numpy transcription of the JAX scan
  body's update given the port's eps and its generator's draws; one seed
  giving one sample, another another;
- the recipe at ``--size tiny --steps 2 --sample-after --device cpu``
  with ``--save``, and ``--mesh`` refused.

On the CPU JAX attends through `_sdpa_xla` (and normalises through XLA:
its LayerNorm without an affine never reaches its kernel) and the port
through the plain versions of its flash and LayerNorm kernels.
Tolerances, f32: the position embedding rtol 1e-6 plus atol 1e-6 (the
same f64 table cast to f32); the timestep embedding the same at t <= 17
and atol 1e-4 at t 500 and 999 (XLA's and torch's f32 exp may round a
frequency one ulp apart, and t · freq, up to 999 radians, carries that
to 6e-5 in a sin / cos argument; measured 2.8e-5); the forward rtol
1e-5 plus atol 2e-6 of the largest |output| (tests/test_torch_bert.py's
logits; measured 1.0e-6 of it); loss rtol 1e-5; gradients atol 1e-5
plus rtol 1e-4 (sums over the batch in another order); DDIM atol 1e-5
of the largest |x_0| (each step divides by sqrt(alpha_bar_t), down to
6.3e-3 at t = 999, which magnifies the forwards' f32 differences;
measured 9.4e-7 of it); the eta > 0 branch atol 1e-5 of the largest
|x_0| (f32 against the f64 transcription; measured 2.2e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import dit as jd
import paddle_tpu_torch
from paddle_tpu_torch.models import dit as td
from paddle_tpu_torch.models.convert import (dit_grads_to_numpy,
                                             dit_state_from_numpy)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.recipes import dit_train

OUT_ATOL = 2e-6
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
EMB_ATOL = 1e-4
DDIM_ATOL = 1e-5
ETA_ATOL = 1e-5
B, STEPS, SEED = 2, 10, 3


def _nonzero(sd, seed=1):
    """``ada`` and ``final_layer`` set to seeded non-zero values."""
    rng = np.random.default_rng(seed)
    return {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            if ".ada." in k or k.startswith("final_layer.") else v
            for k, v in sd.items()}


@pytest.fixture(scope="module")
def pair():
    paddle.seed(4)
    jm = jd.DiT(jd.DiTConfig.tiny())
    sd = _nonzero({k: np.asarray(v._value)
                   for k, v in jm.state_dict().items()})
    assert jm.set_state_dict(sd) == ([], [])
    tm = td.DiT(td.DiTConfig.tiny(), device="cpu")
    tm.load_state_dict(dit_state_from_numpy(sd, tm))
    return jm, tm


def _batch(seed=0):
    x, t, y = jd.synthetic_dit_batch(B, jd.DiTConfig.tiny(), seed=seed)
    noise = np.random.default_rng(seed + 100).standard_normal(
        x.shape).astype(np.float32)
    return (np.array(x._value), np.array(t._value), np.array(y._value),
            noise)


@pytest.fixture(scope="module")
def oracle(pair):
    """The JAX model's forward, loss with the given noise, gradients and
    eta-0 DDIM sample."""
    jm, _ = pair
    x, t, y, noise = _batch()
    out = np.asarray(jm(paddle.to_tensor(x), paddle.to_tensor(t),
                        paddle.to_tensor(y))._value)
    loss = jd.GaussianDiffusion().training_loss(
        jm, paddle.to_tensor(x), paddle.to_tensor(t), paddle.to_tensor(y),
        noise=paddle.to_tensor(noise))
    loss.backward()
    grads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()
             if p.grad is not None}
    jm.clear_gradients()
    ddim = np.asarray(jd.GaussianDiffusion().ddim_sample(
        jm, batch_size=B, y=paddle.to_tensor(y), num_steps=STEPS,
        eta=0.0, seed=SEED)._value)
    return dict(out=out, loss=float(loss), grads=grads, ddim=ddim)


def _forward(tm, x, t, y):
    with torch.no_grad():
        return tm(torch.from_numpy(x), torch.from_numpy(t),
                  torch.from_numpy(y)).numpy()


def _out_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=OUT_ATOL * np.abs(want).max())


def test_timestep_and_position_embeddings_match_jax(pair):
    t = np.array([0, 1, 17, 999, 500], np.int32)
    want = np.asarray(jd.timestep_embedding(paddle.to_tensor(t), 256)._value)
    got = td.timestep_embedding(torch.from_numpy(t), 256).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=EMB_ATOL)
    # where t · freq is small, the two agree to f32 rounding
    np.testing.assert_allclose(got[:3], want[:3], rtol=1e-6, atol=1e-6)
    jm, tm = pair
    np.testing.assert_allclose(tm.pos_embed.numpy(),
                               np.asarray(jm.pos_embed._value), rtol=1e-6,
                               atol=1e-6)
    assert "pos_embed" not in tm.state_dict()


def test_forward_matches_jax_and_a_wrong_scale_breaks_it(pair, oracle,
                                                          monkeypatch):
    _, tm = pair
    x, t, y, _ = _batch()
    want = oracle["out"]
    assert np.abs(want).max() > 0.1           # the gates are open
    got = _forward(tm, x, t, y)
    assert got.shape == (B, 8, 8, 8)
    _out_close(got, want)
    apply = fa._FlashAttentionFn.apply
    monkeypatch.setattr(fa._FlashAttentionFn, "apply",
                        lambda q, k, v, scale, *a: apply(q, k, v,
                                                          1.25 * scale, *a))
    with pytest.raises(AssertionError):
        _out_close(_forward(tm, x, t, y), want)


def test_training_loss_and_every_grad_match_jax(pair, oracle):
    _, tm = pair
    x, t, y, noise = _batch()
    loss = td.GaussianDiffusion().training_loss(
        tm, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y),
        noise=torch.from_numpy(noise))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), oracle["loss"],
                               rtol=1e-5)
    tgrads = dit_grads_to_numpy(tm)
    tm.zero_grad(set_to_none=True)
    assert sorted(tgrads) == sorted(oracle["grads"])
    for name, g in oracle["grads"].items():
        np.testing.assert_allclose(tgrads[name], g, err_msg=name,
                                   **GRAD_TOL)


def test_ddim_eta0_from_jax_x_t_matches_jax(pair, oracle):
    _, tm = pair
    cfg = tm.config
    k_init, _ = jax.random.split(jax.random.key(SEED))
    x_t = np.array(jax.random.normal(
        k_init, (B, cfg.in_channels, cfg.input_size, cfg.input_size),
        jnp.float32))
    _, _, y, _ = _batch()
    got = td.GaussianDiffusion()._ddim_loop(tm, torch.from_numpy(x_t),
                                            torch.from_numpy(y), STEPS)
    want = oracle["ddim"]
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=DDIM_ATOL * np.abs(want).max())


def _eta_reference(tm, x, y, steps, eta, gen):
    """The JAX scan body's update in f64 numpy, the port's eps and the
    port generator's draws (one a step, the last multiplied by 0)."""
    ac = td.GaussianDiffusion().alphas_cumprod.astype(np.float64)
    ts = np.linspace(999, 0, steps).round().astype(np.int32)
    x = x.numpy().astype(np.float64)
    for i in range(steps):
        t_prev = ts[i + 1] if i + 1 < steps else -1
        with torch.no_grad():
            eps = tm(torch.from_numpy(x.astype(np.float32)),
                     torch.full((x.shape[0],), int(ts[i]), dtype=torch.int32),
                     y)[:, :4].numpy().astype(np.float64)
        a_t = ac[ts[i]]
        a_p = ac[t_prev] if t_prev >= 0 else 1.0
        x0 = (x - np.sqrt(1 - a_t) * eps) / np.sqrt(a_t)
        sigma = eta * np.sqrt(max((1 - a_p) / max(1 - a_t, 1e-12)
                                  * (1 - a_t / a_p), 0.0))
        x = np.sqrt(a_p) * x0 + np.sqrt(max(1 - a_p - sigma ** 2, 0.0)) * eps
        noise = torch.randn(x.shape, generator=gen).numpy()
        x = x + (sigma if t_prev >= 0 else 0.0) * noise
    return x


def test_ddim_eta_branch_and_seeds(pair):
    _, tm = pair
    cfg = tm.config
    gd = td.GaussianDiffusion()
    y = torch.tensor([1, 7], dtype=torch.int32)
    shape = (B, cfg.in_channels, cfg.input_size, cfg.input_size)
    a = gd.ddim_sample(tm, B, y, num_steps=4, eta=0.0, seed=11)
    b = gd.ddim_sample(tm, B, y, num_steps=4, eta=0.0, seed=11)
    c = gd.ddim_sample(tm, B, y, num_steps=4, eta=0.0, seed=12)
    assert torch.equal(a, b) and not torch.equal(a, c)
    x_t = torch.randn(shape, generator=torch.Generator().manual_seed(11))
    assert torch.equal(gd._ddim_loop(tm, x_t, y, 4), a)
    # eta > 0: x_T then one draw a step from the seed's generator
    got = gd.ddim_sample(tm, B, y, num_steps=4, eta=0.5, seed=11)
    gen = torch.Generator().manual_seed(11)
    want = _eta_reference(tm, torch.randn(shape, generator=gen), y, 4, 0.5,
                          gen)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=ETA_ATOL * np.abs(want).max())
    assert not torch.allclose(got, a)
    assert torch.equal(got, gd.ddim_sample(tm, B, y, num_steps=4, eta=0.5,
                                           seed=11))


def test_untrained_model_is_zero_and_the_loss_draws_its_noise():
    tm = td.DiT(td.DiTConfig.tiny(), device="cpu")
    x, t, y = td.synthetic_dit_batch(B, tm.config, seed=2)
    with torch.no_grad():
        assert torch.count_nonzero(tm(x, t, y)) == 0
    assert tm.config.num_params() == sum(p.numel() for p in tm.parameters())
    # without noise: a draw of the diffusion's own seeded stream
    first = td.GaussianDiffusion(seed=5).training_loss(tm, x, t, y)
    again = td.GaussianDiffusion(seed=5).training_loss(tm, x, t, y)
    other = td.GaussianDiffusion(seed=6).training_loss(tm, x, t, y)
    assert torch.equal(first, again) and not torch.equal(first, other)
    for a, b in zip(td.synthetic_dit_batch(3, tm.config, seed=9),
                    jd.synthetic_dit_batch(3, jd.DiTConfig.tiny(), seed=9)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b._value))


def test_recipe_tiny_on_cpu(capsys, tmp_path):
    path = tmp_path / "dit.pdparams"
    r = dit_train.main(["--size", "tiny", "--steps", "2", "--device", "cpu",
                        "--sample-after", "--save", str(path)])
    assert r.steps == 2 and np.isfinite(r.final_loss)
    assert r.sample.shape == (2, 4, 8, 8)
    out = capsys.readouterr().out
    assert "sampled (2, 4, 8, 8)" in out and f"saved {path}" in out
    tm = td.DiT(td.DiTConfig.tiny(), device="cpu")
    tm.load_state_dict(paddle_tpu_torch.load(str(path), device="cpu"))
    with pytest.raises(NotImplementedError, match="item 9"):
        dit_train.main(["--size", "tiny", "--device", "cpu", "--mesh",
                        "dp=4,mp=2"])
