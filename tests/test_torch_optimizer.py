"""Adam and AdamW of the PyTorch port (`paddle_tpu_torch.optimizer`)
against the JAX package's, three steps on the same gradients: f32
parameters, and bf16 parameters with ``multi_precision`` (f32 master
weights), with and without weight decay, and under
`ClipGradByGlobalNorm`. The parameters after each step must agree
within rtol 1e-6 plus atol 1e-7 in f32 (the same f32 update; the two
frameworks may fuse a multiply-add differently), and bf16 parameters
and the master weights to the bit or one bf16 ulp (the master within
the f32 tolerance, its bf16 rounding then equal up to a tie). A
`state_dict` round trip keeps the f32 master weights and moments and
the step count."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Parameter, Tensor
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch.optimizer import Adam, AdamW, ClipGradByGlobalNorm

SHAPES = [(16, 8), (32,)]


def _data(seed):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [[rng.standard_normal(s).astype(np.float32) * 0.1 for s in SHAPES]
          for _ in range(3)]
    return ws, gs


def _run_jax(cls, ws, gs, dtype, **kw):
    ps = [Parameter(jnp.asarray(w, dtype)) for w in ws]
    opt = cls(learning_rate=0.01, parameters=ps, **kw)
    out = []
    for step in gs:
        for p, g in zip(ps, step):
            p.grad = Tensor(jnp.asarray(g, dtype))
        opt.step()
        opt.clear_grad()
        out.append([np.asarray(p._value.astype(jnp.float32)) for p in ps])
    master = [np.asarray(opt._master_weights[id(p)]) for p in ps] \
        if opt._master_weights else None
    return out, master


def _run_port(cls, ws, gs, dtype, **kw):
    ps = [torch.nn.Parameter(torch.from_numpy(w.copy()).to(dtype))
          for w in ws]
    opt = cls(learning_rate=0.01, parameters=ps, **kw)
    out = []
    for step in gs:
        for p, g in zip(ps, step):
            p.grad = torch.from_numpy(g).to(dtype)
        opt.step()
        opt.zero_grad()
        out.append([p.detach().float().numpy().copy() for p in ps])
    return out, opt, ps


CONFIGS = [("adam", JAdam, Adam, {}),
           ("adam_coupled_wd", JAdam, Adam, dict(weight_decay=0.1)),
           ("adamw", JAdamW, AdamW, dict(weight_decay=0.01)),
           ("adamw_wd0", JAdamW, AdamW, dict(weight_decay=0.0))]


@pytest.mark.parametrize("config", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_f32_steps_match_jax(config):
    _, jcls, tcls, kw = config
    ws, gs = _data(1)
    jout, _ = _run_jax(jcls, ws, gs, jnp.float32, **kw)
    tout, _, _ = _run_port(tcls, ws, gs, torch.float32, **kw)
    for step, (a, b) in enumerate(zip(tout, jout)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step}")


@pytest.mark.parametrize("config", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_bf16_multi_precision_steps_match_jax(config):
    _, jcls, tcls, kw = config
    ws, gs = _data(2)
    jout, jmaster = _run_jax(jcls, ws, gs, jnp.bfloat16,
                             multi_precision=True, **kw)
    tout, opt, ps = _run_port(tcls, ws, gs, torch.bfloat16,
                              multi_precision=True, **kw)
    for a, b in zip(tout, jout):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=2 ** -8, atol=0)
    for p, m in zip(ps, jmaster):
        st = opt.state[p]
        assert st["master"].dtype == torch.float32
        assert st["moment1"].dtype == st["moment2"].dtype == torch.float32
        np.testing.assert_allclose(st["master"].numpy(), m, rtol=1e-6,
                                   atol=1e-7)


def test_global_norm_clip_matches_jax():
    ws, gs = _data(3)
    gs = [[g * 50 for g in step] for step in gs]   # the clip engages
    jout, _ = _run_jax(JAdamW, ws, gs, jnp.float32,
                       grad_clip=JClip(clip_norm=1.0))
    tout, _, _ = _run_port(AdamW, ws, gs, torch.float32,
                           grad_clip=ClipGradByGlobalNorm(1.0))
    for a, b in zip(tout[-1], jout[-1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_state_dict_round_trip_keeps_master_weights():
    ws, gs = _data(4)
    _, opt, ps = _run_port(AdamW, ws, gs[:2], torch.bfloat16,
                           multi_precision=True)
    sd = opt.state_dict()
    fresh = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    opt2 = AdamW(learning_rate=0.01, parameters=fresh,
                 multi_precision=True)
    opt2.load_state_dict(sd)
    assert opt2.state["@step"] == 2
    for p, q in zip(ps, fresh):
        for key in ("master", "moment1", "moment2"):
            assert opt2.state[q][key].dtype == torch.float32
            assert torch.equal(opt2.state[q][key], opt.state[p][key])
    # the restored optimizer takes the same third step
    for p, q, g in zip(ps, fresh, gs[2]):
        p.grad = torch.from_numpy(g).bfloat16()
        q.grad = torch.from_numpy(g).bfloat16()
    opt.step()
    opt2.step()
    for p, q in zip(ps, fresh):
        assert torch.equal(p, q)


# -- every optimizer and option (f32 within rtol 1e-6 + atol 1e-7) ----------
import paddle_tpu.nn as jnn                          # noqa: E402
import paddle_tpu.optimizer as jopt                  # noqa: E402
import paddle_tpu.optimizer.lr as jlr                # noqa: E402
import paddle_tpu_torch.nn as tnn                    # noqa: E402
import paddle_tpu_torch.optimizer as topt            # noqa: E402
import paddle_tpu_torch.optimizer.lr as tlr          # noqa: E402

# (id, class name, kwargs(nn) -> dict, steps); ``nn`` is the package's
# nn module, so each side gets its own clip instance
OPT_CASES = [
    ("sgd", "SGD", lambda nn: {}, 3),
    ("sgd_wd", "SGD", lambda nn: dict(weight_decay=0.1), 3),
    ("momentum", "Momentum", lambda nn: dict(momentum=0.9), 3),
    ("momentum_nesterov_wd", "Momentum",
     lambda nn: dict(momentum=0.8, use_nesterov=True, weight_decay=0.01), 3),
    ("adam_amsgrad", "Adam", lambda nn: dict(amsgrad=True), 3),
    ("adam_lazy_mode", "Adam", lambda nn: dict(lazy_mode=True), 3),
    ("adamw_amsgrad", "AdamW",
     lambda nn: dict(amsgrad=True, weight_decay=0.05), 3),
    ("adamw_apply_decay_param_fun", "AdamW",
     lambda nn: dict(weight_decay=0.1,
                     apply_decay_param_fun=lambda name: name is None), 3),
    ("adamw_lr_ratio_one", "AdamW",
     lambda nn: dict(lr_ratio=lambda p: 1.0), 3),
    ("adamax", "Adamax", lambda nn: {}, 3),
    ("adamax_wd", "Adamax", lambda nn: dict(weight_decay=0.01), 3),
    ("adagrad", "Adagrad", lambda nn: dict(initial_accumulator_value=0.1),
     3),
    ("adadelta", "Adadelta", lambda nn: dict(rho=0.9), 3),
    ("rmsprop", "RMSProp", lambda nn: {}, 3),
    ("rmsprop_centered_momentum", "RMSProp",
     lambda nn: dict(centered=True, momentum=0.9, weight_decay=0.01), 3),
    ("lamb", "Lamb", lambda nn: {}, 3),
    ("lamb_exclude", "Lamb",
     lambda nn: dict(exclude_from_weight_decay_fn=lambda p: p.ndim == 1),
     3),
    ("nadam", "NAdam", lambda nn: {}, 3),
    ("nadam_wd", "NAdam", lambda nn: dict(weight_decay=0.01), 3),
    ("radam", "RAdam", lambda nn: {}, 3),
    # beta2 0.9: rho_t passes 5 at step 8 (the rectified branch)
    ("radam_rectified", "RAdam", lambda nn: dict(beta2=0.9), 8),
    ("rprop", "Rprop", lambda nn: dict(etas=(0.4, 1.3)), 4),
    ("asgd", "ASGD", lambda nn: dict(batch_num=2, weight_decay=0.01), 3),
    ("sgd_clip_value", "SGD",
     lambda nn: dict(grad_clip=nn.ClipGradByValue(0.05)), 3),
    ("momentum_clip_norm", "Momentum",
     lambda nn: dict(grad_clip=nn.ClipGradByNorm(0.3)), 3),
    ("lamb_clip_global", "Lamb",
     lambda nn: dict(grad_clip=nn.ClipGradByGlobalNorm(0.5)), 3),
]


def _data_n(seed, n):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [[rng.standard_normal(s).astype(np.float32) * 0.1 for s in SHAPES]
          for _ in range(n)]
    return ws, gs


def _run_any(cls, params, set_grad, read, gs, **kw):
    opt = cls(learning_rate=0.01, parameters=params, **kw)
    out = []
    for step in gs:
        set_grad(step)
        opt.step()
        out.append(read())
    return out, opt


def _jax_run(name, ws, gs, kw, dtype=jnp.float32, groups=False):
    ps = [Parameter(jnp.asarray(w, dtype)) for w in ws]

    def set_grad(step):
        for p, g in zip(ps, step):
            p.grad = Tensor(jnp.asarray(g, dtype))
    params = [{"params": ps[:1]}, {"params": ps[1:]}] if groups else ps
    out, opt = _run_any(getattr(jopt, name), params, set_grad,
                        lambda: [np.asarray(p._value.astype(jnp.float32))
                                 for p in ps], gs, **kw)
    return out, opt, ps


def _port_run(name, ws, gs, kw, dtype=torch.float32, groups=False):
    ps = [torch.nn.Parameter(torch.from_numpy(w.copy()).to(dtype))
          for w in ws]

    def set_grad(step):
        for p, g in zip(ps, step):
            p.grad = torch.from_numpy(g).to(dtype)
    params = [{"params": ps[:1]}, {"params": ps[1:]}] if groups else ps
    out, opt = _run_any(getattr(topt, name), params, set_grad,
                        lambda: [p.detach().float().numpy().copy()
                                 for p in ps], gs, **kw)
    return out, opt, ps


def _close(tout, jout, rtol=1e-6, atol=1e-7):
    for step, (a, b) in enumerate(zip(tout, jout)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                       err_msg=f"step {step}")


@pytest.mark.parametrize("case", OPT_CASES, ids=[c[0] for c in OPT_CASES])
def test_every_optimizer_matches_jax(case):
    """The steps' parameters within rtol 1e-6 + atol 1e-7 of JAX's, and
    the JAX state dict's keys equal (accumulators, ``@step``)."""
    _, name, kw, n = case
    ws, gs = _data_n(5, n)
    jout, jo, _ = _jax_run(name, ws, gs, kw(jnn))
    tout, to, _ = _port_run(name, ws, gs, kw(tnn))
    _close(tout, jout)
    assert set(to.paddle_state_dict()) == set(jo.state_dict())
    assert to.paddle_state_dict()["@step"] == n


MASTER_OPTS = ["SGD", "Momentum", "Lamb", "NAdam", "RAdam", "Rprop", "ASGD"]


@pytest.mark.parametrize("name", MASTER_OPTS)
def test_master_weights_match_jax(name):
    """bf16 parameters with ``multi_precision``: the f32 master weights
    within the f32 tolerance of JAX's, the bf16 values within one ulp,
    and ``master_<k>`` in both state dicts."""
    ws, gs = _data_n(6, 3)
    jout, jo, jps = _jax_run(name, ws, gs, dict(multi_precision=True),
                             jnp.bfloat16)
    tout, to, tps = _port_run(name, ws, gs, dict(multi_precision=True),
                              torch.bfloat16)
    _close(tout, jout, rtol=2 ** -8, atol=0)
    for i, (p, q) in enumerate(zip(tps, jps)):
        np.testing.assert_allclose(to.state[p]["master"].numpy(),
                                   np.asarray(jo._master_weights[id(q)]),
                                   rtol=1e-6, atol=1e-7)
    assert set(to.paddle_state_dict()) == set(jo.state_dict())


def test_param_groups_set_lr_and_scheduler():
    """Param groups take the optimizer's options (JAX reads none of a
    group's); `set_lr` between steps and `set_lr_scheduler` as JAX's;
    `set_lr` under a scheduler raises."""
    ws, gs = _data_n(7, 3)

    def drive(run, sched_mod):
        out, opt, ps = run("Adam", ws, gs[:1], {}, groups=True)
        opt.set_lr(0.05)
        sched = sched_mod.StepDecay(0.02, step_size=1, gamma=0.5)
        for step in gs[1:]:
            for p, g in zip(ps, step):
                p.grad = (Tensor(jnp.asarray(g)) if isinstance(p, Parameter)
                          else torch.from_numpy(g))
            opt.step()
            opt.set_lr_scheduler(sched)
            sched.step()
        with pytest.raises(RuntimeError, match="scheduler"):
            opt.set_lr(0.1)
        return [np.asarray(p._value) if isinstance(p, Parameter)
                else p.detach().numpy() for p in ps], opt
    jw, jo = drive(_jax_run, jlr)
    tw, to = drive(_port_run, tlr)
    _close([tw], [jw])
    assert to.get_lr() == jo.get_lr()


def test_adamw_lr_ratio_scales_the_rate():
    """``lr_ratio(p)`` scales a parameter's rate (the reference's
    meaning; the JAX `AdamW` stores it unread): a ratio of 0.5 gives the
    parameters of plain AdamW at half the rate, bitwise."""
    ws, gs = _data_n(8, 3)
    half, _, _ = _port_run("AdamW", ws, gs, dict(lr_ratio=lambda p: 0.5))
    ps = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in ws]
    opt = AdamW(learning_rate=0.005, parameters=ps)
    for step in gs:
        for p, g in zip(ps, step):
            p.grad = torch.from_numpy(g)
        opt.step()
    for a, p in zip(half[-1], ps):
        np.testing.assert_array_equal(a, p.detach().numpy())


def test_named_parameters_reach_apply_decay_param_fun():
    """``(name, param)`` pairs give `apply_decay_param_fun` the names:
    the decayed parameter moves further than the exempt one would."""
    ws, gs = _data_n(9, 1)
    asked = []

    def fn(name):
        asked.append(name)
        return name == "a"
    ps = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in ws]
    opt = AdamW(learning_rate=0.01, weight_decay=0.5,
                parameters=list(zip("ab", ps)), apply_decay_param_fun=fn)
    for p, g in zip(ps, gs[0]):
        p.grad = torch.from_numpy(g)
    opt.step()
    assert asked == ["a", "b"]


def _lbfgs_loss(ps, tgt, sq):
    total = None
    for p, t in zip(ps, tgt):
        term = ((p - t) ** 2).sum() * 0.5 + (p ** 4).sum() * 0.05
        total = term if total is None else total + term
    return total * sq


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"],
                         ids=["fixed_step", "strong_wolfe"])
def test_lbfgs_closure_matches_jax(line_search):
    """Three `LBFGS.step(closure)` calls on a smooth loss: the loss each
    returns within rtol 1e-6 of JAX's, and the parameters (of unit
    scale) after each within rtol 1e-6 + atol 1e-6: the direction and
    step come from f32 dot products over all 160 elements, summed in
    another order than XLA's (an element measured 2.1e-7 off)."""
    ws, _ = _data_n(10, 0)
    tgt = [np.random.default_rng(11).standard_normal(w.shape)
           .astype(np.float32) for w in ws]
    jps = [Parameter(jnp.asarray(w)) for w in ws]
    tps = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in ws]
    jo = jopt.LBFGS(learning_rate=0.5, max_iter=4, parameters=jps,
                    line_search_fn=line_search)
    to = topt.LBFGS(learning_rate=0.5, max_iter=4, parameters=tps,
                    line_search_fn=line_search)
    jt = [paddle_to(t) for t in tgt]
    tt = [torch.from_numpy(t) for t in tgt]

    def jclosure():
        loss = _lbfgs_loss(jps, jt, 1.0)
        loss.backward()
        return loss

    def tclosure():
        loss = _lbfgs_loss(tps, tt, 1.0)
        loss.backward()
        return loss
    for _ in range(3):
        jl, tl = jo.step(jclosure), to.step(tclosure)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
        _close([[p.detach().numpy() for p in tps]],
               [[np.asarray(p._value) for p in jps]], atol=1e-6)
    with pytest.raises(ValueError, match="closure"):
        to.step()


def paddle_to(a):
    import paddle_tpu as paddle
    return paddle.to_tensor(a)


CLIP_CASES = [("value", lambda nn: nn.ClipGradByValue(0.05, -0.02)),
              ("norm", lambda nn: nn.ClipGradByNorm(0.3)),
              ("global_norm", lambda nn: nn.ClipGradByGlobalNorm(0.5))]


@pytest.mark.parametrize("case", CLIP_CASES, ids=[c[0] for c in CLIP_CASES])
def test_clips_match_jax(case):
    """Each clip on the same gradients as JAX's `_clip_grads` (f32 and
    bf16), the per-tensor norm with its 1e-6 floor (a zero gradient stays
    zero); exported from `paddle_tpu_torch.nn` as JAX exports them."""
    _, make = case
    _, gs = _data_n(12, 1)
    gs = gs[0] + [np.zeros((4,), np.float32)]
    jo = jopt.SGD(parameters=[Parameter(jnp.asarray(g)) for g in gs],
                  grad_clip=make(jnn))
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        jout = jo._clip_grads([(None, jnp.asarray(g, jdt)) for g in gs])
        tout = make(tnn)([torch.from_numpy(g).to(dt) for g in gs])
        for (_, a), b in zip(jout, tout):
            assert b.dtype == dt
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a.astype(jnp.float32)),
                                       rtol=1e-6, atol=1e-7)
    assert tnn.ClipGradByNorm is topt.ClipGradByNorm


# -- schedulers: the first 12 rates and a state-dict round trip --------------
SCHED_CASES = [
    ("NoamDecay", dict(d_model=64, warmup_steps=4)),
    ("PiecewiseDecay", dict(boundaries=[3, 6], values=[0.1, 0.05, 0.01])),
    ("NaturalExpDecay", dict(learning_rate=0.1, gamma=0.2)),
    ("InverseTimeDecay", dict(learning_rate=0.1, gamma=0.3)),
    ("PolynomialDecay", dict(learning_rate=0.1, decay_steps=5, power=2.0)),
    ("PolynomialDecay_cycle", dict(learning_rate=0.1, decay_steps=4,
                                   cycle=True)),
    ("ExponentialDecay", dict(learning_rate=0.1, gamma=0.9)),
    ("MultiStepDecay", dict(learning_rate=0.1, milestones=[2, 5, 9])),
    ("StepDecay", dict(learning_rate=0.1, step_size=3, gamma=0.5)),
    ("LambdaDecay", dict(learning_rate=0.1, lr_lambda=lambda e: 0.9 ** e)),
    ("MultiplicativeDecay", dict(learning_rate=0.1,
                                 lr_lambda=lambda e: 0.95)),
    ("LinearWarmup", dict(learning_rate=0.1, warmup_steps=4, start_lr=0.0,
                          end_lr=0.1)),
    ("LinearWarmup_scheduler", dict(warmup_steps=3, start_lr=0.01,
                                    end_lr=0.1)),
    ("CosineAnnealingDecay", dict(learning_rate=0.1, T_max=8,
                                  eta_min=0.01)),
    ("CosineAnnealingWarmRestarts", dict(learning_rate=0.1, T_0=3,
                                         T_mult=2)),
    ("ReduceOnPlateau", dict(learning_rate=0.1, patience=1, cooldown=1,
                             factor=0.5)),
    ("ReduceOnPlateau_abs_max", dict(learning_rate=0.1, mode="max",
                                     threshold_mode="abs", threshold=0.05,
                                     patience=0)),
    ("OneCycleLR", dict(max_learning_rate=0.1, total_steps=10)),
    ("OneCycleLR_linear", dict(max_learning_rate=0.1, total_steps=10,
                               anneal_strategy="linear")),
    ("CyclicLR", dict(base_learning_rate=0.01, max_learning_rate=0.1,
                      step_size_up=3)),
    ("CyclicLR_triangular2", dict(base_learning_rate=0.01,
                                  max_learning_rate=0.1, step_size_up=2,
                                  step_size_down=3, mode="triangular2")),
    ("CyclicLR_exp_range", dict(base_learning_rate=0.01,
                                max_learning_rate=0.1, step_size_up=2,
                                mode="exp_range", exp_gamma=0.9)),
    ("LinearLR", dict(learning_rate=0.1, total_steps=6)),
    ("CosineAnnealingWithWarmupDecay", dict(max_lr=0.1, min_lr=0.01,
                                            warmup_step=3, decay_step=9)),
]
# the metric ReduceOnPlateau is stepped with
PLATEAU = [1.0, 0.9, 0.95, 0.97, 0.96, 0.8, 0.85, 0.86, 0.87, 0.7, 0.71,
           0.72]


def _sched(mod, case):
    name, kw = case
    cls = getattr(mod, name.split("_")[0] if name.split("_")[0] in vars(mod)
                  else name)
    if name == "LinearWarmup_scheduler":
        kw = dict(kw, learning_rate=mod.ExponentialDecay(0.1, gamma=0.8))
    return cls(**kw)


def _rates(s, name):
    out = []
    for i in range(12):
        out.append(s())
        if name.startswith("ReduceOnPlateau"):
            s.step(PLATEAU[i] if "max" not in name else -PLATEAU[i])
        else:
            s.step()
    return out


@pytest.mark.parametrize("case", SCHED_CASES, ids=[c[0] for c in SCHED_CASES])
def test_scheduler_rates_and_state_dict_match_jax(case):
    """The first 12 rates equal JAX's to the last bit of a Python float
    (both compute in Python floats), the state dict has JAX's keys, and
    a fresh scheduler given it continues with the same rates."""
    js, ts = _sched(jlr, case), _sched(tlr, case)
    assert _rates(ts, case[0]) == _rates(js, case[0])
    sd = ts.state_dict()
    assert set(sd) == set(js.state_dict())
    fresh = _sched(tlr, case)
    fresh.set_state_dict(sd)
    assert _rates(fresh, case[0]) == _rates(ts, case[0])


def test_scheduler_verbose_prints(capsys):
    """``verbose`` prints each new rate, as JAX's."""
    s = tlr.StepDecay(0.1, step_size=1, gamma=0.5, verbose=True)
    s.step()
    assert "Epoch 1: lr set to 0.05" in capsys.readouterr().out
