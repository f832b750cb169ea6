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
