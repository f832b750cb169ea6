"""Activation recompute in the port (`paddle_tpu_torch.distributed.fleet.
utils.recompute`, `LlamaConfig.recompute`) against the run without it and
against the JAX package's, on the CPU (mirrors tests/test_recompute.py).

- The tiny Llama carried from JAX's weights (`models.convert`): the loss
  and every gradient with recompute bitwise equal to the port's run
  without it (the same plain ops run again on the same inputs), and
  within the f32 tolerance of tests/test_torch_train.py of JAX's
  recompute run (loss rtol 1e-5; gradients atol 1e-5 plus rtol 1e-4).
- A tuple output, the input's gradient, ``accumulate_steps=2`` inside
  `TrainStep` (bitwise against the same steps without recompute), every
  JAX policy name (bitwise gradients, and which products each policy
  keeps: counted as the ops the backward runs again), and the unknown
  name's ValueError, whose message equals JAX's.
- A BERT encoder layer with dropout p = 0.1 under recompute: the same
  gradients as without, from one seeded generator (the recompute replays
  the masks; port only, since the masks never match JAX's), and other
  gradients with ``preserve_rng_state=False``.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
from paddle_tpu.distributed.fleet.utils import recompute as jrecompute
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.distributed.fleet.utils import _POLICIES, recompute
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import (llama_grads_to_numpy,
                                             llama_state_from_numpy)
from paddle_tpu_torch.nn.layers import set_generator
from paddle_tpu_torch.nn.transformer import TransformerEncoderLayer
from paddle_tpu_torch.optimizer import AdamW

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _batch(b=2, s=32, seed=0):
    ids = np.random.default_rng(seed).integers(0, 512, (b, s + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's tiny Llama with recompute: its weights, loss and gradients
    on `_batch()` (one JAX run for the module)."""
    cfg = jl.LlamaConfig.tiny()
    cfg.recompute = True
    paddle.seed(11)
    jm = jl.LlamaForCausalLM(cfg)
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    x, y = _batch()
    loss, _ = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    loss.backward()
    grads = {n: np.asarray(p.grad._value) for n, p in jm.named_parameters()}
    return sd, float(loss), grads


def _port(sd, recompute_on, policy="full"):
    cfg = tl.LlamaConfig.tiny()
    cfg.recompute, cfg.recompute_policy = recompute_on, policy
    tm = tl.LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return tm


def _loss_grads(tm, batch=None):
    x, y = batch or _batch()
    loss, _ = tm(torch.from_numpy(x), labels=torch.from_numpy(y))
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in tm.named_parameters()}


def test_llama_recompute_bitwise_and_against_jax(jax_run):
    sd, jloss, jgrads = jax_run
    l0, g0 = _loss_grads(_port(sd, False))
    tm = _port(sd, True)
    l1, g1 = _loss_grads(tm)
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    np.testing.assert_allclose(float(l1), jloss, rtol=1e-5)
    for n, g in llama_grads_to_numpy(tm).items():
        np.testing.assert_allclose(g, jgrads[n], err_msg=n, **GRAD_TOL)


def test_llama_recompute_only_in_training(jax_run):
    """Eval mode, and a forward with caches, run the layers directly (as
    JAX's branch): no checkpoint, the same logits."""
    sd = jax_run[0]
    tm = _port(sd, True).eval()
    x, _ = _batch()
    with torch.no_grad():
        a = tm(torch.from_numpy(x))
        tm.config.recompute = False
        b = tm(torch.from_numpy(x))
    assert torch.equal(a, b)


def test_trainstep_accumulate_2_with_recompute(jax_run):
    """Two AdamW `TrainStep`s at ``accumulate_steps=2``: the losses and
    every parameter bitwise equal with and without recompute."""
    sd = jax_run[0]
    x, y = _batch(b=4, seed=2)
    out = []
    for rc in (False, True):
        tm = _port(sd, rc)
        opt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
        step = TrainStep(tm, opt, loss_fn=lambda m, a, c: m(a, labels=c)[0],
                         accumulate_steps=2)
        losses = [step(torch.from_numpy(x), torch.from_numpy(y))
                  for _ in range(2)]
        out.append((torch.stack(losses),
                    [p.detach().clone() for p in tm.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


class _SmallMLP(torch.nn.Module):
    def __init__(self, h=16):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.fc1 = torch.nn.Linear(h, 4 * h)
        self.fc2 = torch.nn.Linear(4 * h, h)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)

    def forward(self, x):
        h = torch.nn.functional.gelu(self.fc1(x))
        # a batched product, which "dots_with_no_batch_dims" recomputes
        a = torch.bmm(h.view(2, -1, h.shape[-1]),
                      h.view(2, -1, h.shape[-1]).transpose(1, 2))
        return self.fc2(h) * a.tanh().mean()


class _Count(TorchDispatchMode):
    """The aten ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


# ops the backward runs again, by policy: the products each keeps
RERUN = {None: {"addmm": 2, "bmm": 1, "gelu": 1},
         "full": {"addmm": 2, "bmm": 1, "gelu": 1},
         "nothing_saveable": {"addmm": 2, "bmm": 1, "gelu": 1},
         "dots": {"addmm": 0, "bmm": 0, "gelu": 1},
         "dots_saveable": {"addmm": 0, "bmm": 0, "gelu": 1},
         "dots_with_no_batch_dims": {"addmm": 0, "bmm": 1, "gelu": 1},
         "everything_saveable": {"addmm": 0, "bmm": 0, "gelu": 0}}


@pytest.mark.parametrize("policy", list(_POLICIES),
                         ids=[str(p) for p in _POLICIES])
def test_every_policy_bitwise_and_what_it_keeps(policy):
    """Each JAX policy name: the output, the input's gradient and every
    parameter gradient bitwise equal to the plain run; the ops the
    backward runs again are the ones the policy does not keep."""
    x0 = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 16)).astype(np.float32))
    ref_mlp, mlp = _SmallMLP(), _SmallMLP()
    x_ref, x = x0.clone().requires_grad_(), x0.clone().requires_grad_()
    out_ref = ref_mlp(x_ref)
    out_ref.sum().backward()
    out = recompute(mlp, x, policy=policy)
    c = _Count()
    with c:
        out.sum().backward()
    assert torch.equal(out, out_ref)
    assert torch.equal(x.grad, x_ref.grad)
    for p, q in zip(mlp.parameters(), ref_mlp.parameters()):
        assert torch.equal(p.grad, q.grad)
    plain_bwd = _Count()
    ref2 = _SmallMLP()
    y = ref2(x0)
    with plain_bwd:
        y.sum().backward()
    for op, n in RERUN[policy].items():
        assert c.n.get(op, 0) - plain_bwd.n.get(op, 0) == n, (op, c.n)


def test_tuple_output_and_input_grad():
    lin = torch.nn.Linear(8, 8)

    def fn(a):
        y = lin(a)
        return y, y * 2
    x = torch.ones(2, 8, requires_grad=True)
    y1, y2 = recompute(fn, x)
    (y1.sum() + y2.sum()).backward()
    assert lin.weight.grad is not None and x.grad.shape == x.shape
    g = lin.weight.grad.clone()
    lin.weight.grad = None
    z1, z2 = fn(torch.ones(2, 8))
    (z1.sum() + z2.sum()).backward()
    assert torch.equal(lin.weight.grad, g)


def test_unknown_policy_raises_jax_message():
    lin = torch.nn.Linear(4, 4)
    with pytest.raises(ValueError) as port:
        recompute(lin, torch.ones(2, 4), policy="bogus")
    with pytest.raises(ValueError) as ref:
        jrecompute(lambda a: a, paddle.to_tensor(np.ones(2, np.float32)),
                   policy="bogus")
    assert str(port.value) == str(ref.value)


def _bert_layer_grads(use_recompute, preserve=True):
    layer = TransformerEncoderLayer(32, 4, 64, dropout=0.1,
                                    attn_dropout=0.1)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    layer.train()
    gen = torch.Generator().manual_seed(123)
    set_generator(layer, gen)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, 32)).astype(np.float32)).requires_grad_()
    out = recompute(layer, x, preserve_rng_state=preserve) \
        if use_recompute else layer(x)
    (out ** 2).sum().backward()
    return ([p.grad.clone() for p in layer.parameters()] + [x.grad],
            gen.get_state())


def test_bert_layer_dropout_masks_replayed():
    """Dropout p = 0.1 from one seeded generator: under recompute the
    gradients equal the plain run's bitwise and the generator ends where
    the plain run leaves it; without ``preserve_rng_state`` the
    recompute draws new masks and the gradients differ."""
    ref, ref_state = _bert_layer_grads(False)
    got, state = _bert_layer_grads(True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(state, ref_state)
    bad, _ = _bert_layer_grads(True, preserve=False)
    assert not all(torch.equal(a, b) for a, b in zip(bad, ref))
