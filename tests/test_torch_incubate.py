"""The port's fused-op surface (`paddle_tpu_torch.incubate.nn`, the
attention functionals of `nn.functional`) against the JAX package's on
the CPU: each composition of `incubate.nn.functional` and each `Fused*`
layer at dropout 0 (weights carried by
`models.convert.fused_layer_state_from_numpy`), forward and every
gradient; `F.layer_norm` without a weight or a bias;
`masked_multihead_attention` with scalar and (B,) lengths, a key mask
and a window; `sequence_mask`; attention at DiT-XL/2's head dim 72; the
check that decides, before launch, which head dims and dtypes the flash
kernels take; and `ops.kernel_route`, which sends a tensor by its
device.

Inputs from numpy seeds, f32. Tolerances: outputs rtol 1e-5 plus atol
1e-5 (the same f32 math; JAX attends through `_sdpa_xla` on the CPU and
the port through the plain version of its flash kernel, which round the
softmax in another order); gradients atol 1e-5 plus rtol 1e-4 (sums over
the batch in another order), as tests/test_torch_bert.py."""
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn as jinn
import paddle_tpu.incubate.nn.functional as JIF
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.incubate.nn as tinn
import paddle_tpu_torch.incubate.nn.functional as TIF
from paddle_tpu_torch.models.convert import (fused_layer_grads_to_numpy,
                                             fused_layer_state_from_numpy)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops import kernel_route

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jt(x):
    return paddle.to_tensor(x, stop_gradient=False)


def _tt(x):
    return torch.from_numpy(x).requires_grad_()


def _jnp(t):
    return np.asarray(t._value)


def _both(jfn, tfn, arrays, g):
    """Run the JAX and the port function on the same arrays; compare the
    outputs and the gradients of sum(out * g) in every array."""
    jin = [_jt(a) for a in arrays]
    tin = [_tt(a) for a in arrays]
    jo = jfn(*jin)
    (jo * paddle.to_tensor(g)).sum().backward()
    to = tfn(*tin)
    to.backward(torch.from_numpy(g))
    np.testing.assert_allclose(to.detach().numpy(), _jnp(jo), **OUT_TOL)
    for i, (a, b) in enumerate(zip(tin, jin)):
        np.testing.assert_allclose(a.grad.numpy(), _jnp(b.grad),
                                   err_msg=f"grad of input {i}", **GRAD_TOL)


@pytest.mark.parametrize("which", ["none", "weight", "bias", "both"])
def test_layer_norm_without_weight_or_bias_matches_jax(which):
    x, g = _rand(0, 3, 5, 48), _rand(1, 3, 5, 48)
    w, b = 1 + 0.1 * _rand(2, 48), 0.1 * _rand(3, 48)
    arrays = [x] + ([w] if which in ("weight", "both") else []) \
        + ([b] if which in ("bias", "both") else [])

    def call(mod, xx, *wb):
        ww = wb[0] if which in ("weight", "both") else None
        bb = wb[-1] if which in ("bias", "both") else None
        return mod.layer_norm(xx, [48], ww, bb, 1e-5)
    _both(lambda *a: call(JF, *a), lambda *a: call(TF, *a), arrays, g)


@pytest.mark.parametrize("ln", [False, True], ids=["no_ln_scale", "ln"])
def test_fused_bias_dropout_residual_layer_norm_matches_jax(ln):
    x, r, g = _rand(0, 2, 7, 32), _rand(1, 2, 7, 32), _rand(2, 2, 7, 32)
    bias, s, b = _rand(3, 32), 1 + 0.1 * _rand(4, 32), 0.1 * _rand(5, 32)
    arrays = [x, r, bias] + ([s, b] if ln else [])

    def call(mod, xx, rr, bb, *sb):
        return mod.fused_bias_dropout_residual_layer_norm(
            xx, rr, bias=bb, ln_scale=sb[0] if sb else None,
            ln_bias=sb[1] if sb else None, dropout_rate=0.0)
    _both(lambda *a: call(JIF, *a), lambda *a: call(TIF, *a), arrays, g)


@pytest.mark.parametrize("mask", [False, True], ids=["flash", "key_mask"])
@pytest.mark.parametrize("transpose", [False, True],
                         ids=["qkv_3hde", "qkv_e3e"])
@pytest.mark.parametrize("pre_ln", [False, True], ids=["post_ln", "pre_ln"])
def test_fused_multi_head_attention_matches_jax(pre_ln, transpose, mask):
    b, s, e, h = 2, 12, 32, 4
    x, g = _rand(0, b, s, e), _rand(1, b, s, e)
    if transpose:
        qkv_w, qkv_b = 0.2 * _rand(2, e, 3 * e), 0.1 * _rand(3, 3 * e)
    else:
        qkv_w = 0.2 * _rand(2, 3, h, e // h, e)
        qkv_b = 0.1 * _rand(3, 3, h, e // h)
    lin_w, lin_b = 0.2 * _rand(4, e, e), 0.1 * _rand(5, e)
    sc, sb = 1 + 0.1 * _rand(6, e), 0.1 * _rand(7, e)
    keep = np.ones((b, 1, 1, s), bool)
    keep[1, ..., 9:] = False
    arrays = [x, qkv_w, qkv_b, lin_w, lin_b, sc, sb]

    def call(mod, to_mask, xx, qw, qb, lw, lb, ss, bb):
        ln = dict(pre_ln_scale=ss, pre_ln_bias=bb) if pre_ln else \
            dict(ln_scale=ss, ln_bias=bb)
        return mod.fused_multi_head_attention(
            xx, qw, lw, pre_layer_norm=pre_ln, qkv_bias=qb, linear_bias=lb,
            attn_mask=to_mask(keep) if mask else None, dropout_rate=0.0,
            attn_dropout_rate=0.0, num_heads=h, transpose_qkv_wb=transpose,
            **ln)
    _both(lambda *a: call(JIF, paddle.to_tensor, *a),
          lambda *a: call(TIF, torch.from_numpy, *a), arrays, g)


def test_fused_multi_head_attention_cache_kv_raises():
    x = torch.zeros(1, 2, 8)
    with pytest.raises(NotImplementedError, match="cache_kv"):
        TIF.fused_multi_head_attention(x, torch.zeros(3, 2, 4, 8),
                                       torch.zeros(8, 8), cache_kv=x)


@pytest.mark.parametrize("split", [False, True], ids=["x_y", "fused_gate"])
def test_swiglu_matches_jax(split):
    x, y, g = _rand(0, 3, 16), _rand(1, 3, 16), _rand(2, 3, 8 if split
                                                       else 16)
    if split:
        _both(JIF.swiglu, TIF.swiglu, [x], g)
    else:
        _both(JIF.swiglu, TIF.swiglu, [x, y], g)


@pytest.mark.parametrize("transpose", [False, True])
def test_fused_linear_matches_jax(transpose):
    x, g = _rand(0, 2, 5, 12), _rand(1, 2, 5, 7)
    w = _rand(2, 7, 12) if transpose else _rand(2, 12, 7)
    b = _rand(3, 7)

    def call(mod, xx, ww, bb):
        return mod.fused_linear(xx, ww, bb, transpose_weight=transpose)
    _both(lambda *a: call(JIF, *a), lambda *a: call(TIF, *a), [x, w, b], g)


@pytest.mark.parametrize("act", ["gelu", "relu", "none"])
@pytest.mark.parametrize("trans", [(False, False), (True, True)],
                         ids=["nn", "tt"])
def test_fused_linear_activation_matches_jax(trans, act):
    tx, ty = trans
    x = _rand(0, 12, 6) if tx else _rand(0, 6, 12)
    y = _rand(1, 9, 12) if ty else _rand(1, 12, 9)
    b, g = _rand(2, 9), _rand(3, 6, 9)

    def call(mod, xx, yy, bb):
        return mod.fused_linear_activation(xx, yy, bb, trans_x=tx,
                                           trans_y=ty, activation=act)
    _both(lambda *a: call(JIF, *a), lambda *a: call(TIF, *a), [x, y, b], g)
    with pytest.raises(ValueError, match="unsupported activation"):
        TIF.fused_linear_activation(torch.zeros(2, 2), torch.zeros(2, 2),
                                    torch.zeros(2), activation="tanh")


# (label, JAX constructor, port constructor, input shapes)
LAYERS = [
    ("linear", lambda: jinn.FusedLinear(12, 7),
     lambda: tinn.FusedLinear(12, 7, device="cpu"), [(2, 5, 12)]),
    ("linear_t", lambda: jinn.FusedLinear(12, 7, transpose_weight=True),
     lambda: tinn.FusedLinear(12, 7, transpose_weight=True, device="cpu"),
     [(2, 5, 12)]),
    ("dropout_add", lambda: jinn.FusedDropoutAdd(p=0.0),
     lambda: tinn.FusedDropoutAdd(p=0.0), [(2, 5, 12), (2, 5, 12)]),
    ("bias_dropout_residual_ln",
     lambda: jinn.FusedBiasDropoutResidualLayerNorm(24, dropout_rate=0.0),
     lambda: tinn.FusedBiasDropoutResidualLayerNorm(24, dropout_rate=0.0,
                                                    device="cpu"),
     [(2, 6, 24), (2, 6, 24)]),
    ("mha_post_ln", lambda: jinn.FusedMultiHeadAttention(
        32, 4, dropout_rate=0.0, attn_dropout_rate=0.0),
     lambda: tinn.FusedMultiHeadAttention(32, 4, dropout_rate=0.0,
                                          attn_dropout_rate=0.0,
                                          device="cpu"), [(2, 9, 32)]),
    ("mha_pre_ln", lambda: jinn.FusedMultiHeadAttention(
        32, 4, dropout_rate=0.0, attn_dropout_rate=0.0,
        normalize_before=True),
     lambda: tinn.FusedMultiHeadAttention(32, 4, dropout_rate=0.0,
                                          attn_dropout_rate=0.0,
                                          normalize_before=True,
                                          device="cpu"), [(2, 9, 32)]),
    ("ffn_relu", lambda: jinn.FusedFeedForward(24, 40, dropout_rate=0.0),
     lambda: tinn.FusedFeedForward(24, 40, dropout_rate=0.0, device="cpu"),
     [(2, 5, 24)]),
    ("ffn_gelu_pre_ln", lambda: jinn.FusedFeedForward(
        24, 40, dropout_rate=0.0, activation="gelu", normalize_before=True),
     lambda: tinn.FusedFeedForward(24, 40, dropout_rate=0.0,
                                   activation="gelu", normalize_before=True,
                                   device="cpu"), [(2, 5, 24)]),
    ("encoder_layer", lambda: jinn.FusedTransformerEncoderLayer(
        32, 4, 48, dropout_rate=0.0),
     lambda: tinn.FusedTransformerEncoderLayer(32, 4, 48, dropout_rate=0.0,
                                               device="cpu"), [(2, 9, 32)]),
    ("rms_norm", lambda: jinn.FusedRMSNorm(64),
     lambda: tinn.FusedRMSNorm(64, device="cpu"), [(4, 8, 64)]),
]


@pytest.mark.parametrize("case", LAYERS, ids=[c[0] for c in LAYERS])
def test_fused_layers_match_jax(case):
    label, jbuild, tbuild, shapes = case
    paddle.seed(3)
    jl, tl = jbuild(), tbuild()
    sd = {k: _jnp(v) for k, v in jl.state_dict().items()}
    if sd:
        # perturb the constant-initialised biases and scales so that
        # their gradients and uses are seen
        sd = {k: v + 0.05 * _rand(len(k), *v.shape) for k, v in sd.items()}
        jl.set_state_dict({k: paddle.to_tensor(v) for k, v in sd.items()})
        tl.load_state_dict(fused_layer_state_from_numpy(sd, tl))
    xs = [_rand(10 + i, *s) for i, s in enumerate(shapes)]
    jx, tx = [_jt(x) for x in xs], [_tt(x) for x in xs]
    jo, to = jl(*jx), tl(*tx)
    g = _rand(20, *to.shape)
    (jo * paddle.to_tensor(g)).sum().backward()
    to.backward(torch.from_numpy(g))
    np.testing.assert_allclose(to.detach().numpy(), _jnp(jo), **OUT_TOL)
    for a, b in zip(tx, jx):
        np.testing.assert_allclose(a.grad.numpy(), _jnp(b.grad), **GRAD_TOL)
    jgrads = {n: _jnp(p.grad) for n, p in jl.named_parameters()
              if p.grad is not None}
    tgrads = fused_layer_grads_to_numpy(tl)
    assert sorted(tgrads) == sorted(jgrads)
    for name, gj in jgrads.items():
        np.testing.assert_allclose(tgrads[name], gj, err_msg=name,
                                   **GRAD_TOL)


def test_fused_layer_state_from_numpy_checks_names_and_shapes():
    tl = tinn.FusedFeedForward(8, 16, device="cpu")
    sd = {k: v.detach().numpy() for k, v in tl.state_dict().items()}
    with pytest.raises(ValueError, match="missing"):
        fused_layer_state_from_numpy(
            {k: v for k, v in sd.items() if k != "ln_bias"}, tl)
    bad = dict(sd, linear1_weight=np.zeros((16, 8), np.float32))
    with pytest.raises(ValueError, match="shape mismatch"):
        fused_layer_state_from_numpy(bad, tl)


def test_fused_layers_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        tinn.FusedRMSNorm(8)


def test_dropout_modes_and_generator():
    x = torch.ones(4000)
    gen = torch.Generator().manual_seed(0)
    up = TF.dropout(x, 0.25, True, gen)
    assert set(up.unique().tolist()) == {0.0, float(np.float32(1 / 0.75))}
    down = TF.dropout(x, 0.25, True, gen, mode="downscale_in_infer")
    assert set(down.unique().tolist()) == {0.0, 1.0}
    assert abs(float((down == 0).float().mean()) - 0.25) < 0.03
    torch.testing.assert_close(
        TF.dropout(x, 0.25, False, mode="downscale_in_infer"), x * 0.75)
    assert TF.dropout(x, 0.25, False) is x
    layer = tinn.FusedDropoutAdd(p=0.5, generator=gen)
    assert bool((layer(x, x) != 2.0).any())
    layer.eval()
    torch.testing.assert_close(layer(x, x), 2 * x)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("mask", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("lens", ["scalar", "per_seq"])
@pytest.mark.parametrize("s", [1, 3])
def test_masked_multihead_attention_matches_jax(s, lens, mask, window):
    b, t, h, hk, d = 3, 10, 4, 2, 16
    q, kc, vc = _rand(0, b, s, h, d), _rand(1, b, t, hk, d), \
        _rand(2, b, t, hk, d)
    sl = 8 if lens == "scalar" else np.array([8, 5, 10], np.int32)
    am = None
    if mask:
        am = np.ones((b, t), bool)
        am[:, :2] = False                       # left padding
    jo = JF.masked_multihead_attention(
        paddle.to_tensor(q), paddle.to_tensor(kc), paddle.to_tensor(vc),
        sl if lens == "scalar" else paddle.to_tensor(sl),
        attn_mask=am, window_size=window)
    to = TF.masked_multihead_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        sl if lens == "scalar" else torch.from_numpy(sl),
        attn_mask=None if am is None else torch.from_numpy(am),
        window_size=window)
    np.testing.assert_allclose(to.numpy(), _jnp(jo), **OUT_TOL)


def test_sequence_mask_matches_jax():
    lens = np.array([[3, 0], [5, 2]], np.int64)
    for maxlen in (None, 7):
        jm = JF.sequence_mask(paddle.to_tensor(lens), maxlen=maxlen)
        tm = TF.sequence_mask(torch.from_numpy(lens), maxlen=maxlen)
        assert tm.dtype == torch.int64
        np.testing.assert_array_equal(tm.numpy(), _jnp(jm))


@pytest.mark.parametrize("causal", [False, True])
def test_dit_head_dim_72_attention_matches_jax(causal):
    """DiT-XL/2's head dim (1152 / 16 = 72) through
    `F.scaled_dot_product_attention`: the plain version here; on the card
    the flash kernels take it, zero-padded to 80."""
    b, s, h, d = 2, 33, 3, 72
    q, k, v, g = (_rand(i, b, s, h, d) for i in range(4))
    _both(lambda *a: JF.scaled_dot_product_attention(*a, is_causal=causal),
          lambda *a: TF.scaled_dot_product_attention(*a, is_causal=causal),
          [q, k, v], g)
    _assert_flash_takes(torch.zeros(1, 1, 1, d))


def test_incubate_aliases_match_jax():
    q, k, v = _rand(0, 1, 40, 4, 16), _rand(1, 1, 40, 2, 16), \
        _rand(2, 1, 40, 2, 16)
    jo = JIF.flash_attention(paddle.to_tensor(q), paddle.to_tensor(k),
                             paddle.to_tensor(v), causal=True)
    to = TIF.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(to.numpy(), _jnp(jo), **OUT_TOL)
    seg = np.zeros((1, 40), np.int32)
    seg[:, 25:] = 1
    jo = JIF.flash_attention_varlen(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        paddle.to_tensor(seg), paddle.to_tensor(seg), causal=True)
    to = TIF.flash_attention_varlen(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), seg, seg,
                                    causal=True)
    np.testing.assert_allclose(to.numpy(), _jnp(jo), **OUT_TOL)
    x, w, b = _rand(3, 6, 32), 1 + 0.1 * _rand(4, 32), 0.1 * _rand(5, 32)
    np.testing.assert_allclose(
        TIF.fused_rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        _jnp(JIF.fused_rms_norm(paddle.to_tensor(x), paddle.to_tensor(w))),
        **OUT_TOL)
    np.testing.assert_allclose(
        TIF.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b)).numpy(),
        _jnp(JIF.fused_layer_norm(paddle.to_tensor(x), paddle.to_tensor(w),
                                  paddle.to_tensor(b))), **OUT_TOL)
    from paddle_tpu_torch.ops.paged_attention import paged_attention_values
    from paddle_tpu_torch.ops.rope import fused_rotary_position_embedding
    assert TIF.paged_attention is paged_attention_values
    assert TIF.fused_rotary_position_embedding is \
        fused_rotary_position_embedding


def _assert_flash_takes(t):
    """`_check` passes t's dtype and head dim and refuses only its
    device (a CPU tensor): the kernels would take it on the card."""
    with pytest.raises(ValueError, match="CUDA device"):
        tfa._check(t, t, t)


@pytest.mark.parametrize("d,dtype,takes", [
    (8, torch.bfloat16, True), (16, torch.bfloat16, True),
    (72, torch.bfloat16, True), (80, torch.float16, True),
    (96, torch.float32, True), (128, torch.float16, True),
    (48, torch.bfloat16, True), (136, torch.bfloat16, True),
    (256, torch.bfloat16, True), (100, torch.float32, True),
    (100, torch.bfloat16, True), (36, torch.float16, True),
    (264, torch.float32, False), (320, torch.float32, False),
    (64, torch.float64, False)])
def test_flash_kernels_take_head_dims_and_dtypes(d, dtype, takes):
    """Which inputs the flash kernels take, decided from dtype and head
    dim before launch: any D up to 256 (the reference's limit; past it
    `flash_attention_values` takes `attention_xla` and never reaches the
    kernels), in f32, bf16 or f16; others raise."""
    t = torch.zeros(1, 2, 2, d, dtype=dtype)
    if takes:
        _assert_flash_takes(t)
    else:
        with pytest.raises((ValueError, TypeError),
                           match="head dims|float32, bfloat16"):
            tfa._check(t, t, t)
    other = t.float() if dtype != torch.float32 else t.half()
    with pytest.raises((ValueError, TypeError)):
        tfa._check(t, other, t)


def test_kernel_route_follows_the_device():
    """A CUDA tensor launches the kernel, a CPU tensor runs the plain
    version; ``use_kernel`` False forces the plain version, True demands
    the kernel and raises for a CPU tensor."""
    cuda_like = types.SimpleNamespace(is_cuda=True)
    cpu = torch.zeros(1)
    assert kernel_route(cuda_like, None) is True
    assert kernel_route(cpu, None) is False
    assert kernel_route(cuda_like, False) is False
    assert kernel_route(cpu, False) is False
    assert kernel_route(cuda_like, True) is True
    with pytest.raises(ValueError, match="CUDA"):
        kernel_route(cpu, True)
