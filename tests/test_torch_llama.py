"""The port's Llama (`paddle_tpu_torch.models.llama`) against the JAX
package's: `LlamaConfig.tiny()` built in JAX from a seed, its weights
carried with `llama_state_from_numpy`, and one packed ragged batch
(a decode row, a full prefill and a chunk continuation over pre-filled
pages, plus padding) followed by the next decode dispatch through both
models. Logits and the page pools the batch writes must agree within
atol 1e-4 / rtol 1e-4 in f32."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import llama as jl
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.ops.ragged_paged_attention import pack_ragged_batch

TOL = dict(atol=1e-4, rtol=1e-4)
PS, N_PAGES, PPS = 4, 24, 8


@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig.tiny())
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm, sd


def _jax_forward(jm, pools, bt, pk, block_q):
    views = [jl.RaggedKVCacheView(k, v, bt, pk["token_seq"],
                                  pk["positions"], pk["query_start"],
                                  pk["query_len"], pk["context_len"],
                                  block_q) for k, v in pools]
    with paddle.no_grad():
        logits, new = jm(Tensor(np.asarray(pk["ids"])[None]),
                         past_key_values=views, use_cache=True)
    return (np.asarray(logits._value),
            [(np.asarray(v.k_pages._value), np.asarray(v.v_pages._value))
             for v in new])


def _torch_forward(tm, pools, bt, pk, block_q):
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    tpools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
              for k, v in pools]
    views = [tl.RaggedKVCacheView(k, v, t(bt), t(pk["token_seq"]),
                                  t(pk["positions"]), t(pk["query_start"]),
                                  t(pk["query_len"]), t(pk["context_len"]),
                                  block_q) for k, v in tpools]
    with torch.no_grad():
        logits = tm(t(pk["ids"])[None], views)
    return logits.numpy(), [(k.numpy(), v.numpy()) for k, v in tpools]


def test_ragged_batch_then_decode_match_jax(models):
    jm, tm, _ = models
    cfg = jm.config
    rng = np.random.default_rng(0)
    hk, hd = cfg.num_key_value_heads, cfg.head_dim
    # pools already hold the earlier context of seq 0 (decode at 9) and
    # seq 2 (continuation from position 8)
    pools = [tuple(rng.standard_normal((hk, N_PAGES, PS, hd))
                   .astype(np.float32) for _ in range(2))
             for _ in range(cfg.num_hidden_layers)]
    bt = np.zeros((3, PPS), np.int32)
    bt[0, :3] = [3, 7, 1]
    bt[1, :4] = [2, 9, 10, 11]
    bt[2, :5] = [4, 5, 6, 8, 12]
    ids = lambda n: [int(x) for x in rng.integers(0, cfg.vocab_size, n)]
    pieces = [{"seq": 0, "tokens": ids(1), "offset": 9, "sample": True},
              {"seq": 1, "tokens": ids(13), "offset": 0, "sample": True},
              {"seq": 2, "tokens": ids(6), "offset": 8, "sample": False}]
    pk = pack_ragged_batch(pieces, 3, block_q=8, pad_to=16)
    jlog, jpools = _jax_forward(jm, pools, bt, pk, 8)
    tlog, tpools = _torch_forward(tm, pools, bt, pk, 8)
    assert tlog.shape == jlog.shape == (1, pk["t_pad"], cfg.vocab_size)
    np.testing.assert_allclose(tlog, jlog, **TOL)
    for (jk, jv), (tk, tv) in zip(jpools, tpools):
        # page 0 takes the padding rows' repeated writes: unspecified
        np.testing.assert_allclose(tk[:, 1:], jk[:, 1:], **TOL)
        np.testing.assert_allclose(tv[:, 1:], jv[:, 1:], **TOL)

    # the next decode dispatch: one row per sequence at block_q = 1
    nxt = jlog[0].argmax(-1)
    last = [int(pk["query_start"][s] + pk["query_len"][s] - 1)
            for s in range(3)]                 # each sequence's last row
    ctx = pk["context_len"]
    dec = {"ids": nxt[last].astype(np.int32),
           "token_seq": np.arange(3, dtype=np.int32),
           "positions": ctx.astype(np.int32),
           "query_start": np.arange(3, dtype=np.int32),
           "query_len": np.ones(3, np.int32),
           "context_len": (ctx + 1).astype(np.int32)}
    jlog2, jpools2 = _jax_forward(jm, jpools, bt, dec, 1)
    tlog2, tpools2 = _torch_forward(tm, jpools, bt, dec, 1)
    np.testing.assert_allclose(tlog2, jlog2, **TOL)
    for (jk, jv), (tk, tv) in zip(jpools2, tpools2):
        np.testing.assert_allclose(tk, jk, **TOL)
        np.testing.assert_allclose(tv, jv, **TOL)


def test_rows_selects_logits(models):
    _, tm, _ = models
    cfg = tm.config
    pools = [(torch.zeros(cfg.num_key_value_heads, 4, PS, cfg.head_dim),
              torch.zeros(cfg.num_key_value_heads, 4, PS, cfg.head_dim))
             for _ in range(cfg.num_hidden_layers)]
    pk = pack_ragged_batch([{"seq": 0, "tokens": [1, 2, 3, 4, 5],
                             "offset": 0}], 1, block_q=8)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    bt = t(np.array([[1, 2, 0, 0]]))

    def views():
        return [tl.RaggedKVCacheView(k, v, bt, t(pk["token_seq"]),
                                     t(pk["positions"]),
                                     t(pk["query_start"]),
                                     t(pk["query_len"]),
                                     t(pk["context_len"]), 8)
                for k, v in pools]
    with torch.no_grad():
        full = tm(t(pk["ids"])[None], views())
        some = tm(t(pk["ids"])[None], views(), rows=t([4, 0]))
    torch.testing.assert_close(some, full[0, [4, 0]])


def test_rope_tables_match_jax():
    cos_j, sin_j = jl.precompute_rope(16, 64, 500000.0)
    cos_t, sin_t = tl.precompute_rope(16, 64, 500000.0)
    assert np.array_equal(cos_t.numpy(), np.asarray(cos_j._value))
    assert np.array_equal(sin_t.numpy(), np.asarray(sin_j._value))


def test_bf16_model_rotates_with_bf16_tables(models):
    """`LlamaForCausalLM(dtype=bf16)` keeps the JAX `Layer.to(dtype=
    "bfloat16")` parity: the rope buffers are cast too."""
    jm, _, _ = models
    jb = jl.LlamaForCausalLM(jl.LlamaConfig.tiny()).to(dtype="bfloat16")
    tb = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), device="cpu",
                             dtype=torch.bfloat16)
    assert tb.model.rope_cos.dtype == torch.bfloat16
    want = np.asarray(jb.model.rope_cos._value.astype("float32"))
    assert np.array_equal(tb.model.rope_cos.float().numpy(), want)
    assert all(p.dtype == torch.bfloat16 for p in tb.parameters())


def test_rope_rotation_matches_jax():
    import jax.numpy as jnp
    from paddle_tpu.ops.rope import rope_rotate_values as jrot
    from paddle_tpu_torch.ops.rope import rope_rotate_values as trot
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 3, 8)).astype(np.float32)
    c = rng.standard_normal((5, 1, 4)).astype(np.float32)
    s = rng.standard_normal((5, 1, 4)).astype(np.float32)
    want = np.asarray(jrot(jnp.asarray(x), jnp.asarray(c), jnp.asarray(s)))
    got = trot(torch.from_numpy(x), torch.from_numpy(c),
               torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_linear_weights_are_transposed(models):
    _, tm, sd = models
    w = sd["model.layers.0.self_attn.k_proj.weight"]      # (in, out)
    got = tm.model.layers[0].self_attn.k_proj.weight
    assert tuple(got.shape) == w.T.shape
    assert np.array_equal(got.detach().numpy(), w.T)


@pytest.mark.parametrize("edit", ["missing", "unexpected", "shape"])
def test_carry_rejects_bad_state(models, edit):
    _, tm, sd = models
    bad = dict(sd)
    if edit == "missing":
        del bad["model.layers.1.mlp.up_proj.weight"]
    elif edit == "unexpected":
        bad["model.layers.0.self_attn.q_norm.weight"] = np.ones(4)
    else:
        bad["model.norm.weight"] = np.ones(7, np.float32)
    with pytest.raises(ValueError):
        llama_state_from_numpy(bad)
    with pytest.raises(ValueError):
        llama_state_from_numpy(bad, tm)
