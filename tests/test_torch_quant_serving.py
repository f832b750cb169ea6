"""Quantized serving of the PyTorch port against the JAX package, on the
CPU: `ContinuousBatchingEngine(quant=QuantServingConfig(...))` of
`paddle_tpu_torch.models.serving` (``device="cpu"``) and the quantized
branch of its Llama, on the same seeded `LlamaConfig.tiny()` weights.

- one quantized ragged dispatch (int8 weights carried from the JAX
  engine, int8 KV pages): logits and the post-scatter int8 pools and
  scales against the JAX model, logits atol/rtol 1e-4 in f32 as
  tests/test_torch_llama.py, scales within rtol 1e-6 and int8 bytes
  equal outside trash page 0 but for at most one lattice step on one
  entry (the K/V rows come out of f32 matmuls summed in another order
  than XLA's; the test states what it measured and the budget of the
  rows that read such an entry);
- the engines: EQUAL greedy streams under (int8, int8), (int8, None),
  (None, int8) and (fp8, int8), and the port's quantized weight bytes
  equal to the JAX engine's;
- bit-identity through preemption, `cache_memory_info` page bytes equal
  to JAX's, 15 quantized weights on `tiny()`, config validation, and a
  bf16 model left untouched by a quantized engine built on it."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import llama as jl
from paddle_tpu.models.generation import bind_state
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models.serving import QuantServingConfig as JQuant
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import (llama_state_from_numpy,
                                             quantized_weight_from_numpy)
from paddle_tpu_torch.models.serving import (QUANT_MATMULS,
                                             ContinuousBatchingEngine,
                                             QuantServingConfig)
from paddle_tpu_torch.ops.ragged_paged_attention import pack_ragged_batch

S = 64
LENS = (5, 20, 40, 60, 13)
NEW = (6, 9, 5, 8, 7)
TOL = dict(atol=1e-4, rtol=1e-4)
MODES = [("int8", "int8"), ("int8", None), (None, "int8"), ("fp8", "int8")]
PS, N_PAGES, PPS = 4, 24, 8


@pytest.fixture(scope="module")
def models():
    paddle.seed(5)
    jm = jl.LlamaForCausalLM(jl.LlamaConfig.tiny())
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n) for n in LENS]
    return jm, tm, prompts


def _serve(engine, prompts, new=NEW):
    for p, n in zip(prompts, new):
        engine.add_request(p, max_new_tokens=n)
    out = engine.run()
    engine.check_invariants()
    assert len(engine._free) == engine.num_pages - 1
    return out


def _port(tm, quant, **kw):
    return ContinuousBatchingEngine(tm, max_batch_size=2, max_seq_len=S,
                                    device="cpu", quant=quant, **kw)


def _jax(jm, quant, **kw):
    return JEngine(jm, max_batch_size=2, max_seq_len=S, quant=quant, **kw)


def _jax_quant_weights(jm, mode):
    """The JAX engine's quantized weights ({name: (qw (K, N), scale)})
    and its (params, values) for `bind_state`."""
    eng = _jax(jm, JQuant(weights=mode))
    names = {id(p): nm for nm, p in jm.named_parameters()}
    qws = {names[id(p)]: (np.asarray(v.qw), np.asarray(v.scale))
           for p, v in zip(eng._params, eng._qpv)
           if type(v).__name__ == "QuantizedWeight"}
    return qws, eng._params, eng._qpv


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_engine_weights_equal_jax_bytes(models, mode):
    jm, tm, _ = models
    want, _, _ = _jax_quant_weights(jm, mode)
    eng = _port(tm, QuantServingConfig(weights=mode))
    assert set(eng._qweights) == set(want)
    assert eng.quant_weight_layers == len(want) == 15     # 2 x 7 + lm_head
    for name, (qw, sc) in want.items():
        got = eng._qweights[name]
        assert got.qw.shape == qw.T.shape
        np.testing.assert_array_equal(
            got.qw.contiguous().view(torch.uint8).numpy(),
            qw.view(np.uint8).T)
        np.testing.assert_array_equal(got.scale.numpy(), sc)
    assert eng.quant_weight_bytes == sum(w.nbytes
                                         for w in eng._qweights.values())


def test_quantized_dispatch_matches_jax(models):
    """One packed ragged batch (a decode row, a prefill, a chunk
    continuation over pages pre-filled by an earlier quantized commit,
    and padding) through both models with int8 weights and int8 pages."""
    jm, tm, _ = models
    cfg = jm.config
    hk, hd, L = cfg.num_key_value_heads, cfg.head_dim, cfg.num_hidden_layers
    qws, params, qpv = _jax_quant_weights(jm, "int8")
    weights = {n: quantized_weight_from_numpy(*v) for n, v in qws.items()}
    rng = np.random.default_rng(0)
    bt = np.zeros((3, PPS), np.int32)
    bt[0, :3] = [3, 7, 1]
    bt[1, :4] = [2, 9, 10, 11]
    bt[2, :5] = [4, 5, 6, 8, 12]
    ids = lambda n: [int(x) for x in rng.integers(0, cfg.vocab_size, n)]
    # the history: sequence 0 holds 9 tokens, sequence 2 holds 8
    hist = pack_ragged_batch(
        [{"seq": 0, "tokens": ids(9), "offset": 0, "sample": True},
         {"seq": 2, "tokens": ids(8), "offset": 0, "sample": True}],
        3, block_q=8, pad_to=16)
    batch = pack_ragged_batch(
        [{"seq": 0, "tokens": ids(1), "offset": 9, "sample": True},
         {"seq": 1, "tokens": ids(13), "offset": 0, "sample": True},
         {"seq": 2, "tokens": ids(6), "offset": 8, "sample": False}],
        3, block_q=8, pad_to=16)

    jpools = [(np.zeros((hk, N_PAGES, PS, hd), np.int8),) * 2
              + (np.zeros((N_PAGES, PS), np.float32),) * 2
              for _ in range(L)]
    tpools = [(torch.zeros(hk, N_PAGES, PS, hd, dtype=torch.int8),
               torch.zeros(hk, N_PAGES, PS, hd, dtype=torch.int8),
               torch.zeros(N_PAGES, PS), torch.zeros(N_PAGES, PS))
              for _ in range(L)]
    for pk in (hist, batch):
        views = [jl.RaggedKVCacheView(
            e[0], e[1], bt, pk["token_seq"], pk["positions"],
            pk["query_start"], pk["query_len"], pk["context_len"], 8,
            k_scale=e[2], v_scale=e[3]) for e in jpools]
        with bind_state(params, [], qpv, []), paddle.no_grad():
            jlog, new = jm(Tensor(np.asarray(pk["ids"])[None]),
                           past_key_values=views, use_cache=True)
        jlog = np.asarray(jlog._value)
        jpools = [tuple(np.asarray(a._value) for a in
                        (v.k_pages, v.v_pages, v.k_scale, v.v_scale))
                  for v in new]
        t = lambda a: torch.from_numpy(np.asarray(a, np.int32))
        tviews = [tl.RaggedKVCacheView(
            *e[:2], t(bt), t(pk["token_seq"]), t(pk["positions"]),
            t(pk["query_start"]), t(pk["query_len"]), t(pk["context_len"]),
            8, None, *e[2:]) for e in tpools]
        with torch.no_grad():
            tlog = tm(t(pk["ids"])[None], tviews, weights=weights).numpy()
        assert tlog.shape == jlog.shape == (1, pk["t_pad"], cfg.vocab_size)
        # Page 0 takes the padding rows' repeated writes: unspecified.
        # The K/V rows come out of f32 matmuls summed in another order
        # than XLA's, so a row's absmax (its scale) may differ by a few
        # f32 ulps (measured: 4 of the 92 entries of one scale pool past
        # page 0, at most 3.0e-7 relative), and an element that lands on
        # a lattice midpoint may round one int8 step apart (measured: 1
        # V entry of layer 1 in the second dispatch, of the 9472 int8
        # entries the two dispatches write).
        flipped = set()
        for je, te in zip(jpools, tpools):
            for ja, ta in zip(je[:2], te[:2]):
                diff = ta.numpy()[:, 1:].astype(int) - ja[:, 1:]
                assert np.abs(diff).max() <= 1
                flipped |= {int(pg) + 1 for pg in np.nonzero(diff)[1]}
            for ja, ta in zip(je[2:], te[2:]):
                np.testing.assert_allclose(ta.numpy()[1:], ja[1:],
                                           rtol=1e-6, atol=0)
        assert len(flipped) <= 1
        # logits: 1e-4 for every row that never reads a flipped entry;
        # rows of the sequence owning a flipped page carry one int8 step
        # of one element into their attention: budget 1e-3 (measured
        # 7.2e-4)
        near = np.isin(np.asarray(pk["token_seq"]),
                       [s for s in range(3) if flipped & set(bt[s])])
        np.testing.assert_allclose(tlog[0, ~near], jlog[0, ~near], **TOL)
        np.testing.assert_allclose(tlog[0, near], jlog[0, near], atol=1e-3,
                                   rtol=0)


@pytest.mark.parametrize("wmode,kvmode", MODES,
                         ids=[f"{w}-{k}" for w, k in MODES])
def test_greedy_streams_equal_jax(models, wmode, kvmode):
    jm, tm, prompts = models
    want = _serve(_jax(jm, JQuant(wmode, kvmode), prefill_chunk=16),
                  prompts)
    got = _serve(_port(tm, QuantServingConfig(wmode, kvmode),
                       prefill_chunk=16), prompts)
    assert got == want


def test_preemption_keeps_quantized_streams(models, monkeypatch):
    """With reservation bypassed on a tight pool, lazy growth preempts
    the youngest slot, whose re-prefill re-quantizes its pages from
    scratch; per-row quantization makes its stream bit-identical to the
    uninterrupted quantized engine."""
    _, tm, prompts = models
    q8 = QuantServingConfig("int8", "int8")
    want = _serve(_port(tm, q8), prompts[:2])
    eng = _port(tm, q8, page_size=4, num_pages=9)
    monkeypatch.setattr(eng, "_reserve_ok", lambda req: True)
    got = _serve(eng, prompts[:2])
    assert eng.num_preemptions > 0
    assert got == want


@pytest.mark.parametrize("kv", [None, "int8"])
def test_page_bytes_equal_jax(models, kv):
    jm, tm, _ = models
    jq = JQuant(kv=kv) if kv else None
    tq = QuantServingConfig(kv=kv) if kv else None
    want = _jax(jm, jq).cache_memory_info()
    got = _port(tm, tq).cache_memory_info()
    for key in ("page_bytes", "kv_quant", "total_pages", "bytes_pool"):
        assert got[key] == want[key], key
    if kv:
        full = _port(tm, None).cache_memory_info()["page_bytes"]
        assert got["page_bytes"] / full < 0.5       # int8 + scale rows


def test_int8_pools_and_scale_pools(models):
    _, tm, _ = models
    eng = _port(tm, QuantServingConfig(kv="int8"))
    cfg = tm.config
    assert len(eng._kv) == cfg.num_hidden_layers
    for kp, vp, ks, vs in eng._kv:
        assert kp.dtype == vp.dtype == torch.int8
        assert ks.shape == vs.shape == (eng.num_pages, eng.page_size)
        assert ks.dtype == torch.float32


def test_config_validation_matches_jax():
    for kw, match in ((dict(weights="int4"), "int8|fp8"),
                      (dict(kv="fp8"), "int8"), (dict(), "neither")):
        with pytest.raises(ValueError, match=match):
            QuantServingConfig(**kw)
        with pytest.raises(ValueError, match=match):
            JQuant(**kw)
    assert QUANT_MATMULS == ("q_proj", "k_proj", "v_proj", "o_proj",
                             "gate_proj", "up_proj", "down_proj", "lm_head")


@pytest.mark.parametrize("layout", [dict(kv_layout="dense"),
                                    dict(attention_impl="legacy")])
def test_quant_requires_paged_ragged(models, layout):
    _, tm, _ = models
    with pytest.raises(ValueError, match="paged.*ragged"):
        _port(tm, QuantServingConfig("int8", "int8"), **layout)


def test_model_untouched_and_full_width_engine_still_serves(models):
    """The quantized engine binds its weights per dispatch; the model's
    own parameters stay as they were, so an unquantized engine on the
    same model serves the full-width streams."""
    _, tm, prompts = models
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    full = _serve(_port(tm, None), prompts[:3], NEW[:3])
    _serve(_port(tm, QuantServingConfig("int8", "int8")), prompts[:3],
           NEW[:3])
    after = tm.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert _serve(_port(tm, None), prompts[:3], NEW[:3]) == full


def test_tied_head_is_not_quantized():
    cfg = tl.LlamaConfig.tiny()
    cfg.tie_word_embeddings = True
    tm = tl.LlamaForCausalLM(cfg, device="cpu", seed=1)
    eng = _port(tm, QuantServingConfig(weights="int8"))
    assert eng.quant_weight_layers == 14
    assert not any("embed" in n or "lm_head" in n for n in eng._qweights)
    out = _serve(eng, [np.arange(1, 9)], [3])
    assert len(out[0]) == 3
