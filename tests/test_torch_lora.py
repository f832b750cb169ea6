"""Multi-LoRA serving of the PyTorch port against the JAX package, on the
CPU: `ops.lora_epilogue` and the adapter half of
`ContinuousBatchingEngine` (``device="cpu"``), on the small Llama of
tests/test_multimodel.py (vocab 64, hidden 32, 2 layers) with the same
seeded weights and the same numpy deltas (A (K, r), B (r, N), the JAX
convention in both packages).

- `lora_epilogue_ref` against the JAX `lora_epilogue_values` in
  interpret mode (``use_kernel=True``; at K = 32, N = 64 the JAX package
  routes to XLA) within 1e-5, and against a NumPy f64 oracle within 1e-4
  (f32 sums in another order, as tests/test_multimodel.py states);
  row 0 exact zero; rank padding bit-exact; the ``y=`` accumulate form;
- engines: base and adapter requests mixed in ONE engine give the JAX
  engine's greedy streams, full width and over an int8 base, with an
  adapter on the vocab head too; the mixed streams equal dedicated port
  engines' exactly; adapter stack bytes equal JAX's;
- refusals, transactional installs and `check_invariants` through
  install, evict, reinstall into a freed row, `install_weights` (JAX's
  streams under the swapped checkpoint) and `reset_weights`."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models.serving import QuantServingConfig as JQuant
from paddle_tpu.ops.lora_epilogue import lora_epilogue_values as jax_lora
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                             EngineInvariantError,
                                             ModelMismatch,
                                             QuantServingConfig, SpecConfig)
from paddle_tpu_torch.ops.lora_epilogue import (LoraWeight,
                                                lora_epilogue_ref,
                                                lora_epilogue_values,
                                                lora_matmul_values)

TARGETS = ("model.layers.0.self_attn.q_proj.weight",
           "model.layers.1.mlp.gate_proj.weight")
HEAD = TARGETS + ("lm_head.weight",)
PROMPTS = {"base": [[5, 4, 3, 2], [9, 1, 2]],
           "a1": [[7, 7, 1, 2], [3, 3, 9]],
           "a2": [[2, 8, 8], [6, 1, 4, 4]]}
SEEDS = {"a1": 1, "a2": 2}


def _cfg_kw():
    return dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=2,
                num_key_value_heads=1, max_position_embeddings=64)


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = JLlama(JConfig(**_cfg_kw()))
    jm.eval()
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig(**_cfg_kw()), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm, sd


def _deltas(sd, seed, rank=4, scale=0.5, targets=TARGETS):
    """tests/test_multimodel.py `_deltas`: rank-`rank` deltas over the
    (K, N) shapes of the JAX state dict, big enough to change streams."""
    rng = np.random.default_rng(seed)
    out = {}
    for nm in targets:
        k, n = sd[nm].shape
        out[nm] = (rng.normal(size=(k, rank)).astype(np.float32) * scale,
                   rng.normal(size=(rank, n)).astype(np.float32) * scale)
    return out


def _port(tm, slots=6, **kw):
    return ContinuousBatchingEngine(tm, max_batch_size=slots, max_seq_len=64,
                                    page_size=4, device="cpu", **kw)


def _jax(jm, slots=6, **kw):
    return JEngine(jm, max_batch_size=slots, max_seq_len=64, page_size=4,
                   **kw)


def _serve_mixed(eng, tags=("base", "a1", "a2"), new=8):
    rids = {}
    for tag in tags:
        for i, p in enumerate(PROMPTS[tag]):
            rids[f"{tag}-{i}"] = eng.add_request(
                p, new, request_id=f"{tag}-{i}",
                adapter=None if tag == "base" else tag)
    out = eng.run()
    eng.check_invariants()
    return {key: out[rid] for key, rid in rids.items()}


# -- the epilogue ------------------------------------------------------
def _operands(t=16, k=128, n=128, r=8, stacks=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, k)).astype(np.float32)
    a = rng.normal(size=(stacks, k, r)).astype(np.float32) * 0.2
    b = rng.normal(size=(stacks, r, n)).astype(np.float32) * 0.2
    a[0] = 0.0
    b[0] = 0.0
    scale = np.linspace(0.0, 1.5, stacks).astype(np.float32)
    ids = rng.integers(0, stacks, t).astype(np.int32)
    return x, a, b, scale, ids


def _oracle(x, a, b, scale, ids):
    out = np.zeros((x.shape[0], b.shape[2]), np.float64)
    for t in range(x.shape[0]):
        i = int(ids[t])
        h = x[t].astype(np.float64) @ a[i].astype(np.float64)
        out[t] = (h @ b[i].astype(np.float64)) * float(scale[i])
    return out


def _port_delta(x, a, b, scale, ids):
    return lora_epilogue_values(*(torch.from_numpy(v) for v in
                                  (x, a, b, scale, ids))).numpy()


@pytest.mark.parametrize("shape", [(16, 128, 128, 8), (9, 32, 64, 8)],
                         ids=["k128_n128_r8", "k32_n64_r8"])
def test_epilogue_matches_jax_and_oracle(shape):
    t, k, n, r = shape
    ops = _operands(t, k, n, r)
    got = _port_delta(*ops)
    want = np.asarray(jax_lora(*ops, use_kernel=True))
    assert got.shape == want.shape == (t, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _oracle(*ops), rtol=1e-4, atol=1e-4)


def test_row_zero_is_exact_zero():
    x, a, b, scale, ids = _operands()
    d = _port_delta(x, a, b, scale, np.zeros_like(ids))
    assert np.all(d == 0.0)


def test_rank_padding_is_bit_exact():
    x, a, b, scale, ids = _operands(r=4)
    pad_a = np.concatenate([a, np.zeros(a.shape[:2] + (4,), np.float32)], 2)
    pad_b = np.concatenate(
        [b, np.zeros((b.shape[0], 4, b.shape[2]), np.float32)], 1)
    assert np.array_equal(_port_delta(x, a, b, scale, ids),
                          _port_delta(x, pad_a, pad_b, scale, ids))


def test_accumulate_form_and_lora_matmul():
    """``y=`` returns y + delta rounded to x's dtype; `lora_matmul_values`
    is the base `F.linear` plus that; `LoraWeight.take` cuts the ids."""
    x, a, b, scale, ids = (torch.from_numpy(v) for v in _operands())
    x = x.reshape(2, 8, -1).to(torch.bfloat16)
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    w = torch.randn(128, 128).to(torch.bfloat16)
    y = torch.nn.functional.linear(x, w)
    d = lora_epilogue_values(x, a, b, scale, ids)
    assert d.shape == (2, 8, 128) and d.dtype == torch.bfloat16
    assert torch.equal(lora_epilogue_values(x, a, b, scale, ids, y=y), y + d)
    lw = LoraWeight(w, a, b, scale, ids)
    assert torch.equal(lora_matmul_values(x, lw), y + d)
    rows = torch.tensor([3, 0, 15])
    assert torch.equal(lw.take(rows).ids, ids[rows])
    assert torch.equal(lora_epilogue_ref(x.reshape(16, -1), a, b, scale,
                                         ids).reshape(2, 8, -1), d)


# -- the engine against the JAX engine ---------------------------------
@pytest.mark.parametrize("targets", [TARGETS, HEAD],
                         ids=["two_matmuls", "with_lm_head"])
def test_mixed_streams_equal_jax(models, targets):
    jm, tm, sd = models
    streams = []
    for eng in (_jax(jm), _port(tm)):
        for tag, seed in SEEDS.items():
            eng.install_adapter(tag, _deltas(sd, seed, targets=targets))
        streams.append(_serve_mixed(eng))
    assert streams[1] == streams[0]
    # the adapters steer the streams: the equality compares different
    # streams, not copies of the base's
    assert streams[1]["a1-0"] != streams[1]["base-0"] \
        or streams[1]["a1-1"] != streams[1]["base-1"]


def test_int8_base_streams_equal_jax(models):
    jm, tm, sd = models
    streams = []
    for eng in (_jax(jm, quant=JQuant("int8", None)),
                _port(tm, quant=QuantServingConfig("int8", None))):
        for tag, seed in SEEDS.items():
            eng.install_adapter(tag, _deltas(sd, seed, targets=HEAD))
        streams.append(_serve_mixed(eng))
    assert streams[1] == streams[0]


def test_mixed_equal_dedicated_port_engines(models):
    """One engine serving base + two adapters in one dispatch gives each
    request the stream of a dedicated engine (a2 sits in stack row 2
    there and in row 1 alone)."""
    _, tm, sd = models
    mixed = _port(tm)
    for tag, seed in SEEDS.items():
        mixed.install_adapter(tag, _deltas(sd, seed))
    want = _serve_mixed(mixed)
    for tag in ("base", "a1", "a2"):
        eng = _port(tm)
        if tag != "base":
            eng.install_adapter(tag, _deltas(sd, SEEDS[tag]))
        got = _serve_mixed(eng, tags=(tag,))
        assert got == {k: v for k, v in want.items()
                       if k.startswith(tag + "-")}


def test_stack_bytes_equal_jax(models):
    jm, tm, sd = models
    j, t = _jax(jm), _port(tm)
    for eng in (j, t):
        for tag, seed in SEEDS.items():
            eng.install_adapter(tag, _deltas(sd, seed))
    assert t.lora_adapter_bytes == j._lora_nbytes() > 0
    assert t.lora_adapters_resident == 2 and t.lora_installs == 2
    t.evict_adapter("a1")
    j.evict_adapter("a1")
    assert t.lora_adapter_bytes == j._lora_nbytes()
    assert t.lora_adapters_resident == 1 and t.lora_evictions == 1


# -- refusals and transactions -----------------------------------------
def test_unknown_adapter_refused_before_enqueue(models):
    _, tm, sd = models
    eng = _port(tm)
    with pytest.raises(ModelMismatch, match="not resident"):
        eng.add_request([1, 2], 4, adapter="a1")
    assert not eng._queue
    eng.install_adapter("a1", _deltas(sd, 1))
    with pytest.raises(ModelMismatch):
        eng.add_request([1, 2], 4, adapter="a2")


def test_composition_refusals(models):
    """prefill_chunk, prefix caching, the legacy path and spec decode
    refuse adapters as in JAX."""
    _, tm, sd = models
    with pytest.raises(ValueError, match="prefill_chunk"):
        _port(tm, prefill_chunk=16).install_adapter("a1", _deltas(sd, 1))
    with pytest.raises(ValueError, match="prefix caching"):
        _port(tm, enable_prefix_caching=True).install_adapter(
            "a1", _deltas(sd, 1))
    with pytest.raises(ValueError, match="ragged"):
        _port(tm, attention_impl="legacy").install_adapter(
            "a1", _deltas(sd, 1))
    with pytest.raises(ValueError, match="spec_decode"):
        _port(tm, spec_decode=SpecConfig(tm, k=2)).install_adapter(
            "a1", _deltas(sd, 1))


@pytest.mark.parametrize("case", ["unknown", "non_matmul", "embedding",
                                  "shape", "mixed_ranks", "other_rank",
                                  "other_targets", "duplicate"])
def test_bad_install_refused_and_leaves_no_residue(models, case):
    _, tm, sd = models
    eng = _port(tm)
    eng.install_adapter("a1", _deltas(sd, 1))
    before = (dict(eng._adapter_rows), list(eng._lora_free_rows),
              {nm: t.clone() for nm, t in eng._lora["a"].items()},
              eng._lora["scale"].clone(), eng.lora_installs)
    good = _deltas(sd, 2)
    k0, n0 = sd[TARGETS[0]].shape
    bad = {
        "unknown": {"nope.weight": (np.zeros((8, 4)), np.zeros((4, 8)))},
        "non_matmul": {"model.norm.weight": good[TARGETS[0]]},
        "embedding": {"model.embed_tokens.weight": good[TARGETS[0]]},
        "shape": {**good, TARGETS[0]: (np.zeros((k0 + 1, 4)),
                                       np.zeros((4, n0)))},
        "mixed_ranks": {**good, TARGETS[0]: (np.zeros((k0, 2)),
                                             np.zeros((2, n0)))},
        "other_rank": _deltas(sd, 2, rank=2),
        "other_targets": _deltas(sd, 2, targets=TARGETS[:1]),
        "duplicate": good,
    }[case]
    name = "a1" if case == "duplicate" else "a2"
    with pytest.raises(ValueError):
        eng.install_adapter(name, bad)
    assert eng._adapter_rows == before[0]
    assert eng._lora_free_rows == before[1]
    assert all(torch.equal(eng._lora["a"][nm], t)
               for nm, t in before[2].items())
    assert torch.equal(eng._lora["scale"], before[3])
    assert eng.lora_installs == before[4]
    eng.check_invariants()


def test_evict_refused_in_flight(models):
    _, tm, sd = models
    eng = _port(tm)
    eng.install_adapter("a1", _deltas(sd, 1))
    rid = eng.add_request([5, 4, 3], 6, adapter="a1")
    with pytest.raises(ValueError, match="in flight"):
        eng.evict_adapter("a1")             # queued
    eng.step()
    with pytest.raises(ValueError, match="in flight"):
        eng.evict_adapter("a1")             # running
    assert len(eng.run()[rid]) == 6
    eng.evict_adapter("a1")
    with pytest.raises(ValueError, match="not resident"):
        eng.evict_adapter("a1")


def test_invariants_through_install_evict_swap_reset(models):
    """check_invariants stays clean through install, evict, reinstall
    into the freed row, install_weights (the JAX engine's streams under
    the same second checkpoint) and reset_weights (the build-time
    streams again); a corrupted slot map is caught."""
    jm, tm, sd = models
    eng = _port(tm)
    base = _serve_mixed(eng, tags=("base",))
    for tag, seed in SEEDS.items():
        eng.install_adapter(tag, _deltas(sd, seed))
        eng.check_invariants()
    mixed = _serve_mixed(eng)
    eng.evict_adapter("a1")
    eng.check_invariants()
    assert eng._lora_free_rows == [1]
    eng.install_adapter("a1", _deltas(sd, 1))
    assert eng._adapter_rows["a1"] == 1 and not eng._lora_free_rows
    eng.check_invariants()
    assert _serve_mixed(eng) == mixed

    paddle.seed(11)
    j2 = JLlama(jm.config)
    v2 = {k: np.asarray(v._value) for k, v in j2.state_dict().items()}
    jeng = _jax(jm)
    jeng.install_weights(v2, tag="v2")
    want = _serve_mixed(jeng, tags=("base",))
    eng.install_weights(llama_state_from_numpy(v2, tm), tag="v2")
    assert eng.model_tag == "v2" and eng.lora_adapters_resident == 0
    eng.check_invariants()
    assert _serve_mixed(eng, tags=("base",)) == want != base
    eng.reset_weights()
    assert eng.model_tag is None
    eng.check_invariants()
    assert _serve_mixed(eng, tags=("base",)) == base

    eng.install_adapter("a1", _deltas(sd, 1))
    eng.add_request([5, 4, 3], 4, adapter="a1")
    eng.step()
    slot = next(i for i, r in enumerate(eng._slot_req) if r is not None)
    eng._slot_adapter[slot] = 0
    with pytest.raises(EngineInvariantError, match="adapter row"):
        eng.check_invariants()


def test_install_weights_refusals(models):
    _, tm, sd = models
    eng = _port(tm)
    state = llama_state_from_numpy(sd, tm)
    with pytest.raises(ValueError, match="missing"):
        eng.install_weights({k: v for k, v in state.items()
                             if "norm" not in k}, tag="bad")
    bad = dict(state)
    bad["model.norm.weight"] = torch.ones(3)
    with pytest.raises(ValueError, match="shape"):
        eng.install_weights(bad, tag="bad")
    assert eng.model_tag is None and eng._mpv is None
    eng.add_request([1, 2, 3], 2)
    with pytest.raises(ValueError, match="busy"):
        eng.install_weights(state, tag="v1")
    with pytest.raises(ValueError, match="busy"):
        eng.reset_weights()
