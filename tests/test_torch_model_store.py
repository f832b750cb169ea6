"""The port's fleet model store (`paddle_tpu_torch.serving.model_store`)
against the JAX package's, on the CPU, with port engines
(``device="cpu"``) on the small Llama of tests/test_multimodel.py: the
drills of tests/test_multimodel.py `TestStoreInstallEvict` (LRU under a
byte budget, pins, an eviction the engine refuses, a budget below one
adapter, a full-checkpoint swap dropping adapters, a failed install
leaving no residue), and the same `stats()` and resident sets as the
JAX store after the same call sequence against JAX engines."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import FleetModelStore as JStore
from paddle_tpu.serving import model_id as j_model_id
from paddle_tpu.serving import split_model_id as j_split_model_id
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                             ModelMismatch)
from paddle_tpu_torch.serving import (FleetModelStore, model_id,
                                      split_model_id)

TARGETS = ("model.layers.0.self_attn.q_proj.weight",
           "model.layers.1.mlp.gate_proj.weight")


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
    paddle.seed(11)
    v2 = {k: np.asarray(v._value)
          for k, v in JLlama(jm.config).state_dict().items()}
    return jm, tm, sd, v2


def _deltas(sd, seed, rank=4, scale=0.5):
    rng = np.random.default_rng(seed)
    out = {}
    for nm in TARGETS:
        k, n = sd[nm].shape
        out[nm] = (rng.normal(size=(k, rank)).astype(np.float32) * scale,
                   rng.normal(size=(rank, n)).astype(np.float32) * scale)
    return out


def _store(sd, budget=None, cls=FleetModelStore, **kw):
    store = cls(base_model="base", byte_budget_per_replica=budget,
                max_rank=8, **kw)
    mids = [store.register_adapter(a, _deltas(sd, seed=i + 1))
            for i, a in enumerate(("a1", "a2"))]
    return store, mids


def _engine(tm):
    return ContinuousBatchingEngine(tm, max_batch_size=3, max_seq_len=64,
                                    page_size=4, device="cpu")


@pytest.mark.parametrize("args", [("base",), ("base", "a1"), ("",),
                                  ("b+x",), ("base", "")])
def test_model_id_matches_jax(args):
    try:
        want = j_model_id(*args)
    except ValueError:
        with pytest.raises(ValueError):
            model_id(*args)
        return
    assert model_id(*args) == want
    assert split_model_id(want) == j_split_model_id(want)


def test_failed_install_leaves_no_residue(models):
    _, tm, sd, _ = models
    bad = FleetModelStore(base_model="base", max_rank=8)
    mid_bad = bad.register_adapter(
        "bad", {"nope.weight": (np.zeros((8, 4), np.float32),
                                np.zeros((4, 8), np.float32))})
    eng = _engine(tm)
    with pytest.raises(ValueError, match="unknown parameter"):
        bad.ensure(0, eng, mid_bad)
    assert not bad.is_resident(0, mid_bad)
    assert bad.installs == 0 and bad.resident(0) == ("base",)
    good, (m1, _) = _store(sd)
    assert good.ensure(0, eng, m1) is True
    rid = eng.add_request([5, 4, 3], 4, adapter="a1")
    assert len(eng.run()[rid]) == 4
    eng.check_invariants()


def test_byte_budget_lru_evicts_cold_adapter(models):
    _, tm, sd, _ = models
    store, (m1, m2) = _store(sd, budget=6_000)
    eng = _engine(tm)
    assert store.ensure("r0", eng, m1) is True
    assert store.ensure("r0", eng, m1) is False     # warm hit
    assert store.ensure("r0", eng, m2) is True      # evicts a1
    assert store.is_resident("r0", m2) and not store.is_resident("r0", m1)
    assert store.evictions == 1
    assert store.resident_bytes("r0") <= store.byte_budget_per_replica
    with pytest.raises(ModelMismatch):
        eng.add_request([5, 4], 4, adapter="a1")
    eng.check_invariants()


def test_pinned_adapter_survives_make_room(models):
    _, tm, sd, _ = models
    store, (m1, m2) = _store(sd, budget=6_000)
    eng = _engine(tm)
    store.ensure("r0", eng, m1)
    store.pin("r0", m1)
    store.ensure("r0", eng, m2)
    assert store.is_resident("r0", m1) and store.is_resident("r0", m2)
    assert store.evict_refusals >= 1
    assert store.resident_bytes("r0") > store.byte_budget_per_replica
    store.unpin("r0", m1)


def test_engine_refusal_keeps_adapter_resident(models):
    """The engine's own backstop: an unpinned adapter with a request in
    flight is refused eviction by the engine, and the store skips it."""
    _, tm, sd, _ = models
    store, (m1, m2) = _store(sd, budget=6_000)
    eng = _engine(tm)
    store.ensure("r0", eng, m1)
    rid = eng.add_request([5, 4, 3], 6, adapter="a1")
    store.ensure("r0", eng, m2)
    assert store.is_resident("r0", m1) and store.evict_refusals == 1
    assert len(eng.run()[rid]) == 6
    eng.check_invariants()


def test_budget_below_one_adapter_still_installs(models):
    _, tm, sd, _ = models
    store, (m1, _) = _store(sd, budget=1_000)
    eng = _engine(tm)
    assert store.ensure("r0", eng, m1) is True
    assert store.is_resident("r0", m1)
    rid = eng.add_request([5, 4, 3], 4, adapter="a1")
    assert len(eng.run()[rid]) == 4


def test_full_checkpoint_swap_drops_adapters(models):
    _, tm, sd, v2 = models
    store, (m1, _) = _store(sd)
    mid_v2 = store.register_model("v2", llama_state_from_numpy(v2, tm))
    eng = _engine(tm)
    store.ensure("r0", eng, m1)
    store.ensure("r0", eng, mid_v2)
    assert store.replica_base("r0") == "v2"
    assert not store.is_resident("r0", m1)
    assert eng.model_tag == "v2"
    with pytest.raises(ModelMismatch):
        eng.add_request([5, 4], 4, adapter="a1")
    eng.check_invariants()
    # back to the builtin base: reset_weights
    store.ensure("r0", eng, store.base_model)
    assert eng.model_tag is None and store.replica_base("r0") == "base"


def test_busy_swap_refused_with_accounting_unchanged(models):
    _, tm, sd, v2 = models
    store, (m1, _) = _store(sd)
    mid_v2 = store.register_model("v2", llama_state_from_numpy(v2, tm))
    eng = _engine(tm)
    store.ensure("r0", eng, m1)
    eng.add_request([5, 4, 3], 4, adapter="a1")
    before = store.stats()
    with pytest.raises(ValueError, match="busy"):
        store.ensure("r0", eng, mid_v2)
    assert store.stats() == before and store.is_resident("r0", m1)


def _sequence(store, engines, mids, mid_v2):
    """One call sequence: cold and warm installs on two replicas, LRU
    under the budget, a pin, a full swap and back, a forgotten replica
    whose successor (a fresh engine) installs anew."""
    m1, m2 = mids
    store.ensure("r0", engines[0], m1)
    store.ensure("r0", engines[0], m1)
    store.ensure("r0", engines[0], m2)
    store.ensure("r1", engines[1], m2)
    store.pin("r1", m2)
    store.ensure("r1", engines[1], m1)
    store.unpin("r1", m2)
    store.ensure("r0", engines[0], mid_v2)
    store.ensure("r0", engines[0], m1)
    store.ensure("r0", engines[0], store.base_model)
    store.forget_replica("r1")
    store.ensure("r2", engines[2], m2)
    return store.stats(), [store.resident(r) for r in ("r0", "r2")]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_stats_equal_jax_after_same_sequence(models, quant):
    jm, tm, sd, v2 = models
    jstore, jmids = _store(sd, budget=6_000, cls=JStore,
                           quant_weights=quant)
    jv2 = jstore.register_model("v2", v2)
    jengines = [JEngine(jm, max_batch_size=3, max_seq_len=64, page_size=4)
                for _ in range(3)]
    want = _sequence(jstore, jengines, jmids, jv2)
    store, mids = _store(sd, budget=6_000, quant_weights=quant)
    pv2 = store.register_model("v2", llama_state_from_numpy(v2, tm))
    got = _sequence(store, [_engine(tm) for _ in range(3)], mids, pv2)
    assert got == want
    assert store.stats()["installs"] > 0 and store.evictions > 0


def test_quantized_registration_matches_jax_bytes(models):
    """With ``quant_weights="int8"`` the store quantizes a checkpoint's
    matmul weights at registration: the same bytes as the JAX store's
    (transposed), and an engine serves them."""
    _, tm, _, v2 = models
    jstore = JStore(base_model="base", quant_weights="int8")
    jstore.register_model("v2", v2)
    store = FleetModelStore(base_model="base", quant_weights="int8")
    store.register_model("v2", llama_state_from_numpy(v2, tm))
    jv = jstore._artifacts["v2"]["values"]
    pv = store._artifacts["v2"]["values"]
    assert store._artifacts["v2"]["nbytes"] == jstore._artifacts["v2"][
        "nbytes"]
    for nm, w in jv.items():
        if type(w).__name__ == "QuantizedWeight":
            np.testing.assert_array_equal(pv[nm].qw.numpy(),
                                          np.asarray(w.qw).T)
            np.testing.assert_array_equal(pv[nm].scale.numpy(),
                                          np.asarray(w.scale))
        else:
            assert torch.is_tensor(pv[nm])
    eng = _engine(tm)
    store.ensure("r0", eng, "v2")
    rid = eng.add_request([5, 4, 3], 3)
    assert len(eng.run()[rid]) == 3


def test_registration_refusals_match_jax(models):
    _, _, sd, _ = models
    for cls in (JStore, FleetModelStore):
        store, _ = _store(sd, cls=cls)
        with pytest.raises(ValueError, match="already registered"):
            store.register_adapter("a1", _deltas(sd, 1))
        with pytest.raises(ValueError, match="max_rank"):
            store.register_adapter("big", _deltas(sd, 1, rank=9))
        with pytest.raises(ValueError, match="one target set"):
            store.register_adapter("half", {TARGETS[0]:
                                            _deltas(sd, 1)[TARGETS[0]]})
        with pytest.raises(ValueError, match="not a registered"):
            store.register_adapter("x", _deltas(sd, 1), base="nope")
        with pytest.raises(KeyError):
            store.ensure("r0", None, "base+nope")
