"""The port's engine on ``kv_layout="dense"`` (per-slot contiguous (B, S,
HK, D) caches, served through the legacy paths) against the JAX engine's
dense layout, on the same seeded `LlamaConfig.tiny()` weights (crossing
as numpy), ``device="cpu"``:

- greedy streams equal to JAX's dense engine and to the port's paged
  engine (tests/test_serving.py `test_paged_matches_dense_engine`), with
  more requests than slots, an EOS and a prompt that ends at the cache
  end, and under a sliding window
  (`test_sliding_window_paged_matches_dense`);
- the dense warnings and refusals (`test_dense_layout_warns_and_disables`):
  prefix caching and ``prefill_chunk`` disabled with a warning,
  ``quant=``, ``harvest_every > 1`` and adapters refused;
- `cache_memory_info` equal to JAX's, `check_invariants` a no-op;
- streams through the program cache equal to ``_graphs=False``, the
  dense decode one program, dropped by `install_weights`."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                             QuantServingConfig)

S = 64
# five requests for two slots; the 60-token prompt ends at the cache end
LENS = (5, 20, 40, 60, 13)
NEW = (6, 9, 5, 8, 7)


def _pair(window=None, seed=7):
    paddle.seed(seed)
    jcfg, tcfg = JConfig.tiny(), LlamaConfig.tiny()
    jcfg.sliding_window = tcfg.sliding_window = window
    jm = JLlama(jcfg)
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(tcfg, device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    jm, tm = _pair()
    rng = np.random.default_rng(0)
    return jm, tm, [rng.integers(0, 512, n) for n in LENS]


def _serve(engine, prompts, news=NEW):
    rids = [engine.add_request(p, max_new_tokens=n)
            for p, n in zip(prompts, news)]
    out = engine.run()
    engine.check_invariants()
    return [out[r] for r in rids]


def _port(tm, **kw):
    return ContinuousBatchingEngine(tm, max_batch_size=2, max_seq_len=S,
                                    device="cpu", **kw)


def _jax(jm, **kw):
    return JEngine(jm, max_batch_size=2, max_seq_len=S, **kw)


@pytest.mark.parametrize("impl", ["ragged", "legacy"])
def test_dense_streams_equal_jax_and_paged(models, impl):
    jm, tm, prompts = models
    want = _serve(_jax(jm, kv_layout="dense"), prompts)
    eng = _port(tm, kv_layout="dense", attention_impl=impl)
    assert eng.layout == "dense" and eng.attn_impl == "legacy"
    got = _serve(eng, prompts)
    assert got == want
    assert got == _serve(_port(tm), prompts)
    # the near-S prompt stops at the cache end, not at max_new_tokens
    assert len(got[3]) == S - LENS[3] < NEW[3]


def test_dense_eos_streams_equal_jax(models):
    jm, tm, prompts = models
    eos = _serve(_port(tm, kv_layout="dense"), prompts)[1][2]
    want = _serve(_jax(jm, kv_layout="dense", eos_token_id=eos), prompts)
    got = _serve(_port(tm, kv_layout="dense", eos_token_id=eos), prompts)
    assert got == want
    assert got[1][-1] == eos and len(got[1]) == 3


def test_dense_sliding_window_equals_jax_and_paged():
    """≙ `test_sliding_window_paged_matches_dense`: 30 new tokens past a
    16-token window, dense against JAX's dense engine and the port's
    paged engine (which reclaims slid-out pages)."""
    jm, tm = _pair(window=16, seed=0)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, 9 + 4 * j) for j in range(3)]
    news = [30] * 3
    kw = dict(max_batch_size=2, max_seq_len=64, page_size=8)
    want = _serve(JEngine(jm, kv_layout="dense", **kw), prompts, news)
    got = _serve(ContinuousBatchingEngine(tm, kv_layout="dense",
                                          device="cpu", **kw), prompts, news)
    assert got == want
    assert got == _serve(ContinuousBatchingEngine(tm, device="cpu", **kw),
                         prompts, news)


@pytest.mark.parametrize("kw,match", [
    (dict(enable_prefix_caching=True), "prefix caching is DISABLED"),
    (dict(prefill_chunk=16), "chunked prefill is DISABLED"),
], ids=["prefix_caching", "prefill_chunk"])
def test_dense_warns_and_disables(models, kw, match):
    """≙ `test_dense_layout_warns_and_disables`, for JAX's engine and the
    port's: the option is dropped with a warning and the engine serves."""
    jm, tm, _ = models
    with pytest.warns(UserWarning, match=match):
        jeng = _jax(jm, kv_layout="dense", **kw)
    with pytest.warns(UserWarning, match=match):
        eng = _port(tm, kv_layout="dense", **kw)
    prompts = [[5, 4, 3], list(range(1, 40))]
    assert _serve(eng, prompts, [4, 4]) == _serve(jeng, prompts, [4, 4])
    assert eng.prefix_hits == 0 and eng._chunk is None
    assert not eng._prefix_enabled


@pytest.mark.parametrize("kw,match", [
    (dict(quant=QuantServingConfig("int8", None)), "quant=.*paged"),
    (dict(harvest_every=2), "harvest_every > 1.*paged"),
], ids=["quant", "harvest_every"])
def test_dense_refusals(models, kw, match):
    jm, tm, _ = models
    if "quant" in kw:
        from paddle_tpu.models.serving import QuantServingConfig as JQ
        jkw = dict(quant=JQ("int8", None))
    else:
        jkw = kw
    with pytest.raises(ValueError, match=match):
        _jax(jm, kv_layout="dense", **jkw)
    with pytest.raises(ValueError, match=match):
        _port(tm, kv_layout="dense", **kw)


def test_dense_refuses_adapters(models):
    _, tm, _ = models
    eng = _port(tm, kv_layout="dense")
    nm = "model.layers.0.self_attn.q_proj.weight"
    k = tm.config.hidden_size
    with pytest.raises(ValueError, match="kv_layout='paged'"):
        eng.install_adapter("a1", {nm: (np.zeros((k, 2), np.float32),
                                        np.zeros((2, k), np.float32))})


def test_dense_memory_info_equals_jax(models):
    jm, tm, prompts = models
    jeng, eng = _jax(jm, kv_layout="dense"), _port(tm, kv_layout="dense")
    assert eng.cache_memory_info() == jeng.cache_memory_info()
    _serve(eng, prompts[:2])
    _serve(jeng, prompts[:2])
    assert eng.cache_memory_info() == jeng.cache_memory_info()
    assert eng.cache_memory_info()["bytes_pool"] == \
        2 * S * 2 * 32 * 4 * 2 * 2      # B S HK D f32 (k, v) layers


def test_dense_programs_equal_eager(models):
    """The dense decode is one program of the cache, with the legacy
    prefill's buckets beside it; its streams equal the eager engine's,
    and `install_weights` drops it."""
    _, tm, prompts = models
    eng = _port(tm, kv_layout="dense")
    got = _serve(eng, prompts)
    assert got == _serve(_port(tm, kv_layout="dense", _graphs=False),
                         prompts)
    assert eng._decode_program is not None
    assert eng._decode_program.runs == eng.num_decode_dispatches
    # LRU order: the 13-token prompt's bucket 16 was used last
    assert list(eng._prefill_programs) == [32, 48, 64, 16]
    eng.install_weights({n: p.detach() for n, p in tm.named_parameters()},
                        "same")
    assert eng._decode_program is None and not eng._prefill_programs
    assert _serve(eng, prompts) == got


def test_dense_dispatch_counts(models):
    _, tm, prompts = models
    eng = _port(tm, kv_layout="dense")
    out = _serve(eng, prompts)
    assert eng.num_admission_dispatches == len(prompts)
    assert eng.decode_tokens == sum(len(v) - 1 for v in out)
    assert eng.admission_tokens == sum(LENS)
