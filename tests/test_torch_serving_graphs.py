"""The port's program cache (`ContinuousBatchingEngine` with
``max_prefill_programs``, ``device="cpu"``) against the JAX engine's
jit families, on the same seeded small Llama (vocab 64, hidden 32, 2
layers; weights and LoRA deltas cross as numpy).

On the CPU a program's body runs eagerly on its static buffers every
time (the capture itself is left to the card:
tests/test_torch_cuda_kernels.py), so these tests hold what the card's
graphs rest on:

- the keys: after the same requests, the ragged admission programs in
  LRU order equal the JAX engine's ``_ragged_jits`` and the legacy
  prefill programs its ``_prefill_jits``, eviction at
  ``max_prefill_programs=2`` and the move to the back on a hit included
  (the port's counterpart of tests/test_serving.py
  ``test_prefill_program_cache_capped``);
- the buffers: greedy streams through the programs equal the JAX
  engine's and the eager port's (``_graphs=False``) at k = 1 and k = 4,
  with prefix hits, under int8 weights and KV, with two LoRA adapters
  and on the legacy path; a k = 4 window's pending dispatches each hold
  their own token tensor, not the program's static output;
- the bindings made at build: ``install_weights``, ``reset_weights``,
  ``install_adapter`` and ``evict_adapter`` each empty the cache, and
  the streams that follow equal the JAX engine's and the eager port's
  on the same script (a program kept past such a call would decode with
  the old weights or stacks)."""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.models.serving import QuantServingConfig as JQuant
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.serving import (ContinuousBatchingEngine,
                                             QuantServingConfig)

TARGETS = ("model.layers.0.self_attn.q_proj.weight",
           "model.layers.1.mlp.gate_proj.weight", "lm_head.weight")
# more jobs than slots, staggered budgets (tests/test_torch_serving_
# pipeline.py): admissions in batches of several sizes
JOBS = [([1, 2, 3], 9), ([4, 5], 7), ([6, 7, 8, 9], 5), ([2, 2], 12),
        ([9, 1], 3)]
SHARED = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]          # 3 pages of 4
PREFIX_JOBS = [(SHARED + [7, 7], 6), (SHARED + [2, 8], 5),
               (SHARED[:8] + [1, 1, 1], 4), ([8, 8, 8], 4)]
ADAPTERS = (None, "a1", "a2")


def _cfg_kw():
    return dict(vocab_size=64, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=2,
                num_key_value_heads=1, max_position_embeddings=64)


@pytest.fixture(scope="module")
def models():
    paddle.seed(9)
    jm = JLlama(JConfig(**_cfg_kw()))
    jm.eval()
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig(**_cfg_kw()), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    paddle.seed(10)
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


def _opts(kw):
    return dict(dict(max_batch_size=3, max_seq_len=64, page_size=4,
                     prompt_pad=8), **kw)


def _port(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", **_opts(kw))


def _jax(jm, **kw):
    return JEngine(jm, **_opts(kw))


def _serve(eng, jobs=JOBS, adapters=(None,)):
    rids = [eng.add_request(p, n, adapter=adapters[i % len(adapters)])
            for i, (p, n) in enumerate(jobs)]
    res = eng.run()
    eng.check_invariants()
    # every page free but those the prefix cache keeps
    cached = {n["page"] for n in getattr(eng, "_prefix_nodes", {}).values()}
    assert len(eng._free) + len(cached) == eng.num_pages - 1
    return [res[r] for r in rids]


# -- the keys ----------------------------------------------------------
# one slot: each request is its own admission dispatch. Prompt lengths
# give the keys A, B, A (a hit: A moves to the back), C (B evicted at
# cap 2), B (A evicted): a cache without the move to the back ends
# [B, C] instead of [C, B]
KEY_PROMPTS = [list(range(1, n + 1)) for n in (3, 20, 3, 40, 20)]
# legacy buckets at prompt_pad 4: 4, 8, 4 (hit), 12, 8
BUCKET_PROMPTS = [list(range(1, n + 1)) for n in (3, 7, 2, 11, 7)]


# the keys left in LRU order, by path and cap: (8, 1), (24, 8), (40, 16)
# are A, B, C on the ragged path (padded tokens, pages bound)
LEFT = {("ragged", 2): [(40, 16), (24, 8)],
        ("ragged", 8): [(8, 1), (40, 16), (24, 8)],
        ("legacy", 2): [12, 8], ("legacy", 8): [4, 12, 8]}


@pytest.mark.parametrize("impl,prompts", [("ragged", KEY_PROMPTS),
                                          ("legacy", BUCKET_PROMPTS)],
                         ids=["ragged", "legacy"])
@pytest.mark.parametrize("cap", [2, 8])
def test_program_keys_follow_jax_lru(models, impl, prompts, cap):
    jm, tm, _, _ = models
    kw = dict(max_batch_size=1, attention_impl=impl, prompt_pad=8
              if impl == "ragged" else 4, max_prefill_programs=cap)
    jeng, eng = _jax(jm, **kw), _port(tm, **kw)
    for p in prompts:
        jeng.add_request(p, 3)
        eng.add_request(p, 3)
        jeng.run()
        eng.run()
        if impl == "ragged":
            assert list(eng._ragged_programs) == list(jeng._ragged_jits)
            assert not eng._prefill_programs
        else:
            assert list(eng._prefill_programs) == list(jeng._prefill_jits)
            assert not eng._ragged_programs
    keys = eng._ragged_programs if impl == "ragged" \
        else eng._prefill_programs
    assert list(keys) == LEFT[impl, cap]
    assert eng._decode_program is not None
    assert eng.num_graph_captures == 0             # no capture on the CPU


def test_prefill_program_cache_capped(models):
    """tests/test_serving.py ``test_prefill_program_cache_capped``."""
    jm, tm, _, _ = models
    kw = dict(max_batch_size=1, prompt_pad=4, attention_impl="legacy",
              max_prefill_programs=2)
    eng, jeng = _port(tm, **kw), _jax(jm, **kw)
    for eng_ in (eng, jeng):
        for n_len in (3, 7, 11, 15):
            eng_.add_request(list(range(1, n_len + 1)), 2)
        eng_.run()
    assert len(eng._prefill_programs) <= 2
    assert list(eng._prefill_programs) == list(jeng._prefill_jits) \
        == [12, 16]


# -- the buffers: streams through the programs ---------------------------
CASES = {
    "k1": (JOBS, (None,), {}, {}),
    "k4": (JOBS, (None,), dict(harvest_every=4), dict(harvest_every=4)),
    "prefix": (PREFIX_JOBS, (None,), dict(enable_prefix_caching=True,
                                          max_batch_size=1), None),
    "quant": (JOBS, (None,), dict(quant=QuantServingConfig("int8", "int8")),
              dict(quant=JQuant("int8", "int8"))),
    "lora": (JOBS, ADAPTERS, {}, {}),
    "legacy": (JOBS, (None,), dict(attention_impl="legacy"), None),
}


def _case_engines(jm, tm, sd, name):
    jobs, adapters, kw, jkw = CASES[name]
    jkw = kw if jkw is None else jkw
    engines = [_jax(jm, **jkw), _port(tm, **kw),
               _port(tm, _graphs=False, **kw)]
    for eng in engines:
        for i, tag in enumerate(adapters[1:]):
            eng.install_adapter(tag, _deltas(sd, i + 1))
    return engines


@pytest.mark.parametrize("name", list(CASES))
def test_streams_through_programs_equal_jax_and_eager(models, name):
    jm, tm, sd, _ = models
    jobs, adapters, _, _ = CASES[name]
    jeng, eng, eager = _case_engines(jm, tm, sd, name)
    want = _serve(jeng, jobs, adapters)
    assert _serve(eng, jobs, adapters) == want
    assert _serve(eager, jobs, adapters) == want
    if name == "legacy":
        assert list(eng._prefill_programs) == list(jeng._prefill_jits)
    else:
        assert list(eng._ragged_programs) == list(jeng._ragged_jits)
    # the programs ran: the decode program once a decode dispatch
    assert eng._decode_program.runs == eng.num_decode_dispatches > 2
    assert eager._decode_program is None and not eager._ragged_programs \
        and not eager._prefill_programs
    if name == "prefix":
        assert eng.prefix_hits == jeng.prefix_hits >= 2
        assert eng.prefix_tokens_reused == jeng.prefix_tokens_reused
    if name == "lora":
        assert want[1] != _serve(_port(tm), [JOBS[1]])[0]   # adapted


def test_window_entries_keep_their_own_tokens(models):
    """A k = 4 window of four decode dispatches of the one decode
    program: each pending entry holds its own token tensor, none the
    program's static output, which the next run overwrites."""
    _, tm, _, _ = models
    eng = _port(tm, harvest_every=4)
    for p, _ in JOBS[:3]:
        eng.add_request(p, 20)
    for _ in range(4):
        eng.step()
    assert len(eng._pending) == 4
    ptrs = {e["nxt"].data_ptr() for e in eng._pending}
    assert len(ptrs) == 4
    assert eng._decode_program.out.data_ptr() not in ptrs
    # the window holds the tokens the k = 1 loop commits
    held = [e["nxt"].clone() for e in eng._pending]
    eng.quiesce()
    ref = _port(tm)
    for p, _ in JOBS[:3]:
        ref.add_request(p, 20)
    out = ref.run()
    for s in range(3):
        got = [int(h[s]) for h in held]
        assert got == out[s][1:5]


# -- the bindings: weight and adapter changes drop every program ----------
SEAMS = ["install_weights", "reset_weights", "install_adapter",
         "evict_adapter"]


def _seam_script(eng, seam, sd, state2):
    """The same calls on every engine: ``state2`` is the second
    checkpoint in the engine's own layout. Returns the streams and whether each call
    left the engine's program cache empty (None for the JAX engine)."""
    port = isinstance(eng, ContinuousBatchingEngine)

    def emptied():
        return not eng._programs() if port else None

    outs, drops = {}, []

    def add(tag, adapter=None):
        for i, (p, n) in enumerate(JOBS):
            eng.add_request(p, n, request_id=f"{tag}{i}", adapter=adapter)

    def run():
        while eng._queue or any(r is not None for r in eng._slot_req):
            for r in eng.step():
                outs[r.request_id] = list(r.output)

    if seam == "install_weights":
        add("a")
        run()
        eng.install_weights(state2, tag="v2")
        drops.append(emptied())
        add("b")
        run()
    elif seam == "reset_weights":
        eng.install_weights(state2, tag="v2")
        add("a")
        run()
        eng.reset_weights()
        drops.append(emptied())
        add("b")
        run()
    elif seam == "install_adapter":
        add("a")
        for _ in range(3):                  # mid-run: requests in flight
            for r in eng.step():
                outs[r.request_id] = list(r.output)
        eng.install_adapter("a1", _deltas(sd, 1))
        drops.append(emptied())
        add("b", "a1")
        run()
    else:
        eng.install_adapter("a1", _deltas(sd, 1))
        eng.install_adapter("a2", _deltas(sd, 2))
        add("a", "a1")
        for _ in range(3):
            for r in eng.step():
                outs[r.request_id] = list(r.output)
        eng.evict_adapter("a2")             # not in flight
        drops.append(emptied())
        add("b", "a1")
        run()
        eng.evict_adapter("a1")             # the last one: stacks go
        drops.append(emptied())
        add("c")
        run()
    return outs, drops


@pytest.mark.parametrize("seam", SEAMS)
def test_weight_and_adapter_changes_drop_programs(models, seam):
    jm, tm, sd, v2 = models
    state2 = llama_state_from_numpy(v2, tm)
    want, _ = _seam_script(_jax(jm), seam, sd, v2)
    got, drops = _seam_script(_port(tm, harvest_every=4), seam, sd, state2)
    eager, _ = _seam_script(_port(tm, _graphs=False, harvest_every=4),
                            seam, sd, state2)
    assert drops and all(drops)
    assert got == want == eager
    assert len(got) == len(JOBS) * (3 if seam == "evict_adapter" else 2)


@pytest.mark.parametrize("impl", ["ragged", "legacy"])
def test_dropped_engine_frees_without_gc(models, impl):
    """A program's body holds no reference to its engine: an engine that
    built programs is freed (its pools with it) when the last reference
    goes, not at the next garbage collection."""
    import gc
    import weakref
    _, tm, _, _ = models
    eng = _port(tm, attention_impl=impl)
    _serve(eng, JOBS[:2])
    assert eng._decode_program is not None
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()

