"""The port's KV page transfer plane against the JAX package's: the
engine's `get_request` / `export_pages` / `import_pages` /
`evict_request` / `import_prefix`, `serving.transfer` and
`serving.prefix_store`, on the same tiny Llama in both packages (weights
carried with `llama_state_from_numpy`), each package arming its own
`FaultInjector` and reading its own telemetry registry.

Ported, each beside the JAX run it is held to: tests/test_disagg.py
`TestTransferPlane`, `TestPrefixStore` (the policy's hash test aside:
the router is not ported), `TestMigrationTiming::
test_fake_clock_drives_transfer_histogram` and the three engine-level
tests of `TestPayloadIntegrity`; tests/test_serving.py
`test_import_pages_unpins_when_reserve_raises`; the export's quiesce of
tests/test_async_pipeline.py (k = 4); the cross-model refusal of
tests/test_multimodel.py, with an adapter migration; tests/test_quant_
serving.py `TestQuantMigration` (int8 KV); a spec engine migrated
mid-stream. The streams are held to the JAX engine's bitwise, the
telemetry counters to the JAX registry's, and the install and scatter
programs' keys to the JAX engine's `_install_jits` / `_scatter_jits`.

The wire test moves payloads across packages: a JAX engine's payload
(numpy f32) installs in the port, passes the port's `verify_payload` on
JAX's manifest and decodes to the JAX stream, and the port's payload
(CPU tensors) installs in the JAX engine. The KV rows of the two
packages' payloads agree within the serving parity tolerance ``TOL``
(f32 sums in another order); the payloads' other keys are equal.

Invariants are checked after every step of both engines (PDT_CHECK_
INVARIANTS=1). About a minute on one worker, most of it the JAX
engines' compiles."""
import time
import types

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.observability as jtelemetry
from paddle_tpu.models import serving as jserving
from paddle_tpu.models.llama import LlamaConfig as JConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.serving import prefix_store as jprefix_store
from paddle_tpu.serving import transfer as jtransfer
from paddle_tpu.utils import faults as jfaults
import paddle_tpu_torch.observability as telemetry
from paddle_tpu_torch.models import serving
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.serving import FleetPrefixStore, chain_hashes, transfer
from paddle_tpu_torch.utils import faults

TARGET = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=2,
              num_key_value_heads=1, max_position_embeddings=64)
DRAFT = dict(TARGET, hidden_size=16, intermediate_size=32,
             num_hidden_layers=1)
# the serving parity tolerance of the port's f32 pools against JAX's
TOL = dict(atol=1e-4, rtol=1e-4)
# two full 4-token pages of shared system prompt and distinct tails
SYS = [11, 7, 23, 42, 9, 30, 5, 17]
JOBS = [(SYS + [3, 1, 4], 6), (SYS + [55, 2], 5), (SYS + [8, 8, 61], 6),
        (SYS + [19, 44], 5), (SYS + [31, 6, 12], 6), (SYS + [27], 5)]
# the payload keys whose values the two packages must give alike
META = ("request_id", "prompt", "output", "max_new_tokens", "model_tag",
        "adapter", "preemptions", "priority", "ctx", "last_token", "freed",
        "n_pages", "page_size", "max_seq_len", "kv_spec", "kv_quant", "tp",
        "kv_shards")


def _pair(seed, cfg):
    paddle.seed(seed)
    jm = JLlama(JConfig(**cfg))
    jm.eval()
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    return jm, tm, sd


@pytest.fixture(scope="module")
def sides():
    (jm, tm, sd), (jd, td, _) = _pair(7, TARGET), _pair(8, DRAFT)
    jax = types.SimpleNamespace(
        name="jax", mod=jserving, transfer=jtransfer, faults=jfaults,
        telemetry=jtelemetry, model=jm, draft=jd, sd=sd, kw={})
    port = types.SimpleNamespace(
        name="port", mod=serving, transfer=transfer, faults=faults,
        telemetry=telemetry, model=tm, draft=td, sd=sd,
        kw={"device": "cpu"})
    return jax, port


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Invariants after every step, telemetry recording, both registries
    and trace rings empty."""
    monkeypatch.setenv("PDT_CHECK_INVARIANTS", "1")
    monkeypatch.setenv("PDT_TELEMETRY", "1")
    for t in (telemetry, jtelemetry):
        t.reset()
        t.clear_events()
        t.profile.configure_retrace(threshold=10 ** 6)
    yield
    for t in (telemetry, jtelemetry):
        t.reset()
        t.clear_events()
        t.profile.configure_retrace(window_s=30.0, threshold=10,
                                    clock=time.monotonic)


def _engine(side, **kw):
    """tests/test_disagg.py `_engine`: 2 slots, 64 positions, pages of 4,
    the prefix cache on."""
    kw = dict(dict(max_batch_size=2, max_seq_len=64, page_size=4,
                   enable_prefix_caching=True), **kw, **side.kw)
    return side.mod.ContinuousBatchingEngine(side.model, **kw)


def _busy(eng):
    return eng._queue or any(r is not None for r in eng._slot_req)


@pytest.fixture(scope="module")
def oracle(sides):
    """The JAX engine's greedy streams of every JOB from one run."""
    eng = _engine(sides[0])
    rids = [eng.add_request(p, n) for p, n in JOBS]
    res = eng.run()
    return [res[r] for r in rids]


def _running(side, job=JOBS[0], steps=2, **kw):
    src = _engine(side, **kw)
    rid = src.add_request(*job)
    for _ in range(steps):
        src.step()
    return src, rid


def _payload_view(payload):
    return {k: payload[k] for k in META}


# -- the transfer plane (tests/test_disagg.py TestTransferPlane) ---------
def test_migrate_mid_stream_bit_identical(sides, oracle):
    outs = []
    for side in sides:
        src, rid = _running(side)
        dst = _engine(side)
        req, payload = side.transfer.migrate_request(src, dst, rid)
        src.check_invariants()
        dst.check_invariants()
        assert src.get_request(rid) is None         # evicted, not terminal
        assert src.lifecycle_info()["running"] == 0
        done = {}
        while _busy(src) or _busy(dst):
            for r in dst.step():
                done[r.request_id] = r
            src.step()
        tv = side.telemetry.value
        outs.append({"stream": done[req.request_id].output,
                     "status": done[req.request_id].status,
                     "migrations": tv("pdt_transfer_migrations_total"),
                     "bytes": tv("pdt_transfer_bytes_total"),
                     "nbytes": side.transfer.payload_nbytes(payload),
                     "keys": sorted(payload), "meta": _payload_view(payload),
                     "lifecycle": dst.lifecycle_info()})
    assert outs[1] == outs[0]
    assert outs[1]["stream"] == oracle[0]
    assert outs[1]["migrations"] == 1 and outs[1]["bytes"] > 0


def test_export_validations(sides):
    port = sides[1]
    src = _engine(port)
    with pytest.raises(ValueError, match="no resident request"):
        src.export_pages(99)
    # a queued (never admitted) request has no pages to export
    src2 = _engine(port, max_batch_size=1)
    src2.add_request(*JOBS[0])
    waiting = src2.add_request(*JOBS[1])
    src2.step()
    with pytest.raises(ValueError, match="no resident request"):
        src2.export_pages(waiting)
    dense = serving.ContinuousBatchingEngine(
        port.model, max_batch_size=1, max_seq_len=64, kv_layout="dense",
        device="cpu")
    r = dense.add_request(*JOBS[0])
    dense.step()
    with pytest.raises(ValueError, match="paged"):
        dense.export_pages(r)


def test_import_validations_and_capacity(sides):
    port = sides[1]
    src, rid = _running(port, steps=1)
    payload = transfer.serialize_request(src, rid)
    with pytest.raises(ValueError, match="page_size"):
        _engine(port, page_size=8).import_pages(payload)
    full = _engine(port, max_batch_size=1)
    full.add_request(*JOBS[1])
    full.step()
    with pytest.raises(serving.EngineOverloaded, match="no free slot"):
        full.import_pages(payload)
    # the source was never touched: the request is still live there
    assert src.get_request(rid) is not None
    src.check_invariants()


def test_import_attaches_target_warm_prefix(sides, oracle):
    port = sides[1]
    dst = _engine(port)
    dst.add_request(SYS + [50, 12], 4)
    dst.run()
    assert dst._prefix_nodes                 # the SYS pages registered
    src, rid = _running(port, steps=1)
    req, _ = transfer.migrate_request(src, dst, rid)
    dst.check_invariants()
    slot = dst._slot_req.index(req)
    # the two full SYS pages attach read-only instead of being copied
    assert len(dst._slot_shared_pages[slot]) == 2
    assert dst.run()[req.rid] == oracle[0]


def test_evict_keeps_source_chain_warm(sides):
    port = sides[1]
    src, rid = _running(port, steps=1)
    transfer.migrate_request(src, _engine(port), rid)
    assert src._prefix_nodes                 # registered at the evict
    src.add_request(*JOBS[1])                # the same SYS prefix
    src.run()
    assert src.prefix_hits == 1 and src.prefix_tokens_reused == 8


def test_transfer_fault_sites_fire_and_isolate(sides, oracle):
    port = sides[1]
    src, rid = _running(port, steps=1)
    dst = _engine(port)
    for site in ("transfer.serialize", "transfer.install"):
        with faults.FaultInjector() as fi:
            fi.arm(site, nth=1)
            with pytest.raises(faults.FaultError):
                transfer.migrate_request(src, dst, rid)
    src.check_invariants()
    dst.check_invariants()
    assert dst.lifecycle_info()["running"] == 0     # backed out
    for stage in ("serialize", "install"):
        assert telemetry.value("pdt_transfer_failures_total",
                               stage=stage) == 1
    # both engines stayed consistent: the migration then succeeds
    req, _ = transfer.migrate_request(src, dst, rid)
    assert dst.run()[req.rid] == oracle[0]


# -- the prefix store (tests/test_disagg.py TestPrefixStore) -------------
def test_record_lookup_forget_equal_jax():
    outs = []
    for store_cls, hashes in ((jprefix_store.FleetPrefixStore,
                               jprefix_store.chain_hashes),
                              (FleetPrefixStore, chain_hashes)):
        store = store_cls(page_size=4)
        store.record(0, SYS + [1])
        h = hashes(SYS + [9, 9], 4)
        warm = (store.longest_warm(0, h), store.longest_warm(1, h))
        store.forget_replica(0)
        store.note_lookup("replica")
        store.note_lookup("miss")
        outs.append((h, warm, store.longest_warm(0, h), store.stats()))
    assert outs[1] == outs[0]
    assert outs[1][1] == (2, 0) and outs[1][2] == 0
    assert outs[1][3]["chains"] == 2


def test_spill_fetch_import_prefix_roundtrip(sides, oracle):
    port = sides[1]
    src, rid = _running(port, steps=1)
    payload = transfer.serialize_request(src, rid)
    store = FleetPrefixStore(page_size=4)
    assert store.spill_payload(payload) == 2         # both SYS pages
    entry = store.fetch(SYS + [77, 78])
    assert entry is not None
    tokens, kv_rows = entry
    assert [len(t) for t in tokens] == [4, 4]
    fresh = _engine(port)
    assert fresh.import_prefix(tokens, kv_rows) == 2
    fresh.check_invariants()
    rid2 = fresh.add_request(*JOBS[1])
    res = fresh.run()
    assert fresh.prefix_hits == 1                    # the spill revived
    assert res[rid2] == oracle[1]
    assert store.fetch([1, 2, 3, 4, 5]) is None


def test_import_prefix_respects_free_pool(sides):
    """A restored chain takes only free pages: a 3-page chain into a
    pool of 2 usable pages installs what fits, evicts nothing and leaves
    the trie consistent; the engine then serves normally."""
    port = sides[1]
    long_prompt = SYS + [3, 1, 4, 1, 5]             # 3 full chain pages
    src, rid = _running(port, job=(long_prompt, 4), steps=1)
    payload = transfer.serialize_request(src, rid)
    store = FleetPrefixStore(page_size=4)
    assert store.spill_payload(payload) == 3
    tokens, kv_rows = store.fetch(long_prompt)
    tiny = _engine(port, max_batch_size=1, num_pages=3)
    assert tiny.import_prefix(tokens, kv_rows) == 2
    tiny.check_invariants()
    r2 = tiny.add_request([1, 2, 3, 4], 4)
    assert len(tiny.run()[r2]) == 4
    tiny.check_invariants()


def test_spill_budget_evicts_lru_content(sides):
    port = sides[1]
    src, rid = _running(port, steps=1)
    payload = transfer.serialize_request(src, rid)
    page_bytes = sum((k[:, 0].numel() + v[:, 0].numel()) * k.element_size()
                     for k, v in payload["kv"])
    store = FleetPrefixStore(page_size=4, spill_budget_bytes=page_bytes)
    store.spill_payload(payload)            # 2 pages > a 1-page budget
    assert store.spilled_bytes <= page_bytes
    assert store.evictions >= 1
    stats = store.stats()
    assert stats["spilled_chains"] < 2
    assert stats["chains"] == 2             # warmth records survive


# -- timing (tests/test_disagg.py TestMigrationTiming) -------------------
def test_fake_clock_drives_transfer_histogram(sides):
    port = sides[1]
    src, rid = _running(port, job=([5, 4, 3, 2, 6, 7], 6), steps=1)
    ticks = iter([10.0, 11.5])
    transfer.migrate_request(src, _engine(port), rid,
                             clock=lambda: next(ticks))
    h = telemetry.snapshot()["histograms"]["pdt_transfer_seconds"]
    assert h[""]["count"] == 1
    assert h[""]["sum"] == pytest.approx(1.5)


# -- payload integrity (tests/test_disagg.py TestPayloadIntegrity) -------
def _flip(payload, which=0):
    """Corrupt one element of layer 0's keys (``which`` 0) or values
    (1) in a copy, as in-flight damage would."""
    pair = list(payload["kv"][0])
    arr = pair[which].clone()
    arr.view(-1)[arr.numel() // 2] += 1.0
    pair[which] = arr
    payload["kv"][0] = tuple(pair)


def _running_payload(port):
    src, rid = _running(port, job=([5, 4, 3, 2, 6, 7], 6))
    return src, rid, src.export_pages(rid)


def test_export_attaches_sha256_manifest(sides):
    _, _, payload = _running_payload(sides[1])
    assert len(payload["kv_sha256"]) == 1           # one shard
    assert len(payload["kv_sha256"][0]) == len(payload["kv"])
    for k_sha, v_sha in payload["kv_sha256"][0]:
        assert k_sha.startswith("sha256:") and v_sha.startswith("sha256:")
    assert serving.payload_checksums(payload) == payload["kv_sha256"]


def test_corrupt_payload_refused_before_any_mutation(sides):
    port = sides[1]
    src, rid, payload = _running_payload(port)
    dst = _engine(port)
    _flip(payload)
    before = dst.cache_memory_info()["pages_in_use"]
    with pytest.raises(serving.PayloadCorruption):
        transfer.install_request(dst, payload)
    src.check_invariants()
    dst.check_invariants()
    assert dst.cache_memory_info()["pages_in_use"] == before
    assert src.get_request(rid) is not None        # the source owns it
    # a clean payload still installs: the refusal left the target whole
    req = transfer.install_request(dst, src.export_pages(rid))
    assert req.request_id == payload["request_id"]


def test_migrate_books_stage_verify(sides):
    port = sides[1]
    src, rid, _ = _running_payload(port)
    dst = _engine(port)

    class CorruptingWire:
        """A source whose exported payloads are damaged in flight."""

        def get_request(self, r):
            return src.get_request(r)

        def export_pages(self, r):
            p = src.export_pages(r)
            _flip(p, which=1)
            return p

    with pytest.raises(serving.PayloadCorruption):
        transfer.migrate_request(CorruptingWire(), dst, rid)
    assert telemetry.value("pdt_transfer_failures_total",
                           stage="verify") == 1
    events = [e for e in telemetry.events()
              if e["name"] == "transfer.failed"]
    assert events and events[-1]["attrs"]["stage"] == "verify"
    src.check_invariants()
    dst.check_invariants()
    assert src.get_request(rid) is not None         # never evicted


def test_payload_site_corrupts_after_the_manifest(sides):
    """``transfer.payload`` armed in corrupt mode damages the serialized
    keys after the manifest: refused at ``stage="verify"``, and the
    source decodes on to the unmigrated stream."""
    port = sides[1]
    src, rid = _running(port, steps=1)
    dst = _engine(port)
    with faults.FaultInjector(seed=0) as fi:
        fi.arm_corrupt("transfer.payload", mode="bitflip", nth=1)
        with pytest.raises(serving.PayloadCorruption):
            transfer.migrate_request(src, dst, rid)
    assert telemetry.value("pdt_transfer_failures_total",
                           stage="verify") == 1
    assert dst.lifecycle_info()["running"] == 0
    ref = _engine(port)
    r = ref.add_request(*JOBS[0])
    assert src.run()[rid] == ref.run()[r]


# -- refusals and seams of other suites ----------------------------------
def test_import_pages_unpins_when_reserve_raises(sides):
    """tests/test_serving.py: the pins taken on the target's warm prefix
    are released when the reservation raises; the import then works."""
    port = sides[1]
    prompt = list(range(1, 11))
    src, rid = _running(port, job=(prompt, 6), steps=1, max_batch_size=1,
                        enable_prefix_caching=False)
    payload = src.export_pages(rid)
    dst = _engine(port)
    dst.add_request(prompt, 3)
    dst.run()                                # the trie holds the chain
    rc_before = dst._page_rc.copy()

    def boom(req, shared_pages=0):
        raise RuntimeError("reservation accounting exploded")
    dst._reserve_ok = boom
    with pytest.raises(RuntimeError, match="accounting"):
        dst.import_pages(payload)
    del dst._reserve_ok
    assert (dst._page_rc == rc_before).all()
    dst.check_invariants()
    req = dst.import_pages(payload)
    assert req.request_id == payload["request_id"]
    dst.check_invariants()


def test_export_pages_quiesces_first(sides):
    """tests/test_async_pipeline.py: a mid-window export (k = 4) sees
    every deferred token harvested."""
    eng = _engine(sides[1], harvest_every=4, enable_prefix_caching=False)
    rid = eng.add_request([1, 2, 3], 9)
    eng.step()
    eng.step()
    assert len(eng._pending) >= 1
    payload = eng.export_pages(rid)
    assert eng._pending == []
    assert len(payload["output"]) == len(eng.get_request(rid).output)


def test_import_pages_refuses_cross_model(sides):
    """tests/test_multimodel.py: a payload made under another hosted
    checkpoint is refused, counted ``{kind="import"}``; the source
    finishes its request."""
    port = sides[1]
    v2 = {n: p.detach() * 1.5 for n, p in port.model.named_parameters()}
    src = _engine(port, max_batch_size=3, enable_prefix_caching=False)
    src.install_weights(v2, tag="v2")
    rid = src.add_request([5, 4, 3, 2], 8)
    src.step()
    payload = src.export_pages(rid)
    dst = _engine(port, max_batch_size=3, enable_prefix_caching=False)
    with pytest.raises(serving.ModelMismatch, match="v2"):
        dst.import_pages(payload)
    assert telemetry.value("pdt_model_mismatch_total", kind="import") == 1
    assert len(src.run()[rid]) == 8


def _deltas(sd, seed, rank=4, scale=0.5):
    """tests/test_multimodel.py `_deltas` on two matmuls."""
    rng = np.random.default_rng(seed)
    out = {}
    for nm in ("model.layers.0.self_attn.q_proj.weight",
               "model.layers.1.mlp.gate_proj.weight"):
        k, n = sd[nm].shape
        out[nm] = (rng.normal(size=(k, rank)).astype(np.float32) * scale,
                   rng.normal(size=(rank, n)).astype(np.float32) * scale)
    return out


def test_adapter_migration_equal_jax(sides):
    """A request under a resident adapter migrates mid-stream to an
    engine holding the same adapter and finishes with the JAX engine's
    unmigrated stream; an engine without the adapter refuses it,
    counted ``{kind="adapter"}``."""
    jax, port = sides
    job = ([7, 7, 1, 2], 8)
    want = _engine(jax, enable_prefix_caching=False)
    want.install_adapter("a1", _deltas(jax.sd, 1))
    r = want.add_request(*job, adapter="a1")
    want = want.run()[r]
    src, dst, bare = [_engine(port, enable_prefix_caching=False)
                      for _ in range(3)]
    for eng in (src, dst):
        eng.install_adapter("a1", _deltas(port.sd, 1))
    rid = src.add_request(*job, adapter="a1")
    src.step()
    src.step()
    with pytest.raises(serving.ModelMismatch, match="a1"):
        transfer.migrate_request(src, bare, rid)
    assert telemetry.value("pdt_model_mismatch_total", kind="adapter") == 1
    req, payload = transfer.migrate_request(src, dst, rid)
    assert payload["adapter"] == "a1"
    assert dst.run()[req.rid] == want


# -- int8 KV (tests/test_quant_serving.py TestQuantMigration) ------------
Q8 = dict(weights="int8", kv="int8")


@pytest.fixture(scope="module")
def quant_oracle(sides):
    eng = _engine(sides[0], quant=jserving.QuantServingConfig(**Q8),
                  enable_prefix_caching=False)
    r = eng.add_request(*JOBS[0])
    return eng.run()[r]


def _q(side, quant=True, **kw):
    q = side.mod.QuantServingConfig(**Q8) if quant else None
    return _engine(side, quant=q, **kw)


def test_quant_migrated_stream_bit_identical(sides, quant_oracle):
    """int8 pages and scales move verbatim: the migrated stream is the
    JAX int8 engine's unmigrated one."""
    port = sides[1]
    src = _q(port, enable_prefix_caching=False)
    rid = src.add_request(*JOBS[0])
    for _ in range(3):
        src.step()
    dst = _q(port, enable_prefix_caching=False)
    req, payload = transfer.migrate_request(src, dst, rid)
    while not req.done:
        dst.step()
    assert req.output == quant_oracle
    assert payload["kv_quant"] == "int8" and payload["kv_spec"][3] == "int8"


def test_quant_payload_bytes_honestly_reduced(sides):
    """int8 pages plus their f32 scale rows against f32 pages: at HK 1,
    D 16 and pages of 4, (64 + 16) / 256 bytes a page and layer; the
    transfer byte counter books exactly what `payload_nbytes` counts."""
    port = sides[1]
    sizes = {}
    for name, q in (("fp", False), ("quant", True)):
        src = _q(port, q)
        rid = src.add_request(*JOBS[0])
        src.step()
        _, payload = transfer.migrate_request(src, _q(port, q), rid)
        sizes[name] = transfer.payload_nbytes(payload)
    assert sizes["quant"] / sizes["fp"] == (64 + 16) / 256
    assert telemetry.value("pdt_transfer_bytes_total") \
        == sizes["fp"] + sizes["quant"]


@pytest.mark.parametrize("direction", ["quant_to_fp", "fp_to_quant"])
def test_quant_cross_mode_migration_refused(sides, direction):
    port = sides[1]
    src_q = direction == "quant_to_fp"
    src = _q(port, src_q)
    rid = src.add_request(*JOBS[0])
    src.step()
    dst = _q(port, not src_q)
    with pytest.raises(serving.QuantMismatch, match="cross-quant-mode"):
        transfer.migrate_request(src, dst, rid)
    assert telemetry.value("pdt_quant_mode_mismatch_total",
                           kind="import") == 1
    assert telemetry.value("pdt_transfer_failures_total",
                           stage="install") == 1
    req = src.get_request(rid)
    while not req.done:
        src.step()
    src.check_invariants()
    dst.check_invariants()


def test_quant_corrupt_scale_refused_by_verify(sides):
    port = sides[1]
    src = _q(port)
    rid = src.add_request(*JOBS[0])
    src.step()
    payload = src.export_pages(rid)
    ks, vs = payload["kv_scales"][0]
    ks = ks.clone()
    ks.view(-1)[0] += 0.5
    payload["kv_scales"][0] = (ks, vs)
    with pytest.raises(serving.PayloadCorruption, match="SCALE"):
        serving.verify_payload(payload)


def test_quant_spill_roundtrip_and_cross_mode_prefix_refusal(sides):
    """int8 chains spill with their scales (under 0.55 of the f32
    chain's bytes) and restore into a fresh int8 engine to the stream of
    an engine that prefilled the prefix itself; a chain of the other
    mode is refused both ways, counted ``{kind="prefix"}``."""
    port = sides[1]
    sys_p = list(range(1, 13))              # 3 full pages of 4
    prompt = sys_p + [55, 56]
    stores = {}
    for q in (True, False):
        src = _q(port, q)
        rid = src.add_request(prompt, 6)
        src.step()
        stores[q] = FleetPrefixStore(page_size=4)
        assert stores[q].spill_payload(src.export_pages(rid)) == 3
    assert stores[True].spilled_bytes / stores[False].spilled_bytes < 0.55
    entry = stores[True].fetch(sys_p + [60])
    assert entry is not None and len(entry) == 3      # the scales ride
    fresh = _q(port)
    assert fresh.import_prefix(*entry) == 3
    r2 = fresh.add_request(prompt, 6)
    out = fresh.run()[r2]
    ref = _q(port)
    r3 = ref.add_request(prompt, 6)
    assert ref.run()[r3] == out and fresh.prefix_hits >= 1
    with pytest.raises(serving.QuantMismatch, match="prefix"):
        _q(port, False).import_prefix(*entry)
    fp_entry = stores[False].fetch(sys_p + [60])
    assert fp_entry is not None and len(fp_entry) == 2
    with pytest.raises(serving.QuantMismatch, match="prefix"):
        fresh.import_prefix(*fp_entry)
    assert telemetry.value("pdt_quant_mode_mismatch_total",
                           kind="prefix") == 2


# -- speculative decoding -------------------------------------------------
def test_spec_engine_migrated_mid_stream_equal_jax(sides):
    """A spec engine's request migrates after two rounds: the payload
    carries the target's pages only, the target backfills the draft
    cache once from the migrated stream, and the streams and
    `spec_info()` of both ends equal the JAX engines'."""
    outs = []
    for side in sides:
        spec = side.mod.SpecConfig(side.draft, k=2)
        src = _engine(side, spec_decode=spec, enable_prefix_caching=False)
        dst = _engine(side, spec_decode=spec, enable_prefix_caching=False)
        rids = [src.add_request(p, n) for p, n in JOBS[:2]]
        src.step()
        src.step()
        req, payload = side.transfer.migrate_request(src, dst, rids[0])
        done = {}
        while _busy(src) or _busy(dst):
            for eng in (src, dst):
                for r in eng.step():
                    done[r.request_id] = r.output
        outs.append({"streams": done, "src": src.spec_info(),
                     "dst": dst.spec_info(), "meta": _payload_view(payload)})
        if side is sides[1]:
            assert dst.num_draft_prefills == 1
    assert outs[1] == outs[0]
    assert outs[1]["dst"]["rounds"] >= 1


# -- across packages -------------------------------------------------------
@pytest.fixture(scope="module")
def wire(sides):
    """Each package's payload of JOBS[0] after two steps."""
    out = {}
    for side in sides:
        src, rid = _running(side)
        out[side.name] = src.export_pages(rid)
    return out


def test_wire_payloads_agree(wire):
    jp, tp = wire["jax"], wire["port"]
    assert sorted(tp) == sorted(jp)
    assert _payload_view(tp) == _payload_view(jp)
    assert tp["kv_spec"] == (2, 1, 16, "float32")
    for (jk, jv), (tk, tv) in zip(jp["kv"], tp["kv"]):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_wire_jax_payload_installs_in_port(sides, oracle, wire):
    jp = wire["jax"]
    serving.verify_payload(jp)                      # JAX's manifest
    assert serving.payload_checksums(jp) == jp["kv_sha256"]
    dst = _engine(sides[1])
    req = dst.import_pages(jp)
    assert dst.run()[req.rid] == oracle[0]


def test_wire_port_payload_installs_in_jax(sides, oracle, wire):
    tp = wire["port"]
    jserving.verify_payload(tp)                     # the port's manifest
    as_numpy = dict(tp, kv=[(k.numpy(), v.numpy()) for k, v in tp["kv"]])
    assert jserving.payload_checksums(as_numpy) == tp["kv_sha256"]
    dst = _engine(sides[0])
    req = dst.import_pages(as_numpy)
    assert dst.run()[req.rid] == oracle[0]


def test_install_and_scatter_program_keys_equal_jax(sides):
    """The install programs by page count and the legacy scatter
    programs by row count, in LRU order, and the program families
    compiled, equal the JAX engine's (`_install_jits`, `_scatter_jits`,
    ``pdt_jit_compiles_total``)."""
    keys = []
    for side in sides:
        eng = _engine(side, attention_impl="legacy", prompt_pad=4)
        for p, n in JOBS[:3]:
            eng.add_request(p, n)
        eng.run()
        for job, steps in ((JOBS[3], 1), ((list(range(1, 20)), 4), 1)):
            src, rid = _running(side, job=job, steps=steps,
                                enable_prefix_caching=False)
            eng.import_pages(src.export_pages(rid))
        eng.run()
        if side is sides[0]:
            got = (list(eng._install_jits), list(eng._scatter_jits))
        else:
            got = (list(eng._install_programs), list(eng._scatter_programs))
        fams = set(side.telemetry.snapshot()["counters"][
            "pdt_jit_compiles_total"])
        keys.append((got, fams))
    assert keys[1] == keys[0]
    assert {'family="install"', 'family="scatter"'} <= keys[1][1]
