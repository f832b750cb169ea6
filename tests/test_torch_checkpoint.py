"""The port's checkpoint files and state against the JAX package's, on the
CPU: `paddle_tpu_torch.save` / `load` (the ``PTPU0001`` container), the
integrity manifest (`array_checksum`, `describe_arrays`, `build_manifest`,
`parse_done`), the state-dict checkpoint of
`paddle_tpu_torch.distributed.checkpoint`, the optimizer's and the
scheduler's state, and a resumed tiny Llama run.

- a JAX ``paddle.save`` of a tiny Llama's state dict loads in the port
  and, through `llama_state_from_numpy`, gives JAX's logits within
  `tests/test_torch_llama.py`'s f32 tolerance (atol 1e-4, rtol 1e-4);
- port files round-trip bf16, f32, int, bool and nested containers
  bitwise; one flipped byte raises the crc error, in a port file and in
  a JAX one;
- checksums and manifest entries equal JAX's on the same numpy arrays,
  bf16 included, and a manifest has JAX's keys, level for level;
- six `TrainStep`s of a tiny Llama under `AdamW` and `LinearWarmup`
  equal, bitwise, three steps, a checkpoint, fresh objects, `resume` and
  three more: losses, parameters, moments, master weights (bf16 with
  ``multi_precision``) and the scheduler; the f32 run's losses equal the
  JAX package's six steps within `tests/test_torch_train.py`'s loss
  tolerance (rtol 1e-5);
- the resume drill of both packages prints the same lines."""
import io
import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability as jtelemetry
from paddle_tpu.distributed.checkpoint import manifest as jmanifest
from paddle_tpu.models import llama as jl
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer.lr import LinearWarmup as JLinearWarmup
from recipes import llama_pretrain as jrecipe

import paddle_tpu_torch
import paddle_tpu_torch.observability as telemetry
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import llama_state_from_numpy
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import LinearWarmup
from paddle_tpu_torch.recipes import llama_pretrain
from paddle_tpu_torch.utils import faults

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Recording on, both registries and trace rings empty; the drills'
    `enable()` is undone after each test, and the registries and rings
    are emptied again so no series outlives the test."""
    monkeypatch.setenv("PDT_TELEMETRY", "1")
    for t in (telemetry, jtelemetry):
        t.reset()
        t.clear_events()
    yield
    for t in (telemetry, jtelemetry):
        t.disable(clear_override=True)
        t.reset()
        t.clear_events()


def _jax_tiny(seed=11):
    paddle.seed(seed)
    return jl.LlamaForCausalLM(jl.LlamaConfig.tiny())


def _ids(b=2, s=32, seed=0):
    ids = np.random.default_rng(seed).integers(0, 512, (b, s + 1))
    return ids[:, :-1].astype(np.int32), ids[:, 1:].astype(np.int32)


# -- paddle.save / paddle.load --------------------------------------------

@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    """A tiny JAX Llama, its state dict written by ``paddle.save``."""
    jm = _jax_tiny()
    path = str(tmp_path_factory.mktemp("jax") / "llama.pdparams")
    paddle.save(jm.state_dict(), path)
    return jm, path


def test_jax_llama_file_gives_jax_logits(jax_file):
    jm, path = jax_file
    sd = paddle_tpu_torch.load(path, return_numpy=True)
    tm = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), device="cpu")
    tm.load_state_dict(llama_state_from_numpy(sd, tm))
    x, _ = _ids()
    jlog = np.asarray(jm(paddle.to_tensor(x))._value)
    with torch.no_grad():
        tlog = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tlog, jlog, **LOGIT_TOL)
    # as tensors: the same bytes, on the device asked for
    tens = paddle_tpu_torch.load(path, device="cpu")
    for k, v in sd.items():
        assert tens[k].device.type == "cpu"
        np.testing.assert_array_equal(tens[k].detach().numpy(), v)


def test_jax_file_with_a_flipped_byte_raises(jax_file, tmp_path):
    _, path = jax_file
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    bad = tmp_path / "bad.pdparams"
    bad.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="crc32 mismatch"):
        paddle_tpu_torch.load(str(bad), device="cpu")


def _nested():
    g = torch.Generator().manual_seed(0)
    p = torch.nn.Parameter(torch.randn(3, 5, generator=g))
    frozen = torch.nn.Parameter(torch.randn(2, generator=g),
                                requires_grad=False)
    return {
        "bf16": torch.randn(4, 6, generator=g).to(torch.bfloat16),
        "f32": torch.randn(7, generator=g),
        "i64": torch.arange(-5, 5),
        "i32": torch.arange(12, dtype=torch.int32).reshape(3, 4),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5, dtype=torch.float64),
        "param": p, "frozen": frozen,
        "nested": {"list": [torch.ones(2), 3, "text"],
                   "tuple": (torch.zeros(1, dtype=torch.int8), None)},
        "step": 7,
    }


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        assert b.shape == a.shape and torch.equal(b, a)
        assert isinstance(b, torch.nn.Parameter) == \
            isinstance(a, torch.nn.Parameter)
        assert b.requires_grad == a.requires_grad
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_port_file_round_trips_bitwise(tmp_path):
    obj = _nested()
    path = str(tmp_path / "sub" / "obj.pd")
    paddle_tpu_torch.save(obj, path)
    _assert_same(obj, paddle_tpu_torch.load(path, device="cpu"))
    buf = io.BytesIO()                       # a file object, both ways
    paddle_tpu_torch.save(obj, buf)
    buf.seek(0)
    _assert_same(obj, paddle_tpu_torch.load(buf, device="cpu"))
    got = paddle_tpu_torch.load(path, return_numpy=False, device="cpu")
    assert got["bf16"].view(torch.int16).tolist() == \
        obj["bf16"].view(torch.int16).tolist()
    with pytest.raises(TypeError, match="bfloat16"):
        paddle_tpu_torch.load(path, return_numpy=True)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(ValueError, match="corrupt tensor payload"):
        paddle_tpu_torch.load(path, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            paddle_tpu_torch.load(str(tmp_path / "sub" / "obj.pd"))


# -- the manifest ----------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(3)
    return {
        "w": rng.standard_normal((5, 3)).astype(np.float32),
        "b16": rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16),
        "idx": rng.integers(0, 9, (6,)).astype(np.int32),
        "s": np.asarray(1.25, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }


def test_checksums_and_entries_equal_jax():
    arrays = _arrays()
    for k, a in arrays.items():
        assert ckpt.array_checksum(a) == jmanifest.array_checksum(a), k
    assert ckpt.describe_arrays(arrays) == \
        jmanifest.describe_arrays(arrays)
    # a torch bf16 tensor of the same bits: the same digest
    b16 = torch.from_numpy(arrays["b16"].view(np.int16)).view(torch.bfloat16)
    assert ckpt.array_checksum(b16) == \
        jmanifest.array_checksum(arrays["b16"])


def test_manifest_schema_matches_jax_key_for_key():
    arrays = _arrays()
    groups = {"model": arrays, "opt": {"@step": np.asarray(3, np.int32)}}
    got = ckpt.build_manifest(groups, step=4, wall_time=5.0)
    want = jmanifest.build_manifest(groups, step=4, wall_time=5.0)

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}
    assert keys(got) == keys(want)
    for k in ("format", "version", "step", "wall_time", "groups"):
        assert got[k] == want[k], k
    assert sorted(got["mesh"]) == sorted(want["mesh"])


PAYLOADS = [("zero_byte", ""), ("garbage", "not-a-time\x00"),
            ("bare_float", "1234.5"), ("bare_int", "17"),
            ("json", '{"step": 3, "time": 9.5}'), ("bool", "true"),
            ("list", "[1, 2]"), ("spaces", "  \n")]


@pytest.mark.parametrize("payload", PAYLOADS, ids=[p[0] for p in PAYLOADS])
def test_parse_done_agrees_with_jax(tmp_path, payload):
    path = tmp_path / ".done"
    path.write_text(payload[1])
    assert ckpt.parse_done(str(path)) == jmanifest.parse_done(str(path))
    assert ckpt.parse_done(str(tmp_path / "missing")) is None


# -- the state-dict checkpoint --------------------------------------------

def test_state_dict_round_trip_in_place_and_raw(tmp_path):
    g = torch.Generator().manual_seed(1)
    sd = {"a": torch.randn(3, 4, generator=g).to(torch.bfloat16),
          "sub": {"b": torch.arange(5), "c": torch.randn(2, generator=g)},
          "n": 3, "lr": 0.1}
    path = str(tmp_path / "g")
    assert ckpt.save_state_dict(sd, path) is None
    meta = json.loads(open(os.path.join(path, "metadata.json")).read())
    assert sorted(meta["arrays"]) == ["a", "lr", "n", "sub.b", "sub.c"]
    assert meta["arrays"]["lr"]["dtype"] == "float64"
    target = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
              "sub": {"b": torch.zeros(5, dtype=torch.int64),
                      "c": torch.zeros(2)}}
    ckpt.load_state_dict(target, path)
    assert torch.equal(target["a"], sd["a"])
    assert torch.equal(target["sub"]["b"], sd["sub"]["b"])
    raw = ckpt.load_state_dict_raw(path, device="cpu")
    assert raw["n"].item() == 3 and raw["lr"].item() == 0.1
    assert torch.equal(raw["sub.c"], sd["sub"]["c"])
    assert telemetry.value("pdt_checkpoint_ops_total", op="load") == 2
    assert telemetry.value("pdt_checkpoint_bytes_total", op="save") == \
        3 * 4 * 2 + 5 * 8 + 2 * 4 + 8 + 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ckpt.load_state_dict_raw(path)


@pytest.mark.parametrize("bad", ["dtype", "shape", "missing"])
def test_load_refuses_a_mismatch_before_writing(tmp_path, bad):
    path = str(tmp_path / "g")
    ckpt.save_state_dict({"w": torch.ones(2, 3)}, path)
    t = {"dtype": torch.zeros(2, 3, dtype=torch.float64),
         "shape": torch.zeros(3, 2), "missing": torch.zeros(2, 3)}[bad]
    target = {"x" if bad == "missing" else "w": t}
    with pytest.raises(KeyError if bad == "missing" else ValueError):
        ckpt.load_state_dict(target, path)
    assert not t.any()


def test_flipped_bytes_fail_the_load_and_leave_targets(tmp_path):
    path = str(tmp_path / "step")
    ckpt.save_state_dict({"w": torch.ones(64), "v": torch.ones(8)},
                         os.path.join(path, "model"))
    assert faults.flip_checkpoint_shards(path) == 1
    target = {"w": torch.zeros(64), "v": torch.zeros(8)}
    with pytest.raises(ckpt.CorruptArray, match="crc32"):
        ckpt.load_state_dict(target, os.path.join(path, "model"))
    assert not target["w"].any() and not target["v"].any()
    with pytest.raises(FileNotFoundError):
        faults.flip_checkpoint_shards(path, group="opt")


def test_async_save_counts_when_the_bytes_land(tmp_path):
    sd = {"w": torch.arange(6.0)}
    handle = ckpt.save_state_dict(sd, str(tmp_path / "a"), async_save=True)
    sd["w"].add_(100)                 # the save took its bytes already
    assert telemetry.value("pdt_checkpoint_ops_total", op="save") == 0
    with faults.FaultInjector() as fi:
        fi.arm("checkpoint.write", nth=1)
        with pytest.raises(faults.FaultError):
            handle.wait_until_finished()
    handle.wait_until_finished()
    handle.wait_until_finished()
    assert telemetry.value("pdt_checkpoint_ops_total", op="save") == 1
    out = {"w": torch.zeros(6)}
    ckpt.load_state_dict(out, str(tmp_path / "a"))
    assert torch.equal(out["w"], torch.arange(6.0))


def test_verify_cli_module_exit_codes(tmp_path):
    em = ElasticManager(str(tmp_path), save_interval_steps=1)
    em.save(0, torch.nn.Linear(2, 2))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.checkpoint",
           "verify"]
    ok = subprocess.run(cmd + [str(tmp_path), "--rehash"], cwd=ROOT,
                        capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0 and ok.stdout.startswith("OK")
    faults.flip_checkpoint_shards(str(tmp_path / "step_0"))
    bad = subprocess.run(cmd + [str(tmp_path / "step_0"), "--rehash"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode == 1 and "CORRUPT" in bad.stdout


# -- optimizer and scheduler state ----------------------------------------

def test_optimizer_state_has_the_jax_form():
    jm = _jax_tiny()
    tm = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), device="cpu")
    jsched = JLinearWarmup(1e-3, warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    tsched = LinearWarmup(1e-3, warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    jopt = JAdamW(learning_rate=jsched, parameters=jm.parameters())
    topt = AdamW(learning_rate=tsched, parameters=tm.parameters())
    x, y = _ids()
    jloss, _ = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    jloss.backward()
    jopt.step()
    tm(torch.from_numpy(x), labels=torch.from_numpy(y))[0].backward()
    topt.step()
    jsched.step()
    tsched.step()
    jsd, tsd = jopt.state_dict(), topt.paddle_state_dict()

    def families(sd):
        return {k.split("_")[0] if "_" in k and k[0] != "L" else k
                for k in sd}
    assert families(tsd) == families(jsd) == {"moment1", "moment2",
                                              "LR_Scheduler", "@step"}
    # one moment of each kind for every parameter, keyed by its index (a
    # torch parameter has no Paddle name; the JAX keys use the names,
    # which repeat across its layers: its dict keeps 3 of the 21)
    n = len(list(tm.parameters()))
    assert [k for k in tsd if k.startswith("moment1_")] == \
        [f"moment1_{i}" for i in range(n)]
    assert tsd["@step"] == jsd["@step"] == 1
    assert tsd["LR_Scheduler"] == jsd["LR_Scheduler"]


def _tiny_run(tmp, init, dtype, steps, resume_at=None):
    """``steps`` AdamW `TrainStep`s of the tiny Llama (weights ``init``,
    JAX's) under `LinearWarmup`; with ``resume_at`` k, a checkpoint after
    step k, every object rebuilt (the model from another seed), `resume`,
    and the rest."""
    mp = dtype == torch.bfloat16
    x, y = (torch.from_numpy(a) for a in _ids(seed=4))

    def build(weights):
        m = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), device="cpu",
                                dtype=dtype, seed=8)
        if weights is not None:
            m.load_state_dict(llama_state_from_numpy(weights, m))
        sched = LinearWarmup(1e-3, warmup_steps=2, start_lr=0.0,
                             end_lr=1e-3)
        opt = AdamW(learning_rate=sched, parameters=m.parameters(),
                    weight_decay=0.01, multi_precision=mp)
        step = TrainStep(m, opt, loss_fn=lambda mm, a, b: mm(a,
                                                             labels=b)[0])
        return m, sched, opt, step

    m, sched, opt, step = build(init)
    losses, start = [], 0
    em = ElasticManager(str(tmp), save_interval_steps=1)
    for i in range(steps):
        if i == resume_at:
            em.save(i - 1, m, opt)
            del m, sched, opt, step
            m, sched, opt, step = build(None)
            start = em.resume(m, opt)
        losses.append(float(step(x, y)))
        sched.step()
    return losses, m, sched, opt, start


@pytest.fixture(scope="module")
def jax_six_steps():
    """The tiny JAX Llama's weights, and its losses over six AdamW
    `TrainStep`s under `LinearWarmup` on `_tiny_run`'s batch."""
    jm = _jax_tiny()
    init = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    jsched = JLinearWarmup(1e-3, warmup_steps=2, start_lr=0.0, end_lr=1e-3)
    jopt = JAdamW(learning_rate=jsched, parameters=jm.parameters(),
                  weight_decay=0.01)
    jstep = paddle.jit.TrainStep(jm, jopt,
                                 loss_fn=lambda mm, a, b: mm(a, labels=b)[0])
    x, y = _ids(seed=4)
    losses = []
    for _ in range(6):
        losses.append(float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))))
        jsched.step()
    return init, losses


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16_master"])
def test_resumed_run_equals_uninterrupted_bitwise(tmp_path, dtype,
                                                  jax_six_steps):
    init, jlosses = jax_six_steps
    full = _tiny_run(tmp_path / "a", init, dtype, 6)
    cut = _tiny_run(tmp_path / "b", init, dtype, 6, resume_at=3)
    assert cut[4] == 3
    assert cut[0] == full[0]
    for (n, p), (_, q) in zip(full[1].named_parameters(),
                              cut[1].named_parameters()):
        assert torch.equal(p, q), n
    a, b = full[3].paddle_state_dict(), cut[3].paddle_state_dict()
    assert sorted(a) == sorted(b)
    assert any(k.startswith("master_") for k in a) == \
        (dtype == torch.bfloat16)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == torch.float32 and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    assert full[2].state_dict() == cut[2].state_dict()
    if dtype == torch.float32:
        np.testing.assert_allclose(cut[0], jlosses, rtol=1e-5)


# -- the resume drill --------------------------------------------------------

def _drill_lines(text):
    keep = []
    for line in text.splitlines():
        if "bytes_total" in line or "verify_seconds" in line:
            continue                  # widths of @step, host timings
        keep.append(line)
    return keep


def test_resume_drill_prints_the_jax_lines(tmp_path, capsys):
    jm = _jax_tiny()
    jrecipe.run_resume_drill(
        jm, JAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                   weight_decay=0.01), str(tmp_path / "jax"))
    want = _drill_lines(capsys.readouterr().out)
    tm = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), device="cpu")
    llama_pretrain.run_resume_drill(
        tm, AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                  weight_decay=0.01), str(tmp_path / "port"))
    got = _drill_lines(capsys.readouterr().out)
    assert got == want
    assert "resume fell back to start step 1 (quarantined: " \
        "['step_1.corrupt'])" in got
