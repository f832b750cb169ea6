"""The port's durable checkpoints (`paddle_tpu_torch.distributed`) against
the JAX package's, on the CPU: the scenarios of
`tests/test_elastic_robustness.py` (`TestAtomicCommitProtocol`,
`TestLightVerifyTier`, `TestCorruptionTolerantResume`, `TestDurableGc`,
`TestHeartbeatRobustness`, `TestWaitForPeersClock`, `TestRestartBackoff`
without the launcher) and `tests/test_chaos.py::TestCheckpointChaos`.

Where the reference passes, each scenario runs on both packages (a
`Linear(4, 4)` from a seed, `Adam` after one step) with the reference's
assertions, and the two runs must agree on every step returned, the
checkpoint root's listing two levels deep, the `pdt_checkpoint_*`,
`pdt_faults_*` and `pdt_elastic_*` series (the byte counters aside: the
port keeps ``@step`` as int64, JAX as int32) and the sequence of
``checkpoint.*`` and ``fault.*`` trace events. Where the reference's own
test fails (its light verify tier reads orbax metadata through an API
that changed: `StepMetadata` is not iterable), the port is held to
``docs/checkpointing.md``: the light tier checks structure against
metadata without reading array bytes, checksums are the rehash tier's
job, and flipped bytes the light tier cannot see are caught by the load's
own check (the storage format's crc32, as OCDBT's CRC catches them in
JAX) and quarantined as a load failure."""
import json
import os
import random
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.observability as jtelemetry
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import checkpoint as jckpt
from paddle_tpu.distributed.checkpoint.__main__ import main as jcli
from paddle_tpu.distributed.fleet import elastic as jelastic
from paddle_tpu.distributed.launch import restart_backoff as jbackoff
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.utils import faults as jfaults

import paddle_tpu_torch.observability as telemetry
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.checkpoint import storage
from paddle_tpu_torch.distributed.checkpoint.__main__ import main as pcli
from paddle_tpu_torch.distributed.fleet import elastic
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.utils import faults

MANIFEST = "MANIFEST.json"


def _jax_net(seed=0):
    paddle.seed(seed)
    return jnn.Linear(4, 4)


def _jax_shift(net, w):
    net.weight._value = paddle.to_tensor(w)._value


def _jax_adam(net):
    opt = JAdam(learning_rate=1e-2, parameters=net.parameters())
    loss = (net(paddle.to_tensor(np.ones((2, 4), np.float32))) ** 2).sum()
    loss.backward()
    opt.step()
    opt.clear_grad()
    return opt


def _port_net(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Linear(4, 4)


def _port_shift(net, w):
    with torch.no_grad():
        net.weight.copy_(torch.from_numpy(w))


def _port_adam(net):
    opt = Adam(learning_rate=1e-2, parameters=net.parameters())
    (net(torch.ones(2, 4)) ** 2).sum().backward()
    opt.step()
    opt.zero_grad()
    return opt


SIDES = {
    "jax": types.SimpleNamespace(
        ckpt=jckpt, elastic=jelastic, faults=jfaults, telemetry=jtelemetry,
        net=_jax_net, adam=_jax_adam, set_weight=_jax_shift,
        weight=lambda n: np.array(n.weight.numpy()),
        flip=jfaults.flip_ocdbt_shards),
    "port": types.SimpleNamespace(
        ckpt=ckpt, elastic=elastic, faults=faults, telemetry=telemetry,
        net=_port_net, adam=_port_adam, set_weight=_port_shift,
        weight=lambda n: n.weight.detach().numpy().copy(),
        flip=faults.flip_checkpoint_shards),
}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Recording on, both registries and trace rings empty, before each
    test and again after it, so no series outlives the test."""
    monkeypatch.setenv("PDT_TELEMETRY", "1")
    for t in (telemetry, jtelemetry):
        t.reset()
        t.clear_events()
    yield
    for t in (telemetry, jtelemetry):
        t.reset()
        t.clear_events()


def _em(s, root, **kw):
    kw.setdefault("save_interval_steps", 1)
    kw.setdefault("sleep", lambda _: None)   # no real backoff waits
    return s.elastic.ElasticManager(str(root), **kw)


def _listing(root):
    """The root's entries, each directory with its own entries."""
    return {n: sorted(os.listdir(os.path.join(root, n)))
            if os.path.isdir(os.path.join(root, n)) else None
            for n in sorted(os.listdir(root))}


def _observed(s):
    """What a run leaves in the telemetry: the checkpoint, fault and
    elastic series (byte counters aside), verify passes, and the
    ``checkpoint.*`` / ``fault.*`` events in order."""
    snap = s.telemetry.snapshot()
    out = {name: series for kind in ("counters", "gauges")
           for name, series in snap[kind].items()
           if name.startswith(("pdt_checkpoint", "pdt_faults",
                               "pdt_elastic"))
           and name != "pdt_checkpoint_bytes_total"}
    # staleness is read on the host's clock: its series, not its values
    stale = "pdt_elastic_heartbeat_staleness_seconds"
    if stale in out:
        out[stale] = sorted(out[stale])
    hist = snap["histograms"].get("pdt_checkpoint_verify_seconds", {})
    out["verify_passes"] = {k: v["count"] for k, v in hist.items()}
    out["events"] = [e["name"] for e in s.telemetry.events()
                     if e["name"].startswith(("checkpoint.", "fault."))]
    return out


def _both(tmp_path, scenario):
    """Run ``scenario(side, root)`` on both packages; the port must give
    what the reference gives, steps, listing and telemetry alike."""
    out = {}
    for name, s in SIDES.items():
        root = tmp_path / name
        root.mkdir()
        got = scenario(s, root)
        out[name] = (got, _listing(root), _observed(s))
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2]
    return out


class TestRestartBackoff:
    def test_exponential_envelope_jitter_and_cap(self):
        rng = random.Random(0)
        delays = [elastic.restart_backoff(a, 1.0, 60.0, rng)
                  for a in range(1, 9)]
        for k, d in enumerate(delays, start=1):
            assert min(0.5 * 2.0 ** (k - 1), 60.0) <= d <= 60.0, (k, d)
            assert d <= 1.5 * 2.0 ** (k - 1)
        assert delays[7] == 60.0
        rng2 = random.Random(0)
        assert delays == [jbackoff(a, 1.0, 60.0, rng2) for a in range(1, 9)]
        assert elastic.restart_backoff(3, 0.0, 60.0, rng) == 0.0


class TestHeartbeatRobustness:
    def test_corrupt_beat_is_stale_not_fatal(self, tmp_path):
        def scenario(s, root):
            hb = s.elastic.HeartbeatMembership(str(root), rank=0,
                                               timeout=5.0)
            hb.heartbeat()
            seen = [hb.alive()]
            with open(hb._beat_path(1), "w"):
                pass                          # empty file, fresh mtime
            with open(hb._beat_path(2), "w") as f:
                f.write("not-a-timestamp\x00")
            seen += [hb.alive(), hb.poll()["alive"]]
            s.elastic.HeartbeatMembership(str(root), rank=1).heartbeat()
            seen.append(hb.alive())
            assert seen == [{0}, {0}, {0}, {0, 1}]
            return seen
        _both(tmp_path, scenario)

    def test_exactly_at_timeout_beat_is_alive(self, tmp_path):
        def scenario(s, root):
            t0 = 1000.0
            hb = s.elastic.HeartbeatMembership(str(root), rank=0,
                                               timeout=5.0,
                                               clock=lambda: t0 + 5.0)
            hb.heartbeat()
            os.utime(hb._beat_path(0), (t0, t0))
            at = hb.alive()
            hb._clock = lambda: t0 + 5.0 + 1e-3
            past = hb.alive()
            assert at == {0} and past == set()
            return at, past
        _both(tmp_path, scenario)

    def test_stale_eviction_and_scale_classification(self, tmp_path):
        def scenario(s, root):
            clk = {"t": 1000.0}
            watch = s.elastic.HeartbeatMembership(
                str(root), timeout=5.0, clock=lambda: clk["t"])

            def beat(rank):
                s.elastic.HeartbeatMembership(str(root),
                                              rank=rank).heartbeat()
                os.utime(os.path.join(str(root), f"worker_{rank}.hb"),
                         (clk["t"], clk["t"]))

            def age(rank):
                os.utime(os.path.join(str(root), f"worker_{rank}.hb"),
                         (clk["t"] - 6.0, clk["t"] - 6.0))

            beat(0)
            beat(1)
            polls = [watch.poll()]
            beat(2)
            polls.append(watch.poll())
            age(0)
            polls.append(watch.poll())
            age(1)
            beat(3)
            polls.append(watch.poll())
            clk["t"] += 100.0
            polls.append(watch.poll())
            assert [p["event"] for p in polls] == [
                None, "scale_up", "scale_down", "scale_down", "scale_down"]
            assert polls[3]["dead"] == {1} and polls[3]["joined"] == {3}
            assert polls[4]["alive"] == set()
            return polls
        _both(tmp_path, scenario)


class TestAtomicCommitProtocol:
    def test_save_commits_manifest_done_and_verifies(self, tmp_path):
        def scenario(s, root):
            _em(s, root).save(0, s.net())
            step = root / "step_0"
            manifest = json.loads((step / MANIFEST).read_text())
            assert manifest["format"] == "paddle-tpu-ckpt-manifest"
            assert manifest["step"] == 0 and manifest["wall_time"] > 0
            assert manifest["mesh"]["device_count"] >= 1
            w = manifest["groups"]["model"]["weight"]
            assert w["shape"] == [4, 4] and w["dtype"] == "float32"
            assert w["nbytes"] == 64 and w["checksum"].startswith("sha256:")
            done = s.ckpt.parse_done(str(step / ".done"))
            assert done["step"] == 0 and done["time"] > 0
            res = s.ckpt.verify_checkpoint(str(step), rehash=True)
            assert res.ok and res.arrays_checked == 2 and res.step == 0
            return (sorted(manifest), sorted(manifest["groups"]["model"]),
                    sorted(w), res.arrays_checked)
        _both(tmp_path, scenario)

    def test_latest_checkpoint_rejects_unparsable_done(self, tmp_path):
        def scenario(s, root):
            good = root / "step_1"
            good.mkdir()
            (good / ".done").write_text('{"step": 1, "time": 5.0}')
            for name, payload in (("step_2", ""), ("step_3",
                                                   "not-a-time\x00"),
                                  ("step_4", "[1, 2]"), ("step_5", "true")):
                (root / name).mkdir()
                (root / name / ".done").write_text(payload)
            first = os.path.basename(s.elastic.latest_checkpoint(str(root)))
            (root / "step_2" / ".done").write_text("1234.5")
            second = os.path.basename(s.elastic.latest_checkpoint(str(root)))
            steps = [n for n, _ in s.elastic.complete_checkpoints(str(root))]
            assert (first, second, steps) == ("step_1", "step_2", [2, 1])
            return first, second, steps
        _both(tmp_path, scenario)

    def test_finalize_fault_retries_in_place(self, tmp_path):
        def scenario(s, root):
            sleeps = []
            em = _em(s, root, save_retries=3, sleep=sleeps.append,
                     rng=random.Random(7))
            with s.faults.FaultInjector() as fi:
                fi.arm("checkpoint.finalize", nth=1)
                em.save(0, s.net())
            assert fi.trips("checkpoint.finalize") == 1
            assert sleeps == [jbackoff(1, em.retry_backoff,
                                       em.retry_backoff_max,
                                       random.Random(7))]
            assert s.telemetry.value(
                "pdt_checkpoint_save_retries_total") == 1
            assert s.ckpt.verify_checkpoint(str(root / "step_0"),
                                            rehash=True).ok
            return sleeps
        _both(tmp_path, scenario)

    def test_write_fault_exhausts_retries_leaves_torn_tmp(self, tmp_path):
        def scenario(s, root):
            em = _em(s, root, save_retries=2)
            net = s.net()
            with s.faults.FaultInjector() as fi:
                fi.arm("checkpoint.write", always=True)
                with pytest.raises(s.faults.FaultError):
                    em.save(0, net)
            assert fi.trips("checkpoint.write") == 2
            torn = _listing(root)
            assert "step_0" not in torn and "step_0.tmp" in torn
            assert MANIFEST not in torn["step_0.tmp"]
            assert s.elastic.latest_checkpoint(str(root)) is None
            em.save(0, net)               # fault cleared: tmp reclaimed
            assert s.ckpt.verify_checkpoint(str(root / "step_0"),
                                            rehash=True).ok
            return torn
        _both(tmp_path, scenario)

    def test_resave_same_step_replaces_without_droppings(self, tmp_path):
        def scenario(s, root):
            net = s.net()
            em = _em(s, root)
            em.save(0, net)
            w0 = s.weight(net)
            s.set_weight(net, w0 + 1.0)
            em.save(0, net)
            assert sorted(os.listdir(root)) == ["step_0"]
            assert s.ckpt.verify_checkpoint(str(root / "step_0"),
                                            rehash=True).ok
            net2 = s.net(seed=9)
            start = em.resume(net2)
            np.testing.assert_array_equal(s.weight(net2), w0 + 1.0)
            return start
        _both(tmp_path, scenario)

    def test_crashed_resave_recovers_moved_aside_checkpoint(
            self, tmp_path):
        def scenario(s, root):
            net = s.net()
            em = _em(s, root)
            em.save(0, net)
            os.replace(root / "step_0", root / "step_0.old")
            (root / "step_0").mkdir()
            (root / "step_0" / MANIFEST).write_text("{}")      # torn
            assert s.elastic.latest_checkpoint(str(root)) is None
            net2 = s.net(seed=9)
            start = em.resume(net2)
            np.testing.assert_array_equal(s.weight(net2), s.weight(net))
            assert not (root / "step_0.old").exists()
            assert s.ckpt.verify_checkpoint(str(root / "step_0"),
                                            rehash=True).ok
            return start
        _both(tmp_path, scenario)

    def test_failed_recovery_rename_degrades_not_crashes(
            self, tmp_path, monkeypatch):
        def scenario(s, root):
            em = _em(s, root)
            em.save(0, s.net())
            os.replace(root / "step_0", root / "step_0.old")
            (root / "step_0").mkdir()
            (root / "step_0" / MANIFEST).write_text("{}")
            real_replace = os.replace

            def flaky_replace(src, dst, **kw):
                if str(src).endswith("step_0.old"):
                    raise OSError("Directory not empty")
                return real_replace(src, dst, **kw)

            with monkeypatch.context() as m:
                m.setattr(os, "replace", flaky_replace)
                degraded = em.resume(s.net(seed=9))
                assert (root / "step_0.old").exists()
            recovered = em.resume(s.net(seed=9))
            assert (degraded, recovered) == (0, 1)
            return degraded, recovered
        _both(tmp_path, scenario)

    def test_verify_cli(self, tmp_path, capsys):
        """The reference's test fails at its light tier; the CLI's exit
        codes per ``docs/checkpointing.md``: 0 iff every checkpoint
        verified is clean, 1 for an empty root. The light tier reads no
        array byte, so a flip under intact metadata is the rehash tier's
        to find; a truncated data file the light tier finds by size."""
        em = _em(SIDES["port"], tmp_path)
        net = _port_net()
        em.save(0, net)
        em.save(1, net)
        assert pcli(["verify", str(tmp_path), "--rehash"]) == 0
        assert pcli(["verify", str(tmp_path / "step_1")]) == 0
        faults.flip_checkpoint_shards(str(tmp_path / "step_1"))
        assert pcli(["verify", str(tmp_path), "--rehash"]) == 1
        assert pcli(["verify", str(tmp_path)]) == 0
        assert pcli(["verify", str(tmp_path / "empty-root")]) == 1
        data = tmp_path / "step_0" / "model" / "d" / "0"
        data.write_bytes(data.read_bytes()[:10])
        assert pcli(["verify", str(tmp_path / "step_0")]) == 1
        out = capsys.readouterr().out
        assert "CORRUPT" in out and "content checksum mismatch" in out
        assert "holds 10 bytes" in out
        # the CLI of each package names the same outcome for a root
        # with no checkpoint
        assert jcli(["verify", str(tmp_path / "empty-root")]) == 1


class TestLightVerifyTier:
    """verify_on_resume='light' / verify_checkpoint(rehash=False): the
    cheap tier for multi-GB checkpoints reads checkpoint metadata only,
    never array bytes (the reference's tests of it fail; held to
    ``docs/checkpointing.md``)."""

    def test_light_checks_structure_against_metadata(self, tmp_path):
        _em(SIDES["port"], tmp_path).save(0, _port_net())
        step = str(tmp_path / "step_0")
        res = ckpt.verify_checkpoint(step)
        assert res.ok and res.arrays_checked == 2 and not res.rehashed
        mpath = tmp_path / "step_0" / MANIFEST
        m = json.loads(mpath.read_text())
        m["groups"]["model"]["weight"]["shape"] = [999]
        m["groups"]["model"]["weight"]["nbytes"] = 1
        m["groups"]["model"]["bias"]["dtype"] = "int8"
        mpath.write_text(json.dumps(m))
        res = ckpt.verify_checkpoint(step)
        assert not res.ok
        assert any("shape" in e for e in res.errors)
        assert any("nbytes" in e for e in res.errors)
        assert any("dtype" in e for e in res.errors)

    def test_checksums_are_the_rehash_tiers_job(self, tmp_path, monkeypatch):
        _em(SIDES["port"], tmp_path).save(0, _port_net())
        step = str(tmp_path / "step_0")
        mpath = tmp_path / "step_0" / MANIFEST
        m = json.loads(mpath.read_text())
        m["groups"]["model"]["weight"]["checksum"] = "sha256:" + "0" * 64
        mpath.write_text(json.dumps(m))

        def no_bytes(*a, **k):
            raise AssertionError("the light tier read array bytes")
        with monkeypatch.context() as mp:
            mp.setattr(storage, "_pread_into", no_bytes)
            assert ckpt.verify_checkpoint(step).ok
        res = ckpt.verify_checkpoint(step, rehash=True)
        assert not res.ok and any("checksum" in e for e in res.errors)

    def test_light_resume_still_quarantines_torn_storage(self, tmp_path):
        """Torn storage (a data file cut short) fails the light tier at
        the verify stage; flipped bytes under intact metadata pass it
        and fail the load's crc32 instead: either way the checkpoint is
        quarantined and resume falls back."""
        net = _port_net()
        em = _em(SIDES["port"], tmp_path, verify_on_resume="light",
                 keep_last=3)
        for step in (0, 1, 2):
            em.save(step, net)
        data = tmp_path / "step_2" / "model" / "d" / "0"
        data.write_bytes(data.read_bytes()[:-1])
        faults.flip_checkpoint_shards(str(tmp_path / "step_1"))
        assert em.resume(_port_net(seed=9)) == 1
        assert (tmp_path / "step_2.corrupt").exists()
        assert (tmp_path / "step_1.corrupt").exists()
        assert telemetry.value("pdt_checkpoint_corrupt_total",
                               reason="verify") == 1
        assert telemetry.value("pdt_checkpoint_corrupt_total",
                               reason="load") == 1


class TestCorruptionTolerantResume:
    def test_flipped_shard_quarantined_falls_back(self, tmp_path):
        def scenario(s, root):
            net = s.net()
            em = _em(s, root)
            em.save(0, net)
            w0 = s.weight(net)
            s.set_weight(net, w0 + 1.0)
            em.save(1, net)
            s.flip(str(root / "step_1"))
            net2 = s.net(seed=9)
            start = em.resume(net2)
            np.testing.assert_array_equal(s.weight(net2), w0)
            assert s.telemetry.value("pdt_checkpoint_corrupt_total",
                                     reason="verify") == 1
            assert s.telemetry.value(
                "pdt_checkpoint_resume_fallback_depth") == 1
            return start
        out = _both(tmp_path, scenario)
        assert out["port"][0] == 1

    def test_load_failure_quarantines_when_verify_off(self, tmp_path):
        def scenario(s, root):
            net = s.net()
            em = _em(s, root, verify_on_resume="off")
            em.save(0, net)
            em.save(1, net)
            s.flip(str(root / "step_1"))
            start = em.resume(s.net(seed=9))
            assert s.telemetry.value("pdt_checkpoint_corrupt_total",
                                     reason="load") == 1
            return start
        _both(tmp_path, scenario)

    def test_truncated_manifest_quarantined(self, tmp_path):
        def scenario(s, root):
            net = s.net()
            em = _em(s, root)
            em.save(0, net)
            em.save(1, net)
            m = root / "step_1" / MANIFEST
            m.write_text(m.read_text()[: m.stat().st_size // 2])
            return em.resume(s.net(seed=9))
        _both(tmp_path, scenario)

    def test_legacy_checkpoint_without_manifest_loads(self, tmp_path):
        def scenario(s, root):
            net = s.net()
            s.ckpt.save_state_dict(net.state_dict(),
                                   str(root / "step_0" / "model"))
            (root / "step_0" / ".done").write_text("1234.5")
            net2 = s.net(seed=9)
            start = _em(s, root).resume(net2)
            np.testing.assert_array_equal(s.weight(net2), s.weight(net))
            return start
        _both(tmp_path, scenario)

    def test_partial_load_then_exhaustion_raises_not_fresh(self, tmp_path):
        def scenario(s, root):
            net = s.net()
            opt = s.adam(net)
            em = _em(s, root, verify_on_resume="off")
            em.save(0, net, opt)
            s.flip(root / "step_0", group="opt")     # model intact
            with pytest.raises(RuntimeError, match="reinitialize"):
                em.resume(s.net(seed=9), opt)
        _both(tmp_path, scenario)

    def test_all_corrupt_resumes_fresh(self, tmp_path):
        def scenario(s, root):
            net = s.net()
            em = _em(s, root)
            em.save(0, net)
            em.save(1, net)
            s.flip(str(root / "step_0"))
            s.flip(str(root / "step_1"))
            return em.resume(s.net(seed=9))
        out = _both(tmp_path, scenario)
        assert out["port"][0] == 0
        assert sorted(out["port"][1]) == ["step_0.corrupt", "step_1.corrupt"]


class TestDurableGc:
    def test_incomplete_dirs_do_not_count_toward_keep_last(self, tmp_path):
        def scenario(s, root):
            em = _em(s, root, keep_last=2)
            net = s.net()
            em.save(0, net)
            em.save(1, net)
            for name in ("step_5", "step_6.tmp", "step_2.corrupt"):
                (root / name).mkdir()
            em.save(2, net)
            assert set(os.listdir(root)) == {
                "step_1", "step_2", "step_5", "step_6.tmp",
                "step_2.corrupt"}
        _both(tmp_path, scenario)

    def test_newest_complete_never_deleted(self, tmp_path):
        def scenario(s, root):
            em = _em(s, root, keep_last=0)
            net = s.net()
            em.save(0, net)
            em.save(1, net)
            return os.path.basename(s.elastic.latest_checkpoint(str(root)))
        out = _both(tmp_path, scenario)
        assert out["port"][0] == "step_1"

    def test_stale_incomplete_dirs_swept_fresh_kept(self, tmp_path):
        def scenario(s, root):
            clk = {"t": 1_000_000.0}
            em = _em(s, root, stale_grace=100.0, clock=lambda: clk["t"])
            em.save(0, s.net())
            for name in ("step_5", "step_6.tmp", "step_3.corrupt"):
                (root / name).mkdir()
                os.utime(root / name, (clk["t"] - 200, clk["t"] - 200))
            (root / "step_7.tmp").mkdir()          # a LIVE writer's tmp
            os.utime(root / "step_7.tmp", (clk["t"] - 5, clk["t"] - 5))
            os.utime(root / "step_0", (clk["t"] - 900, clk["t"] - 900))
            em._gc()
            assert set(os.listdir(root)) == {"step_0", "step_7.tmp"}
        _both(tmp_path, scenario)

    def test_gc_removes_done_before_rmtree(self, tmp_path, monkeypatch):
        def scenario(s, root):
            em = _em(s, root, keep_last=2)
            net = s.net()
            em.save(0, net)
            em.save(1, net)
            em.keep_last = 1
            with monkeypatch.context() as m:
                m.setattr(s.elastic.shutil, "rmtree", lambda *a, **k: None)
                em._gc()
            assert (root / "step_0").exists()
            assert not (root / "step_0" / ".done").exists()
            return [n for n, _ in s.elastic.complete_checkpoints(str(root))]
        out = _both(tmp_path, scenario)
        assert out["port"][0] == [1]

    def test_quarantined_dir_survives_stale_gc(self, tmp_path):
        def scenario(s, root):
            clk = {"t": 1_000_000.0}
            em = _em(s, root, stale_grace=100.0, clock=lambda: clk["t"])
            net = s.net()
            em.save(0, net)
            em.save(1, net)
            s.flip(str(root / "step_1"))
            for r, dirs, files in os.walk(root):
                for name in dirs + files:
                    os.utime(os.path.join(r, name),
                             (clk["t"] - 900, clk["t"] - 900))
            start = em.resume(s.net(seed=9))
            em._gc()
            kept = (root / "step_1.corrupt").exists()
            clk["t"] += 200
            em._gc()
            assert kept and not (root / "step_1.corrupt").exists()
            return start
        _both(tmp_path, scenario)

    def test_gc_fault_does_not_lose_the_committed_save(self, tmp_path):
        """The reference's test fails at its light verify; the port per
        ``docs/checkpointing.md``: a GC failure after a commit is an
        event, not an exception, and the save stays committed."""
        em = _em(SIDES["port"], tmp_path)
        with faults.FaultInjector() as fi:
            fi.arm("elastic.gc", always=True)
            em.save(0, _port_net())
        assert fi.trips("elastic.gc") == 1
        assert elastic.latest_checkpoint(str(tmp_path)).endswith("step_0")
        assert ckpt.verify_checkpoint(str(tmp_path / "step_0")).ok
        assert [e["name"] for e in telemetry.events()
                if e["name"] == "checkpoint.gc_error"] == \
            ["checkpoint.gc_error"]


class TestWaitForPeersClock:
    def test_deadline_runs_on_injected_clock(self, tmp_path):
        def scenario(s, root):
            clk = {"t": 1000.0}
            hb = s.elastic.HeartbeatMembership(
                str(root), timeout=5.0, interval=1.0,
                clock=lambda: clk["t"])
            sleeps = []

            def fake_sleep(dt):
                sleeps.append(dt)
                clk["t"] += dt

            with pytest.raises(TimeoutError):
                hb.wait_for_peers(1, timeout=10.0, sleep=fake_sleep)
            assert sleeps == [0.5] * 20 and clk["t"] == 1010.0
            return sleeps
        _both(tmp_path, scenario)

    def test_returns_once_peers_register(self, tmp_path):
        def scenario(s, root):
            clk = {"t": 1000.0}
            hb = s.elastic.HeartbeatMembership(
                str(root), timeout=5.0, interval=1.0,
                clock=lambda: clk["t"])

            def beat_then_advance(dt):
                clk["t"] += dt
                if not os.listdir(str(root)):
                    s.elastic.HeartbeatMembership(str(root),
                                                  rank=3).heartbeat()
                    os.utime(os.path.join(str(root), "worker_3.hb"),
                             (clk["t"], clk["t"]))

            return hb.wait_for_peers(1, timeout=10.0,
                                     sleep=beat_then_advance)
        out = _both(tmp_path, scenario)
        assert out["port"][0] == {3}

    def test_zero_timeout_still_checks_once(self, tmp_path):
        def scenario(s, root):
            hb = s.elastic.HeartbeatMembership(str(root), timeout=5.0,
                                               clock=lambda: 1000.0)
            s.elastic.HeartbeatMembership(str(root), rank=0).heartbeat()
            os.utime(os.path.join(str(root), "worker_0.hb"),
                     (1000.0, 1000.0))
            return hb.wait_for_peers(1, timeout=0.0, sleep=lambda _: None)
        out = _both(tmp_path, scenario)
        assert out["port"][0] == {0}


@pytest.mark.chaos
class TestCheckpointChaos:
    def test_injected_save_failure_leaves_no_partial_checkpoint(
            self, tmp_path):
        def scenario(s, root):
            net = s.net()
            em = s.elastic.ElasticManager(str(root), save_interval_steps=1)
            em.save(0, net)
            latest = [s.elastic.latest_checkpoint(str(root))]
            with s.faults.FaultInjector() as fi:
                fi.arm("checkpoint.save", always=True)
                with pytest.raises(s.faults.FaultError):
                    em.save(1, net)
            latest.append(s.elastic.latest_checkpoint(str(root)))
            em.save(2, net)
            latest.append(s.elastic.latest_checkpoint(str(root)))
            names = [os.path.basename(p) for p in latest]
            assert names == ["step_0", "step_0", "step_2"]
            return names
        _both(tmp_path, scenario)

    def test_kill_mid_save_resumes_previous_and_quarantines(self, tmp_path):
        """Torn tmp from a write fault, a .done-marked dir with no data,
        and a bit-flipped newest checkpoint: resume lands on the last
        good step, quarantines the bad ones, and the telemetry
        reconciles with the injected damage."""
        def scenario(s, root):
            net = s.net()
            opt = s.adam(net)
            em = s.elastic.ElasticManager(str(root), save_interval_steps=1,
                                          save_retries=1,
                                          sleep=lambda _: None)
            em.save(0, net, opt)
            w0 = s.weight(net)
            em.save(1, net, opt)
            with s.faults.FaultInjector() as fi:
                fi.arm("checkpoint.write", nth=1)
                with pytest.raises(s.faults.FaultError):
                    em.save(2, net, opt)
            (root / "step_3").mkdir()
            s.ckpt.write_done(str(root / "step_3"), step=3)
            s.flip(root / "step_1")
            net2 = s.net(seed=1)
            opt2 = s.adam(net2)
            start = em.resume(net2, opt2)
            assert start == 1
            np.testing.assert_array_equal(s.weight(net2), w0)
            assert s.telemetry.value("pdt_checkpoint_corrupt_total",
                                     reason="load") == 1
            assert s.telemetry.value("pdt_checkpoint_corrupt_total",
                                     reason="verify") == 1
            assert s.telemetry.value(
                "pdt_checkpoint_resume_fallbacks_total") == 2
            assert s.ckpt.verify_checkpoint(str(root / "step_0"),
                                            rehash=True).ok
            return start
        out = _both(tmp_path, scenario)
        assert {"step_3.corrupt", "step_1.corrupt", "step_2.tmp",
                "step_0"} <= set(out["port"][1])

    def test_interrupted_then_retried_save_verifies_clean(self, tmp_path):
        def scenario(s, root):
            net = s.net()
            em = s.elastic.ElasticManager(str(root), save_interval_steps=1,
                                          save_retries=3, keep_last=3,
                                          sleep=lambda _: None)
            with s.faults.FaultInjector() as fi:
                fi.arm("checkpoint.write", nth=1)
                em.save(0, net)
            with s.faults.FaultInjector() as fi:
                fi.arm("checkpoint.finalize", nth=1)
                em.save(1, net)
            em2 = s.elastic.ElasticManager(str(root), save_interval_steps=1,
                                           save_retries=1, keep_last=3,
                                           sleep=lambda _: None)
            with s.faults.FaultInjector() as fi:
                fi.arm("checkpoint.write", always=True)
                with pytest.raises(s.faults.FaultError):
                    em2.save(2, net)
            em2.save(2, net)
            for step in (0, 1, 2):
                res = s.ckpt.verify_checkpoint(str(root / f"step_{step}"),
                                               rehash=True)
                assert res.ok, (step, res.errors)
            assert s.telemetry.value(
                "pdt_checkpoint_save_retries_total") == 2
        _both(tmp_path, scenario)

    def test_load_fault_site_forces_fallback(self, tmp_path):
        def scenario(s, root):
            net = s.net()
            em = s.elastic.ElasticManager(str(root), save_interval_steps=1,
                                          sleep=lambda _: None)
            em.save(0, net)
            em.save(1, net)
            with s.faults.FaultInjector() as fi:
                fi.arm("checkpoint.load", always=True, times=2)
                start = em.resume(net)
            assert fi.trips("checkpoint.load") == 2
            assert s.telemetry.value(
                "pdt_checkpoint_load_retries_total") == 1
            return start
        out = _both(tmp_path, scenario)
        assert out["port"][0] == 1 and "step_1.corrupt" in out["port"][1]

    def test_transient_load_fault_is_retried_not_quarantined(self,
                                                             tmp_path):
        def scenario(s, root):
            net = s.net()
            em = s.elastic.ElasticManager(str(root), save_interval_steps=1,
                                          sleep=lambda _: None)
            em.save(0, net)
            em.save(1, net)
            with s.faults.FaultInjector() as fi:
                fi.arm("checkpoint.load", nth=1)
                start = em.resume(net)
            assert fi.trips("checkpoint.load") == 1
            assert s.telemetry.value(
                "pdt_checkpoint_resume_fallbacks_total") == 0
            return start
        out = _both(tmp_path, scenario)
        assert out["port"][0] == 2
