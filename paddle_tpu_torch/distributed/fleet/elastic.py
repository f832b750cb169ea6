"""Elastic training — checkpoint-restart based.

≙ `paddle_tpu/distributed/fleet/elastic.py`, whole: the discovery
helpers, `ElasticManager` (the atomic commit protocol, the
corruption-tolerant resume chain, GC) and `HeartbeatMembership`, with the
JAX package's metric series and events (``docs/observability.md``
:136-141) and ``docs/checkpointing.md``'s protocol. Elasticity is
checkpoint-restart: a restarted job resumes from the newest checkpoint
that verifies and loads. This module is the train-loop side; the
launcher's restart loop is not ported yet (ROADMAP.md queue A, item 9),
its `restart_backoff` is (≙ `paddle_tpu/distributed/launch/__init__.py`
:98), because saves and loads retry on the same schedule.

A checkpoint ``step_N`` holds a ``model`` group (the model's
`state_dict()`) and, with an optimizer, an ``opt`` group (its
`paddle_state_dict()`), each in the layout of
`distributed.checkpoint.storage`, beside ``MANIFEST.json`` and ``.done``.
On resume the model group is read into the model's own tensors and the
optimizer group onto the model's device.
"""
from __future__ import annotations

import os
import random
import re
import shutil
import time
from typing import List, Optional, Tuple

import torch

from ... import observability as telemetry
from ...utils.faults import fault_point

__all__ = ["ElasticManager", "latest_checkpoint",
           "complete_checkpoints", "HeartbeatMembership",
           "restart_backoff"]

_M_HB_STALENESS = telemetry.gauge(
    "pdt_elastic_heartbeat_staleness_seconds",
    "Seconds since each worker's last heartbeat, sampled at alive().",
    ("rank",))
_M_MEMBERSHIP_EVENTS = telemetry.counter(
    "pdt_elastic_membership_events_total",
    "Membership deltas observed by poll(), by classification.",
    ("event",))
_M_SAVE_RETRIES = telemetry.counter(
    "pdt_checkpoint_save_retries_total",
    "Checkpoint save attempts retried after a write/finalize failure.")
_M_LOAD_RETRIES = telemetry.counter(
    "pdt_checkpoint_load_retries_total",
    "Resume-time load attempts retried before quarantining.")
_M_CORRUPT = telemetry.counter(
    "pdt_checkpoint_corrupt_total",
    "Checkpoints quarantined at resume, by detection path.", ("reason",))
_M_FALLBACKS = telemetry.counter(
    "pdt_checkpoint_resume_fallbacks_total",
    "Resume attempts that fell back past a bad checkpoint.")
_M_FALLBACK_DEPTH = telemetry.gauge(
    "pdt_checkpoint_resume_fallback_depth",
    "How many checkpoints the last resume() skipped before loading "
    "one (0 = newest was good).")


def restart_backoff(attempt: int, base: float, cap: float,
                    rng: random.Random) -> float:
    """Delay before restart `attempt` (1-based): exponential
    base * 2^(attempt-1) with +/-50% multiplicative jitter (restarting
    ranks decorrelate instead of stampeding in lockstep), clamped to
    `cap` AFTER jitter — the cap is a hard ceiling."""
    if base <= 0:
        return 0.0
    return min(cap, base * (2.0 ** (attempt - 1)) * (0.5 + rng.random()))


def _device_of(model) -> torch.device:
    for p in model.parameters():
        return p.device
    from ...ops import resolve_device
    return resolve_device(None)


def complete_checkpoints(ckpt_dir: str) -> List[Tuple[int, str]]:
    """All COMMITTED step checkpoints under ckpt_dir, newest first.

    Committed means a `step_N/.done` marker that actually parses
    (`checkpoint.parse_done`) — a zero-byte or torn marker from a
    non-atomic writer must read as NOT committed, never as a loadable
    checkpoint. `.tmp` and `.corrupt` directories never qualify."""
    from ..checkpoint import DONE_NAME, parse_done
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if not m:
            continue
        path = os.path.join(ckpt_dir, name)
        if parse_done(os.path.join(path, DONE_NAME)) is not None:
            out.append((int(m.group(1)), path))
    out.sort(reverse=True)
    return out


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest COMMITTED step-numbered checkpoint dir, or None. Rejects
    unparsable `.done` payloads (see `complete_checkpoints`)."""
    complete = complete_checkpoints(ckpt_dir)
    return complete[0][1] if complete else None


def _free_suffixed(base: str, suffix: str) -> str:
    """First non-existing `base``suffix`[.k] name. Quarantine's
    `.corrupt` and _commit's `.old` move-aside share this probe; the
    _gc stale-sweep regex must keep matching both families."""
    dst = base + suffix
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{base}{suffix}.{n}"
    return dst


def _rmtree_checkpoint(path: str):
    """Delete a checkpoint dir with its `.done` marker removed FIRST:
    rmtree is not atomic (and ignore_errors swallows partial failures),
    so a kill mid-delete must not leave a half-deleted directory that
    discovery still trusts — with MANIFEST.json among the missing files,
    resume's legacy-checkpoint path would even load it unverified."""
    from ..checkpoint import DONE_NAME
    try:
        os.remove(os.path.join(path, DONE_NAME))
    except OSError:
        pass
    shutil.rmtree(path, ignore_errors=True)


def _touch(path: str, now: Optional[float] = None):
    """Restart the stale-age clock on a renamed dir: os.replace keeps
    the data files' old mtimes, so without this the very next _gc could
    sweep a just-quarantined (or just-moved-aside) checkpoint whose
    data predates `stale_grace` — destroying the post-mortem evidence
    the rename exists to preserve. `now` comes from the manager's
    injectable clock so ages stay consistent with `_gc`'s."""
    try:
        os.utime(path, None if now is None else (now, now))
    except OSError:
        pass


def _newest_mtime(path: str) -> float:
    """Newest mtime anywhere under `path`. The top-level dir's own
    mtime freezes when its first entry is created, so a long in-flight
    write deep under `step_N.tmp/model/d/` would look stale by
    the dir mtime alone — the stale-age GC must see the write
    activity, not the directory creation time."""
    newest = os.stat(path).st_mtime
    for root, dirs, files in os.walk(path):
        for name in dirs + files:
            try:
                ts = os.stat(os.path.join(root, name)).st_mtime
            except OSError:
                continue
            if ts > newest:
                newest = ts
    return newest


class ElasticManager:
    """Checkpoint-cadence + resume bookkeeping for an elastic train loop.

    Usage::

        em = ElasticManager(ckpt_dir, save_interval_steps=100)
        start = em.resume(model, opt)      # 0 if fresh
        for step in range(start, total):
            loss = train_step(...)
            em.maybe_save(step, model, opt)

    Durability (docs/checkpointing.md): `save` runs an **atomic commit
    protocol** — all data is written into `step_N.tmp` together with a
    `MANIFEST.json` integrity manifest, then the directory is renamed
    to `step_N` and a `.done` marker committed via tmp+rename, so a
    crash at ANY point leaves either the previous complete checkpoint
    or a new complete one, never a half-trusted directory. Failed write
    attempts are retried with exponential backoff (`save_retries`,
    reusing the launcher's backoff shape). `resume` walks complete
    checkpoints newest-first, verifies each against its manifest
    (`verify_on_resume`: "rehash" re-hashes content checksums, "light"
    checks structure against checkpoint metadata without reading array
    bytes, "off" trusts `.done`), retries transient load errors
    (`load_retries`), and **quarantines** a bad one (`step_N` ->
    `step_N.corrupt`) before falling back to the next-newest — a torn
    or bit-flipped checkpoint degrades resume by one interval instead
    of crash-looping the launcher.
    """

    #: resume-time verification modes (constructor `verify_on_resume`)
    VERIFY_MODES = ("rehash", "light", "off")

    def __init__(self, ckpt_dir: str, save_interval_steps: int = 100,
                 keep_last: int = 2, save_retries: int = 3,
                 retry_backoff: float = 0.25,
                 retry_backoff_max: float = 5.0,
                 load_retries: int = 2,
                 verify_on_resume: str = "rehash",
                 stale_grace: float = 3600.0,
                 sleep=time.sleep, rng: Optional[random.Random] = None,
                 clock=time.time):
        if verify_on_resume not in self.VERIFY_MODES:
            raise ValueError(
                f"verify_on_resume must be one of {self.VERIFY_MODES}, "
                f"got {verify_on_resume!r}")
        self.ckpt_dir = ckpt_dir
        self.save_interval_steps = save_interval_steps
        self.keep_last = keep_last
        self.save_retries = max(1, save_retries)   # total attempts
        self.retry_backoff = retry_backoff
        self.retry_backoff_max = retry_backoff_max
        self.load_retries = max(1, load_retries)   # total attempts
        self.verify_on_resume = verify_on_resume
        # age guard for GC of incomplete/.tmp/.corrupt dirs: a LIVE
        # save's tmp dir (or a checkpoint an operator is inspecting)
        # must not be swept by a concurrent manager
        self.stale_grace = stale_grace
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self._clock = clock
        os.makedirs(ckpt_dir, exist_ok=True)

    # -- resume (corruption-tolerant fallback chain) -------------------
    def resume(self, model, optimizer=None) -> int:
        """Restore the newest checkpoint that verifies AND loads;
        returns the next step (0 if no loadable checkpoint remains).

        A checkpoint that fails its integrity manifest or raises during
        load is quarantined (`step_N` -> `step_N.corrupt`, kept on disk
        for post-mortem until GC'd by the stale-age guard) and the
        chain falls back to the next-newest complete checkpoint. Load
        errors get `load_retries` total attempts (the save path's
        backoff shape) first, so one transient I/O hiccup doesn't cost
        a save interval."""
        from ..checkpoint import (MANIFEST_NAME, load_state_dict,
                                  load_state_dict_raw, verify_checkpoint)
        self._recover_replaced()
        depth = 0
        model_mutated = False
        for step, path in complete_checkpoints(self.ckpt_dir):
            reason = None
            try:
                if (self.verify_on_resume != "off"
                        and os.path.exists(
                            os.path.join(path, MANIFEST_NAME))):
                    # pre-manifest (legacy) checkpoints skip straight to
                    # the load attempt rather than being quarantined for
                    # predating the protocol
                    reason = "verify"
                    verify_checkpoint(
                        path,
                        rehash=self.verify_on_resume == "rehash",
                    ).raise_if_failed()
                reason = "load"
                for attempt in range(1, self.load_retries + 1):
                    try:
                        load_state_dict(model.state_dict(),
                                        os.path.join(path, "model"))
                        model_mutated = True
                        if (optimizer is not None
                                and hasattr(optimizer, "set_state_dict")):
                            opt_path = os.path.join(path, "opt")
                            if os.path.isdir(opt_path):
                                # raw restore: optimizer accumulators
                                # are created lazily, so there is no
                                # target structure to restore into yet
                                optimizer.set_state_dict(
                                    load_state_dict_raw(
                                        opt_path,
                                        device=_device_of(model)))
                        break
                    except Exception:
                        # a transient I/O error must not quarantine the
                        # newest GOOD checkpoint (losing a full save
                        # interval): retry like save does, quarantine
                        # only when the failure persists. A retry that
                        # got past the model group re-assigns it whole.
                        if attempt == self.load_retries:
                            raise
                        delay = restart_backoff(attempt,
                                                self.retry_backoff,
                                                self.retry_backoff_max,
                                                self._rng)
                        _M_LOAD_RETRIES.inc()
                        telemetry.event("checkpoint.load_retry",
                                        path=path, attempt=attempt,
                                        delay_s=delay)
                        if delay > 0:
                            self._sleep(delay)
            except Exception as e:
                self._quarantine(path, reason or "load", e)
                depth += 1
                _M_FALLBACKS.inc()
                continue
            _M_FALLBACK_DEPTH.set(depth)
            return step + 1
        _M_FALLBACK_DEPTH.set(depth)
        if model_mutated:
            # a quarantined attempt got as far as assigning the model's
            # weights before its optimizer group failed, and no later
            # candidate overwrote them: returning 0 ("train fresh")
            # would silently train on a corrupt checkpoint's weights
            raise RuntimeError(
                "resume() exhausted all checkpoints after partially "
                "loading a quarantined one — the model now holds that "
                "checkpoint's weights; reinitialize it before training "
                "from scratch")
        return 0

    def _recover_replaced(self):
        """Undo a crash inside _commit's re-save window: the only
        complete copy of step N may sit under `step_N.old` — committed
        in every respect but the name, which discovery ignores and the
        stale sweep would eventually destroy. Rename it back so the
        fallback chain can use it. An uncommitted `step_N` squatting on
        the name is the dead re-save's droppings (no valid `.done` by
        the commit ordering) and is cleared first; if the re-save DID
        commit, its `.old` is redundant and left for the stale sweep."""
        from ..checkpoint import DONE_NAME, parse_done
        for name in sorted(os.listdir(self.ckpt_dir)):
            m = re.fullmatch(r"(step_\d+)\.old(\.\d+)?", name)
            if not m:
                continue
            src = os.path.join(self.ckpt_dir, name)
            if parse_done(os.path.join(src, DONE_NAME)) is None:
                continue
            dst = os.path.join(self.ckpt_dir, m.group(1))
            if parse_done(os.path.join(dst, DONE_NAME)) is not None:
                continue
            if os.path.exists(dst):
                _rmtree_checkpoint(dst)
            try:
                os.replace(src, dst)
            except OSError as e:
                # the squatter's deletion can partially fail (NFS
                # silly-renames, EACCES — swallowed by rmtree above);
                # recovery must degrade to "not this restart", keeping
                # the .old for a later attempt, never crash-loop
                # resume() on the way to the fallback chain
                telemetry.event("checkpoint.recover_error", src=src,
                                error=f"{type(e).__name__}: {e}")
                continue
            telemetry.event("checkpoint.recovered", path=dst, src=src)

    def _quarantine(self, path: str, reason: str, err: Exception):
        """step_N -> step_N.corrupt (first free suffix), so the bad
        checkpoint leaves the resume chain but stays inspectable."""
        dst = _free_suffixed(path, ".corrupt")
        try:
            os.replace(path, dst)
        except OSError:
            # cannot rename (permissions? foreign mount?): delete the
            # .done marker instead so discovery stops trusting it
            from ..checkpoint import DONE_NAME
            try:
                os.remove(os.path.join(path, DONE_NAME))
            except OSError:
                pass
            dst = path
        else:
            _touch(dst, self._clock())
        _M_CORRUPT.inc(reason=reason)
        telemetry.event("checkpoint.quarantine", path=path,
                        quarantined_as=dst, reason=reason,
                        error=f"{type(err).__name__}: {err}")

    # -- save (atomic commit protocol) ---------------------------------
    def maybe_save(self, step: int, model, optimizer=None) -> bool:
        if (step + 1) % self.save_interval_steps:
            return False
        self.save(step, model, optimizer)
        return True

    def save(self, step: int, model, optimizer=None):
        """Write checkpoint `step` via tmp + manifest + rename + `.done`
        (class docstring). Write/finalize failures are retried up to
        `save_retries` total attempts with exponential backoff; the tmp
        directory is torn down between attempts so a retry never
        commits a mix of two attempts' files."""
        final = os.path.join(self.ckpt_dir, f"step_{step}")
        tmp = final + ".tmp"
        for attempt in range(1, self.save_retries + 1):
            try:
                self._write_tmp(tmp, step, model, optimizer)
                self._commit(tmp, final, step)
                break
            except Exception:
                # the torn tmp dir is deliberately LEFT on disk — the
                # identical state a hard kill leaves. The next attempt
                # (or any later save of this step) clears it first, and
                # _gc sweeps it once stale; discovery never trusts it.
                if attempt == self.save_retries:
                    raise
                delay = restart_backoff(attempt, self.retry_backoff,
                                        self.retry_backoff_max,
                                        self._rng)
                _M_SAVE_RETRIES.inc()
                telemetry.event("checkpoint.save_retry", step=step,
                                attempt=attempt, delay_s=delay)
                if delay > 0:
                    self._sleep(delay)
        try:
            self._gc()
        except Exception as e:
            # the checkpoint above COMMITTED: failing the train loop
            # because cleanup of old checkpoints hiccuped (NFS race,
            # ENOSPC during rmtree) would trade durability for tidiness
            telemetry.event("checkpoint.gc_error",
                            error=f"{type(e).__name__}: {e}")

    def _write_tmp(self, tmp: str, step: int, model, optimizer):
        from ..checkpoint import manifest_of, save_group, write_manifest
        shutil.rmtree(tmp, ignore_errors=True)   # leftovers of a crash
        groups = {"model": model.state_dict()}
        if optimizer is not None and hasattr(optimizer,
                                             "paddle_state_dict"):
            sd = optimizer.paddle_state_dict()
            if sd:
                groups["opt"] = sd
        # each group's checksums come from the bytes as they are
        # written: nothing is read back for the manifest
        described = {name: save_group(sd, os.path.join(tmp, name))
                     for name, sd in groups.items()}
        # manifest LAST, after every group's bytes: its presence asserts
        # the writer got through all data writes
        write_manifest(tmp, manifest_of(described, step=step,
                                        wall_time=self._clock()))

    def _commit(self, tmp: str, final: str, step: int):
        from ..checkpoint import write_done
        fault_point("checkpoint.finalize")
        replaced = None
        if os.path.exists(final):
            # re-save of the same step (resumed job repeating the
            # interval): the fresh tmp replaces the old dir wholesale.
            # Never rmtree the live dir here — a crash mid-delete would
            # destroy what may be the only complete copy of this step.
            # Move it aside atomically and drop it only after the fresh
            # dir is fully committed; a crash in between leaves the old
            # copy intact (with its .done) under the .old name, which
            # the next resume()'s _recover_replaced renames back.
            replaced = _free_suffixed(final, ".old")
            os.replace(final, replaced)
            _touch(replaced, self._clock())
        os.replace(tmp, final)
        # .done marker strictly after the rename: a crash between the
        # two leaves a manifest-complete but UNcommitted dir, which
        # discovery ignores — same discipline as heartbeat()
        write_done(final, step=step, wall_time=self._clock())
        if replaced is not None:
            _rmtree_checkpoint(replaced)

    # -- gc ------------------------------------------------------------
    def _gc(self):
        """Prune old checkpoints. Only COMPLETE (`.done`-committed)
        checkpoints count toward `keep_last`, and the newest complete
        checkpoint is never deleted (even with keep_last=0 a crash must
        always find something to resume from). Incomplete `step_N` /
        `step_N.tmp` / `step_N.corrupt` / `step_N.old` dirs are swept
        separately, and only once older than `stale_grace` seconds — a
        live writer's tmp dir is younger than that by construction, and
        quarantine/move-aside renames restart the clock (`_touch`)."""
        fault_point("elastic.gc")
        complete = complete_checkpoints(self.ckpt_dir)   # newest first
        keep = max(1, self.keep_last)
        for _, path in complete[keep:]:
            _rmtree_checkpoint(path)
        complete_names = {os.path.basename(p) for _, p in complete}
        now = self._clock()
        for name in os.listdir(self.ckpt_dir):
            if name in complete_names:
                continue
            if not re.fullmatch(
                    r"step_\d+(\.tmp|(\.corrupt|\.old)(\.\d+)?)?", name):
                continue
            path = os.path.join(self.ckpt_dir, name)
            try:
                # only a live writer mutates files deep inside a dir,
                # and only under `.tmp` — for `.corrupt`/`.old`/bare
                # dirs the top-level mtime (stamped by the rename's
                # _touch, or frozen at the crash) suffices, sparing a
                # full stat walk of a multi-GB dir on every save
                if name.endswith(".tmp"):
                    age = now - _newest_mtime(path)
                else:
                    age = now - os.stat(path).st_mtime
            except OSError:
                continue
            if age > self.stale_grace:
                _rmtree_checkpoint(path)
                telemetry.event("checkpoint.gc_stale", path=path,
                                age_s=age)


class HeartbeatMembership:
    """File-backed membership + heartbeat watch — the launcher-local
    form of the reference ElasticManager's ETCD register/watch
    («.../fleet/elastic/manager.py»: register np, watch peers, classify
    scale-up/down). Workers on one host (or a shared filesystem)
    register by writing `<dir>/worker_<rank>.hb` timestamps from a
    daemon thread; the watcher classifies peers dead after
    `timeout` seconds of silence, and `poll()` reports joins/deaths so
    a controller can relaunch (checkpoint-restart does the resume).
    """

    def __init__(self, dir: str, rank: Optional[int] = None,
                 interval: float = 1.0, timeout: float = 5.0,
                 clock=None):
        self.dir = dir
        self.rank = rank
        self.interval = interval
        self.timeout = timeout
        # injectable clock: deterministic freshness tests (the clock
        # only feeds the mtime comparison, never the beat contents)
        self._clock = clock if clock is not None else time.time
        self._stop = False
        self._thread = None
        self._last_alive: set = set()
        self._staleness_ranks: set = set()  # gauge series this watcher
        # exported; retired when the beat file disappears
        os.makedirs(dir, exist_ok=True)

    # -- worker side ---------------------------------------------------
    def _beat_path(self, rank: int) -> str:
        return os.path.join(self.dir, f"worker_{rank}.hb")

    def start(self):
        """Register this worker and heartbeat from a daemon thread
        (restartable: a stopped membership can start() again)."""
        assert self.rank is not None, "worker needs a rank"
        self._stop = False
        import threading

        def beat():
            while not self._stop:
                self.heartbeat()
                time.sleep(self.interval)

        self.heartbeat()                  # register immediately
        self._thread = threading.Thread(target=beat, daemon=True)
        self._thread.start()
        return self

    def heartbeat(self):
        """One manual beat (for loops that prefer explicit control).
        Atomic write (tmp + rename): a reader must never observe a
        truncated/empty file and misclassify the worker as dead. The
        payload comes from the injectable clock — freshness uses the
        file's mtime, so the content only needs to parse as a
        timestamp (`_beat_valid`), and a fake-clock test writes
        fake-clock beats."""
        assert self.rank is not None
        tmp = self._beat_path(self.rank) + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(self._clock()))
        os.replace(tmp, self._beat_path(self.rank))

    def stop(self):
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)
        if self.rank is not None:
            try:
                os.remove(self._beat_path(self.rank))
            except OSError:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()
        return False

    # -- watcher side --------------------------------------------------
    @staticmethod
    def _beat_valid(path: str) -> bool:
        """A beat counts only if its payload parses as a timestamp.
        Our writer is atomic (tmp + rename), but on filesystems without
        atomic rename (some network/FUSE mounts) — or with foreign
        writers — a reader can observe a truncated/empty file. Treat
        any such corrupt beat as STALE rather than raising: a mid-write
        worker will land a valid beat within one interval, and a watcher
        crash-looping on a garbage file would be strictly worse."""
        try:
            with open(path) as f:
                float(f.read().strip())
            return True
        except (OSError, ValueError):
            return False

    def alive(self) -> set:
        """Ranks with a fresh heartbeat. Freshness uses the heartbeat
        file's mtime (stamped by the filesystem, which on a shared FS is
        the server clock) rather than the writer's embedded timestamp —
        cross-host clock skew must not misclassify live workers. A beat
        exactly `timeout` old still counts; corrupt beats never do."""
        now = self._clock()
        out = set()
        seen_ranks = set()
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"worker_(\d+)\.hb", name)
            if not m:
                continue
            path = os.path.join(self.dir, name)
            try:
                ts = os.stat(path).st_mtime
            except OSError:
                continue
            seen_ranks.add(m.group(1))
            _M_HB_STALENESS.set(now - ts, rank=m.group(1))
            if now - ts <= self.timeout and self._beat_valid(path):
                out.add(int(m.group(1)))
        # a departed worker (stop() removed its beat file) must not keep
        # exporting its last staleness value forever — retire the series
        for rank in self._staleness_ranks - seen_ranks:
            _M_HB_STALENESS.remove(rank=rank)
        self._staleness_ranks = seen_ranks
        return out

    def wait_for_peers(self, np_: int, timeout: float = 60.0,
                       sleep=time.sleep) -> set:
        """Block until np_ workers are registered (rendezvous barrier).

        The deadline runs on the injectable `self._clock` (NOT
        `time.time()`), so tests drive it deterministically with a fake
        clock; pass a `sleep` that advances that clock, or the loop
        would spin on a frozen one. Always checks at least once, even
        with timeout <= 0."""
        deadline = self._clock() + timeout
        while True:
            a = self.alive()
            if len(a) >= np_:
                self._last_alive = a
                return a
            if self._clock() >= deadline:
                break
            sleep(self.interval / 2)
        raise TimeoutError(
            f"only {len(a)}/{np_} workers registered within "
            f"{timeout}s")

    def poll(self) -> dict:
        """Membership delta since the last poll: {'alive', 'joined',
        'dead', 'event'} with event in (None, 'scale_up', 'scale_down')
        — the reference's scale classification."""
        a = self.alive()
        joined = a - self._last_alive
        dead = self._last_alive - a
        event = None
        if dead:
            event = "scale_down"
        elif joined and self._last_alive:
            event = "scale_up"
        self._last_alive = a
        if event is not None:
            _M_MEMBERSHIP_EVENTS.inc(event=event)
            telemetry.event("elastic.membership", event=event,
                            alive=sorted(a), joined=sorted(joined),
                            dead=sorted(dead))
        return {"alive": a, "joined": joined, "dead": dead,
                "event": event}
