"""Deterministic, process-local fault injection for chaos testing.

≙ `paddle_tpu/utils/faults.py` :124-413: `FaultInjector`, `fault_point`,
`fault_value`, `value_armed`, `FaultError` and the corrupt mode. Code
under test declares named fault sites (``fault_point("serving.prefill")``)
and chaos tests arm them with deterministic triggers:

* **Process-local scoping**: injectors form a context-manager stack
  (innermost wins per site). Nothing is armed globally — leaving the
  ``with`` block disarms everything.
* **Deterministic**: ``nth=`` fires on exactly the N-th visit of the
  site; ``probability=`` draws from the injector's own seeded
  ``random.Random``; ``always=True`` fires on every visit. ``times=``
  caps total firings. The same seed and arming fire on the same visits
  as the JAX package's injector.
* **Typed**: each rule raises its configured exception class (default
  :class:`FaultError`), so a site can simulate a specific failure — e.g.
  ``serving.alloc_page`` armed with the engine's ``PoolExhausted``
  forces the preemption path.
* **Zero cost when idle**: ``fault_point`` returns at once when no
  injector is active.
* **Corrupt mode**: ``arm_corrupt(site, mode=...)`` makes a VALUE site
  (``fault_value(site, array)``) return a mutated copy instead of
  raising: ``"bitflip"`` XORs the high byte of one seeded element with
  0xFF, ``"nan"`` poisons one seeded element (integer arrays take
  ``-(2**31 - 1)``), ``"scale"`` multiplies the whole array by
  ``factor``. ``tag=`` pins a rule to visits carrying that tag.

Instrumented sites of the port (grep ``fault_point(``):

* ``serving.alloc_page``, ``serving.prefill``, ``serving.decode`` — the
  continuous-batching engine (models/serving.py): a prefill fault fails
  its request alone, a decode fault is retried up to
  ``max_decode_retries``;
* ``speculative.draft`` / ``speculative.verify`` — before a speculative
  round's draft pass and its verify dispatch: either fault degrades that
  round to plain decode and drops the draft caches; no request fails;
* ``transfer.serialize`` / ``transfer.install`` — the KV transfer plane
  (serving/transfer.py), before the source's export and before the
  target's import: the request stays live on its source, both engines
  consistent; ``transfer.payload`` — a VALUE site: a serialized payload
  damaged after its manifest, which the target's verify refuses.

* ``checkpoint.save`` — before any byte of a state-dict write;
  ``checkpoint.write`` — after one group's bytes land (fires between
  groups of a multi-group save: forces torn ``step_N.tmp`` dirs; for
  ``async_save`` it fires in ``wait_until_finished()``, where the bytes
  have landed); ``checkpoint.finalize`` — before the tmp->final rename
  + ``.done`` commit; ``checkpoint.load`` — before a restore
  (distributed/checkpoint/);
* ``elastic.gc`` — checkpoint garbage collection
  (distributed/fleet/elastic.py ``ElasticManager._gc``).

`flip_checkpoint_shards` is the disk-level sibling of these: silent
damage to a committed checkpoint's data files. The value sites of the
JAX engine (``serving.kv_page``, ``serving.logits``) and the fleet's
sites come with the modules that hold them (ROADMAP.md queue A, item 8).
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Type

from .. import observability as telemetry

__all__ = ["FaultError", "FaultInjector", "fault_point", "fault_value",
           "value_armed", "flip_checkpoint_shards"]

CORRUPT_MODES = ("bitflip", "nan", "scale")

# chaos runs assert fault counts via telemetry.snapshot() (site label),
# not only via exception side effects
_M_FAULT_FIRES = telemetry.counter(
    "pdt_faults_fired_total",
    "Injected faults raised, by fault-point site.", ("site",))


class FaultError(RuntimeError):
    """An injected fault. ``site`` names the fault point that fired."""

    def __init__(self, message: str, site: str = ""):
        super().__init__(message)
        self.site = site


@dataclass
class _Rule:
    site: str
    nth: Optional[int]
    probability: Optional[float]
    always: bool
    times: Optional[int]           # max firings; None = unlimited
    exc: Type[BaseException]
    corrupt: Optional[str] = None  # bitflip|nan|scale: a VALUE rule
    factor: float = 1e6            # scale-mode multiplier
    tag: Optional[str] = None      # only visits carrying this tag count
    calls: int = 0
    trips: int = 0


# innermost (most recently entered) injector last
_ACTIVE: List["FaultInjector"] = []


class FaultInjector:
    """Seedable, scoped registry of fault rules (see module docstring)."""

    def __init__(self, seed: int = 0):
        self._rules: Dict[str, _Rule] = {}
        self._rng = random.Random(seed)

    # -- arming --------------------------------------------------------
    def arm(self, site: str, *, nth: Optional[int] = None,
            probability: Optional[float] = None, always: bool = False,
            times: Optional[int] = None,
            exc: Type[BaseException] = FaultError) -> "FaultInjector":
        """Arm `site` with exactly one trigger mode:

        * ``nth=k``       — fire on the k-th visit (1-based), once
        * ``probability=p`` — fire each visit with prob. p (seeded RNG)
        * ``always=True`` — fire on every visit

        ``times`` caps total firings (default: 1 for ``nth``, unlimited
        otherwise). ``exc`` is the exception class raised (it receives
        one message argument). Re-arming a site replaces its rule."""
        self._rules[site] = self._make_rule(site, nth, probability,
                                            always, times, exc)
        return self

    def arm_corrupt(self, site: str, *, mode: str = "bitflip",
                    nth: Optional[int] = None,
                    probability: Optional[float] = None,
                    always: bool = False,
                    times: Optional[int] = None,
                    factor: float = 1e6,
                    tag: Optional[str] = None) -> "FaultInjector":
        """Arm a VALUE site (module docstring, CORRUPT mode): instead
        of raising, a firing visit MUTATES the array passing through
        ``fault_value(site, arr)`` — ``mode`` picks the damage shape
        (``bitflip`` | ``nan`` | ``scale``, with ``factor`` the scale
        multiplier), the trigger set is arm()'s, and ``tag=`` pins the
        rule to visits carrying that tag (a fleet replica's index) so
        one sick chip can be simulated inside a healthy fleet."""
        if mode not in CORRUPT_MODES:
            raise ValueError(f"corrupt mode {mode!r}: "
                             f"{'|'.join(CORRUPT_MODES)}")
        rule = self._make_rule(site, nth, probability, always, times,
                               FaultError)
        rule.corrupt = mode
        rule.factor = float(factor)
        rule.tag = None if tag is None else str(tag)
        self._rules[site] = rule
        return self

    @staticmethod
    def _make_rule(site, nth, probability, always, times,
                   exc) -> _Rule:
        modes = (nth is not None) + (probability is not None) + bool(always)
        if modes != 1:
            raise ValueError(
                "arm() needs exactly one of nth=, probability=, always=")
        if nth is not None and nth < 1:
            raise ValueError(f"nth must be >= 1, got {nth}")
        if probability is not None and not 0.0 <= probability <= 1.0:
            raise ValueError(f"probability must be in [0, 1], got "
                             f"{probability}")
        if times is None and nth is not None:
            times = 1
        return _Rule(site, nth, probability, always, times, exc)

    def disarm(self, site: str):
        self._rules.pop(site, None)

    # -- introspection -------------------------------------------------
    def calls(self, site: str) -> int:
        """Visits to `site` while this injector was active."""
        r = self._rules.get(site)
        return r.calls if r else 0

    def trips(self, site: str) -> int:
        """Faults actually raised at `site` by this injector."""
        r = self._rules.get(site)
        return r.trips if r else 0

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {s: {"calls": r.calls, "trips": r.trips}
                for s, r in self._rules.items()}

    # -- scoping -------------------------------------------------------
    def __enter__(self) -> "FaultInjector":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _ACTIVE.remove(self)
        return False

    # -- firing --------------------------------------------------------
    def _should_fire(self, rule: _Rule) -> bool:
        rule.calls += 1
        if rule.times is not None and rule.trips >= rule.times:
            return False
        return (rule.always
                or (rule.nth is not None and rule.calls == rule.nth)
                or (rule.probability is not None
                    and self._rng.random() < rule.probability))

    def _visit(self, site: str):
        rule = self._rules[site]
        if not self._should_fire(rule):
            return
        if rule.corrupt is not None:
            # a value rule reached through fault_point: there is no
            # array to mutate here — the visit counts, nothing fires
            return
        rule.trips += 1
        _M_FAULT_FIRES.inc(site=site)
        telemetry.event("fault.fire", site=site, visit=rule.calls,
                        exc=rule.exc.__name__)
        msg = f"injected fault at {site!r} (visit #{rule.calls})"
        err = rule.exc(msg)
        if isinstance(err, FaultError):
            err.site = site
        raise err

    def _visit_value(self, site: str, arr):
        """Value-site visit: corrupt rules mutate and return a NEW
        array (callers detect firing by identity — ``mut is not arr``);
        raise rules raise exactly like fault_point."""
        rule = self._rules[site]
        if not self._should_fire(rule):
            return arr
        rule.trips += 1
        _M_FAULT_FIRES.inc(site=site)
        if rule.corrupt is None:
            telemetry.event("fault.fire", site=site, visit=rule.calls,
                            exc=rule.exc.__name__)
            msg = f"injected fault at {site!r} (visit #{rule.calls})"
            err = rule.exc(msg)
            if isinstance(err, FaultError):
                err.site = site
            raise err
        telemetry.event("fault.fire", site=site, visit=rule.calls,
                        exc=f"corrupt:{rule.corrupt}")
        return _mutate(arr, rule, self._rng)


def flip_checkpoint_shards(step_dir, group: str = "model") -> int:
    """Corrupt the middle byte of every data file of a checkpoint group
    (``<step_dir>/<group>/d/*``, `distributed.checkpoint.storage`) —
    silent disk damage under a still-valid `.done` marker, for the chaos
    tests and the recipes' resume drill (≙ `flip_ocdbt_shards`,
    `paddle_tpu/utils/faults.py` :314, for this package's layout).
    Raises when no data file exists, so a layout change fails loudly
    here and not in a later resume assertion. Returns the files
    damaged."""
    import glob
    import os
    files = glob.glob(os.path.join(str(step_dir), group, "d", "*"))
    if not files:
        raise FileNotFoundError(f"no data files under {step_dir}/{group}/d")
    for p in files:
        with open(p, "r+b") as f:
            size = f.seek(0, os.SEEK_END)
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
    return len(files)


def _mutate(arr, rule: _Rule, rng: random.Random):
    """Apply `rule`'s corrupt mode to a COPY of `arr`, a numpy array or a
    torch tensor; the same type comes back (a tensor on its own device,
    in its dtype). Element choice draws from the injector's seeded RNG,
    so damage is reproducible, and on numpy input byte-equal to the JAX
    package's for the same seed and arming. A bfloat16 tensor is damaged
    in its raw 16-bit words (numpy has no bfloat16): "nan" writes a quiet
    NaN word, "scale" scales the values."""
    import numpy as np
    tensor = arr if type(arr).__module__.startswith("torch") else None
    bf16 = False
    if tensor is None:
        src = np.asarray(arr)
    else:
        import torch
        host = tensor.detach().cpu()
        bf16 = host.dtype == torch.bfloat16
        src = (host.view(torch.int16) if bf16 else host).numpy()
    out = np.array(src)                       # host copy, owned
    flat = out.reshape(-1)
    if flat.size == 0:
        return arr                            # nothing to damage
    idx = rng.randrange(flat.size)
    if rule.corrupt == "scale":
        if bf16:
            return (tensor * rule.factor).to(tensor.dtype)
        out = (out * rule.factor).astype(out.dtype)
    elif rule.corrupt == "nan":
        if np.issubdtype(out.dtype, np.floating):
            flat[idx] = np.nan
        elif bf16:
            flat[idx] = 0x7FC0                # bfloat16 quiet NaN
        else:
            # integer arrays have no NaN: poison with an extreme value
            # (out of every real vocab, visibly wrong in any stream)
            flat[idx] = -(2 ** 31 - 1)
    else:                                     # bitflip
        b = flat[idx:idx + 1].tobytes()
        # flip the HIGH byte with 0xFF: for little-endian floats that is
        # the sign and the top of the exponent — loud
        blob = bytearray(b)
        blob[-1] ^= 0xFF
        flat[idx:idx + 1] = np.frombuffer(bytes(blob), out.dtype)
    if tensor is None:
        return out
    import torch
    res = torch.from_numpy(out)
    if bf16:
        res = res.view(torch.bfloat16)
    return res.to(tensor.device)


def value_armed(site: str, tag=None) -> bool:
    """True iff an active injector holds a rule for value site `site`
    that applies to `tag` — the zero-cost-when-idle guard callers use
    before gathering data for :func:`fault_value`."""
    if not _ACTIVE:
        return False
    for inj in reversed(_ACTIVE):
        rule = inj._rules.get(site)
        if rule is not None:
            return rule.tag is None or rule.tag == (
                None if tag is None else str(tag))
    return False


def fault_value(site: str, arr, tag=None):
    """Declare a named VALUE fault site over `arr` (module docstring,
    CORRUPT mode). Returns `arr` untouched unless the innermost active
    injector armed `site` (and its ``tag=`` filter matches): corrupt
    rules return a mutated COPY — callers detect firing via
    ``result is not arr`` and commit the damage — and raise rules
    raise, so every value site doubles as an exception site. Visits
    with a non-matching tag neither count nor fire (the rule is
    pinned to one replica's data)."""
    if not _ACTIVE:
        return arr
    for inj in reversed(_ACTIVE):
        rule = inj._rules.get(site)
        if rule is None:
            continue
        if rule.tag is not None and rule.tag != (
                None if tag is None else str(tag)):
            return arr
        return inj._visit_value(site, arr)
    return arr


def fault_point(site: str) -> None:
    """Declare a named fault site. No-op unless an active
    :class:`FaultInjector` armed `site` — then the INNERMOST injector
    with a rule for `site` decides alone (it shadows outer rules, even
    when it declines to fire)."""
    if not _ACTIVE:
        return
    for inj in reversed(_ACTIVE):
        if site in inj._rules:
            inj._visit(site)
            return
