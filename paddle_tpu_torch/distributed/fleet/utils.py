"""Activation recompute (≙ `paddle_tpu/distributed/fleet/utils/__init__.py`:
`recompute`, `_POLICIES`, `_resolve_policy`).

`recompute(function, *args, **kwargs)` runs ``function`` under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`: its forward
keeps none of the activations inside ``function`` (only its inputs), and
the backward runs ``function`` a second time to rebuild them. What may
be kept anyway is the JAX package's policy, by name:

    None / "full" / "nothing_saveable"   nothing (full recompute)
    "dots" / "dots_saveable"             every matmul output
    "dots_with_no_batch_dims"            the 2-D products (``aten.mm`` /
                                         ``aten.addmm``), not the batched
    "everything_saveable"                every output

where JAX picks a `jax.checkpoint_policies` entry, the port gives the
same choice to selective activation checkpointing
(`torch.utils.checkpoint.create_selective_checkpoint_contexts`).

RNG. JAX pins one dropout key for both runs. The port's dropouts draw
from explicit `torch.Generator`s (`nn.layers.Dropout.generator`, set by
`nn.layers.set_generator`), which torch's ``preserve_rng_state`` does not
cover (it restores only the default CPU and CUDA generators). With
``preserve_rng_state`` the state of every such generator reachable from
``function`` (a module's submodules, a bound method's owner's, a
closure's modules) is taken before the forward and set again for the
recompute, and the generators are left after the recompute where the
forward left them: the masks of both runs are the same bits.

The kernels' autograd Functions keep their activations in
``ctx.save_for_backward``, so the checkpoint drops them too. Under
recompute every kernel of ``function`` launches again in the backward,
and the launch counters (`ops.launch_counts`) count those launches: they
are real launches. A profile fence inside ``function`` is passed twice a
step for the same reason.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_aten = torch.ops.aten
_DOTS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}
_DOTS_NO_BATCH = {_aten.mm, _aten.addmm}

# policy names -> what is saved (None: nothing, full recompute)
_POLICIES = {
    None: None,
    "full": None,
    "dots": "dots",
    "dots_saveable": "dots",
    "dots_with_no_batch_dims": "dots_with_no_batch_dims",
    "nothing_saveable": None,
    "everything_saveable": "everything_saveable",
}


def _save_if(ops):
    def policy(ctx, op, *args, **kwargs):
        if ops is None or op.overloadpacket in ops:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


_SAVERS = {"dots": _save_if(_DOTS),
           "dots_with_no_batch_dims": _save_if(_DOTS_NO_BATCH),
           "everything_saveable": _save_if(None)}


def _resolve_policy(name):
    """The selective-checkpoint policy function of ``name``, or None to
    save nothing; raises ValueError for a name JAX does not know."""
    if name not in _POLICIES:
        raise ValueError(
            f"unknown recompute policy {name!r}; known: "
            f"{sorted(k for k in _POLICIES if isinstance(k, str))}")
    key = _POLICIES[name]
    return None if key is None else _SAVERS[key]


def _modules(function) -> list:
    found = []
    if isinstance(function, torch.nn.Module):
        found.append(function)
    owner = getattr(function, "__self__", None)
    if isinstance(owner, torch.nn.Module):
        found.append(owner)
    for cell in getattr(function, "__closure__", None) or ():
        try:
            v = cell.cell_contents
        except ValueError:  # pragma: no cover - an empty cell
            continue
        if isinstance(v, torch.nn.Module):
            found.append(v)
    return found


def _generators(function) -> list:
    """The explicit generators of the modules ``function`` reaches, each
    once."""
    out, seen = [], set()
    for root in _modules(function):
        for m in root.modules():
            g = getattr(m, "generator", None)
            if isinstance(g, torch.Generator) and id(g) not in seen:
                seen.add(id(g))
                out.append(g)
    return out


class _ReplayGenerators:
    """Entered around the recompute: sets each generator to its state
    before the forward, and on exit back to where it stood."""

    def __init__(self, gens):
        self.gens = gens
        self.before = [g.get_state() for g in gens]
        self.after = None

    def __enter__(self):
        self.after = [g.get_state() for g in self.gens]
        for g, s in zip(self.gens, self.before):
            g.set_state(s)

    def __exit__(self, *exc):
        for g, s in zip(self.gens, self.after):
            g.set_state(s)
        return False


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def recompute(function: Callable, *args, preserve_rng_state: bool = True,
              use_reentrant: bool = True, policy=None, **kwargs) -> Any:
    """Run ``function(*args, **kwargs)`` without keeping its internal
    activations; the backward recomputes them. ``policy`` names what may
    be kept anyway (module docstring). ``use_reentrant`` is accepted for
    the JAX signature; the checkpoint is always the non-reentrant one,
    which takes keyword arguments, any output structure and inputs that
    need no gradient."""
    saver = _resolve_policy(policy)
    gens = _generators(function) if preserve_rng_state else []
    replay = _ReplayGenerators(gens) if gens else contextlib.nullcontext()

    def context_fn():
        if saver is None:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        else:
            fwd, rec = create_selective_checkpoint_contexts(saver)
        return fwd, _both(replay, rec)

    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state,
                      context_fn=context_fn, **kwargs)


__all__ = ["recompute"]
