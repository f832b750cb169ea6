"""Request states and token selection.

≙ `paddle_tpu/models/generation.py` :32 (`RequestStatus`) and :52-58
(the greedy branch of `_sample_token`). Sampling is not ported yet.
"""
from __future__ import annotations

import torch


class RequestStatus:
    """Request lifecycle states. A request is QUEUED on entry to the
    admission queue, RUNNING while it owns a slot, and ends in exactly
    one terminal state: FINISHED (eos / max_new_tokens / cache end) or
    PREEMPTED (evicted for pool pressure more than `max_preemptions`
    times). TIMEOUT and FAILED belong to engine features this port does
    not have yet; they are kept so that the states read as the JAX
    package's do."""

    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    TIMEOUT = "timeout"
    FAILED = "failed"
    PREEMPTED = "preempted"
    TERMINAL = frozenset({FINISHED, TIMEOUT, FAILED, PREEMPTED})


def _sample_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy selection: logits (B, V) -> tokens (B,) int32, the argmax
    in f32 (ties go to the lowest index, as in JAX)."""
    return logits.float().argmax(dim=-1).to(torch.int32)
