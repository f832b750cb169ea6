"""Speculative decoding: a draft model proposes, the target verifies.

≙ `paddle_tpu/models/speculative.py`: `spec_accept_greedy` :41,
`_spec_accept` :74 and `speculative_generate` :113 with its loop
`_build_spec` :181-333. A small DRAFT model proposes ``k`` tokens
autoregressively, then the TARGET scores all of them in ONE forward (the
verify pass) and keeps the longest prefix that matches its own choices,
plus one token from the mismatch position. Greedy speculative decoding
is lossless: the emitted stream equals target-only greedy exactly, for
any draft. Sampling is rejection sampling (Leviathan et al.): the
emitted distribution equals target-only sampling.

The JAX package compiles the whole loop, both prefills and a
`lax.while_loop` of rounds, into one program. Here it runs eagerly on
the target's device, as `generate()` does: both prefills through the
model's mask-free tuple-cache prefill (the flash attention kernel on the
card), each draft step a cached S = 1 forward at the (B,) per-row
positions, the verify pass the S = K + 1 traced branch at those
positions. Every value a round carries stays on the device and a round
reads nothing back; the loop's condition is one device-to-host read a
round. Sampling draws from an explicit `torch.Generator` (the PyTorch
form of JAX's key): the same distributions as JAX's, not the same
numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from .generation import _sample_token, gumbel_pick

__all__ = ["speculative_generate", "spec_accept_greedy", "_spec_accept"]


def spec_accept_greedy(greedy, props):
    """Greedy acceptance, the one copy of the prefix-match math that
    `speculative_generate` and the serving engine's verify pass share.

    ``greedy`` (R, K+1) int: the target's greedy choice at each of the
    K+1 verify rows (row i scores the token after position i); ``props``
    (R, K) int: the draft's proposals. Proposal i is accepted iff it
    equals the target's choice at the row before it and every earlier
    proposal was accepted. Returns (j (R,) accepted count, bonus (R,)
    ``greedy[r, j]``: the correction on a rejection, the free extra
    token on a full accept), int32. Emitting ``greedy[r, :j+1]``
    reproduces target-only greedy exactly.

    Ragged rows may be padded: a sentinel proposal that never matches
    (-1) caps ``j`` at the real proposal count. Two numpy arrays run in
    numpy (the engine calls this on the host every round); tensors run
    on their device."""
    if isinstance(greedy, np.ndarray) and isinstance(props, np.ndarray):
        k = props.shape[1]
        match = props == greedy[:, :k]
        j = np.cumprod(match.astype(np.int32), 1).sum(1).astype(np.int32)
        return j, np.take_along_axis(greedy, j[:, None], 1)[:, 0] \
            .astype(np.int32)
    k = props.shape[1]
    match = props == greedy[:, :k]
    j = torch.cumprod(match.to(torch.int32), 1).sum(1)
    bonus = greedy.gather(1, j[:, None].long())[:, 0]
    return j.to(torch.int32), bonus.to(torch.int32)


def _uniform(shape, generator, device):
    return torch.rand(shape, generator=generator, device=device).clamp_min(
        torch.finfo(torch.float32).tiny)


def _spec_accept(p_logp, q_logp, props, generator=None):
    """Rejection-sampling acceptance (Leviathan et al.): the target's
    log-probs ``p_logp`` (R, K+1, V) over positions 0..K, the draft's
    ``q_logp`` (R, K, V) for its proposals ``props`` (R, K). Proposal i
    is accepted with probability min(1, p_i / q_i); at the first
    rejection the token is drawn from norm(max(p_i - q_i, 0)); after a
    full accept the bonus is drawn from p_K. Returns (j (R,) accepted
    count, repl (R,) the token emitted after the accepted prefix),
    int32. The uniforms come from ``generator`` on the inputs' device."""
    r, k = props.shape
    dev = p_logp.device
    idx = props[:, :, None].long()
    u = _uniform((r, k), generator, dev)
    p_at = p_logp[:, :k].gather(2, idx)[:, :, 0]
    q_at = q_logp.gather(2, idx)[:, :, 0]
    accept = u < torch.exp(torch.clamp(p_at - q_at, max=0.0))
    j = torch.cumprod(accept.to(torch.int32), 1).sum(1)
    v = p_logp.shape[-1]
    # the residual at the rejection point; j == K is the bonus position,
    # where q is absent and the residual is p_K itself
    p_j = p_logp.gather(1, j.clamp(max=k)[:, None, None].long()
                        .expand(r, 1, v))[:, 0]
    q_j = q_logp.gather(1, j.clamp(max=k - 1)[:, None, None].long()
                        .expand(r, 1, v))[:, 0]
    q_j = torch.where((j < k)[:, None], q_j, float("-inf"))
    resid = torch.clamp(torch.exp(p_j) - torch.exp(q_j), min=0.0)
    # all-zero residual (p == q exactly): fall back to p_j
    resid = torch.where(resid.sum(-1, keepdim=True) > 0, resid,
                        torch.exp(p_j))
    logr = torch.log(torch.clamp(resid, min=1e-38))
    repl = gumbel_pick(logr, _uniform(logr.shape, generator, dev))
    return j.to(torch.int32), repl


@torch.no_grad()
def speculative_generate(target, draft, input_ids,
                         max_new_tokens: int = 32,
                         num_draft_tokens: int = 4,
                         eos_token_id: int | None = None,
                         max_cache_len: int | None = None,
                         do_sample: bool = False,
                         temperature: float = 1.0,
                         generator: torch.Generator | None = None):
    """Speculative decode. Returns (ids (B, max_new_tokens) int32,
    acceptance rate, a 0-d f32 tensor: the mean fraction of drafted
    tokens accepted, live rows only).

    ``do_sample=False``: greedy matching, the output equals target-only
    greedy exactly. ``do_sample=True``: proposals sampled from the draft
    at ``temperature`` and accepted by `_spec_accept`; the emitted
    distribution equals target-only sampling. ``generator`` is the
    sampling stream, a `torch.Generator` on the target's device, or None
    for one seeded from torch's default generator. ``target`` and
    ``draft`` share a vocabulary and a device; each keeps its own
    caches. Past an ``eos_token_id`` a row emits 0, as in JAX."""
    if target.config.vocab_size != draft.config.vocab_size:
        raise ValueError(
            f"target vocab {target.config.vocab_size} != draft vocab "
            f"{draft.config.vocab_size}")
    if num_draft_tokens < 1:
        raise ValueError("num_draft_tokens must be >= 1")
    if do_sample and temperature <= 0:
        raise ValueError(
            f"temperature must be > 0 with do_sample, got {temperature} "
            "(use do_sample=False for deterministic greedy)")
    dev = target.device
    ids = torch.as_tensor(input_ids).to(dev, torch.int32)
    b, prompt_len = ids.shape
    n_new, k = int(max_new_tokens), int(num_draft_tokens)
    cache_len = int(max_cache_len
                    or min(target.config.max_position_embeddings,
                           prompt_len + n_new + k + 1))
    if prompt_len + n_new + k + 1 > cache_len:
        raise ValueError(
            f"prompt {prompt_len} + max_new_tokens {n_new} + draft slack "
            f"{k + 1} exceeds cache length {cache_len}")
    temp = float(temperature)
    if do_sample and generator is None:
        generator = torch.Generator(dev).manual_seed(
            int(torch.randint(0, 2 ** 62, ()).item()))
    t_logits, t_caches = target._zero_caches_prefill(ids, cache_len)
    _, d_caches = draft._zero_caches_prefill(ids, cache_len)
    if do_sample:
        tok0 = gumbel_pick(t_logits.float() / temp,
                           _uniform(t_logits.shape, generator, dev))
    else:
        tok0 = _sample_token(t_logits)
    trash = n_new + k          # the slack column rejected lanes write to
    out = torch.zeros(b, n_new + k + 1, dtype=torch.int32, device=dev)
    out[:, 0] = tok0
    n = torch.ones(b, dtype=torch.int32, device=dev)
    pos = torch.full((b,), prompt_len, dtype=torch.int32, device=dev)
    fin = tok0 == eos_token_id if eos_token_id is not None \
        else torch.zeros(b, dtype=torch.bool, device=dev)
    drafted = torch.zeros((), dtype=torch.int32, device=dev)
    acc_tot = torch.zeros((), dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    i_ar = torch.arange(k + 1, device=dev)[None, :]
    last = tok0
    while True:
        # a row is done once it finished (EOS) or holds its max_new_tokens;
        # it rides on at position 0 (what it writes there is never read)
        # and emits and counts nothing. JAX keeps such a row running past
        # the buffer, drops its writes past the caches and counts its
        # drafts, so in a batch whose rows end in different rounds the
        # two acceptance rates differ; the ids are the same
        done = fin | (n >= n_new)
        if not bool((~done).any()):
            break
        at = torch.where(done, 0, pos).to(torch.int32)
        # 1) the draft proposes K tokens from `last`, greedy or sampled
        # from q at `temp` with q's log-probs kept for the acceptance test
        props, q_logp, tok, p = [], [], last, at
        for _ in range(k):
            lg = draft(tok[:, None], d_caches, position_offset=p)[:, 0]
            if do_sample:
                logp = torch.log_softmax(lg.float() / temp, dim=-1)
                tok = gumbel_pick(logp, _uniform(logp.shape, generator,
                                                 dev))
                q_logp.append(logp)
            else:
                tok = _sample_token(lg)
            props.append(tok)
            p = p + 1
        props = torch.stack(props, 1)                      # (B, K)
        # 2) the target verifies [last, p_1..p_K] in ONE forward
        x = torch.cat([last[:, None], props], 1)
        v_logits = target(x, t_caches, position_offset=at)
        # the draft's CATCH-UP: the K steps wrote [last, p_1..p_{K-1}] at
        # pos..pos+K-1 but never fed p_K, so after a full accept the next
        # round would attend a hole at pos+K (self-draft acceptance 0.67
        # instead of 1.0 without it); one S = 1 forward fills that row
        draft(props[:, k - 1:], d_caches, position_offset=at + k)
        # 3) acceptance
        if do_sample:
            p_logp = torch.log_softmax(v_logits.float() / temp, dim=-1)
            j, bonus = _spec_accept(p_logp, torch.stack(q_logp, 1), props,
                                    generator)
        else:
            j, bonus = spec_accept_greedy(_sample_token(
                v_logits.reshape(b * (k + 1), -1)).reshape(b, k + 1), props)
        tokmat = torch.where(i_ar < j[:, None],
                             torch.cat([props, props[:, :1]], 1),
                             bonus[:, None])                # (B, K+1)
        keep = (i_ar <= j[:, None]) & ~done[:, None]
        if eos_token_id is not None:
            # everything after the first EOS of the round is dropped
            hit = (tokmat == eos_token_id).to(torch.int32)
            keep = keep & (torch.cumsum(hit, 1) - hit == 0)
        # the last round of a row may overshoot max_new_tokens by up to K:
        # those lanes go to the slack columns, the buffer is cut after
        idx = torch.where(keep, n[:, None] + i_ar, trash)
        out[rows, idx] = torch.where(keep, tokmat, 0)
        if eos_token_id is not None:
            fin = fin | (keep & (tokmat == eos_token_id)).any(1)
        n = n + keep.to(torch.int32).sum(1)
        # the caches advance by the rows the target keeps: last and the
        # accepted proposals, j + 1
        pos = pos + torch.where(done, 0, j + 1).to(torch.int32)
        last = torch.where(done, last, bonus)
        acc_tot = acc_tot + torch.where(done, 0, j).sum().to(torch.int32)
        # only live rows are charged their K drafts
        drafted = drafted + k * (~done).sum().to(torch.int32)
    rate = acc_tot.float() / torch.clamp(drafted, min=1).float()
    return out[:, :n_new], rate
