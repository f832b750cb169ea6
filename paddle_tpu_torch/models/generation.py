"""Request states, token selection and `generate()`.

≙ `paddle_tpu/models/generation.py`: `RequestStatus` :32, `_sample_token`
:52-76 (greedy, and sampling under temperature / top-k / top-p), the
logit processors `_ban_repeat_ngrams` :79-101 and `_penalize` :104-117,
and `GenerationMixin.generate` :155-229 with `_zero_caches_prefill`
:232-245, `_build_generate` :247-339 (greedy and sampling) and
`_build_beam_generate` :341-479 (beam search).

The JAX package compiles the whole of a generation, prefill and a scan
over the decode steps, into one program per signature. Here the loop
runs eagerly on the model's device: one causal prefill into zeroed (B,
cache_len, HK, D) caches, then one cached forward per token. Every
value the loop carries (tokens, finished flags, the seen-token mask, the
n-gram buffer, beam scores) stays on the device, and a step's position
is the loop's own host counter, so no step reads the device from the
host: the loop never waits for the card until the caller reads the
result. Sampling draws from an explicit `torch.Generator` on the
logits' device by the Gumbel-max trick, ``argmax(logits + G)``, which
is how `jax.random.categorical` draws; the draws are the same
distribution as JAX's, not the same numbers.
"""
from __future__ import annotations

import torch

from ..observability import span as telemetry_span

NEG_INF = -1e30


class RequestStatus:
    """Request lifecycle states. A request is QUEUED on entry to the
    admission queue, RUNNING while it owns a slot, and ends in exactly
    one terminal state: FINISHED (eos / max_new_tokens / cache end),
    TIMEOUT (its deadline or queue-time budget passed), or PREEMPTED
    (evicted for pool pressure more than `max_preemptions` times) or
    FAILED (its admission raised: the engine's failure isolation)."""

    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    TIMEOUT = "timeout"
    FAILED = "failed"
    PREEMPTED = "preempted"
    TERMINAL = frozenset({FINISHED, TIMEOUT, FAILED, PREEMPTED})


def _sample_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy selection: logits (B, V) -> tokens (B,) int32, the argmax
    in f32 (ties go to the lowest index, as in JAX). The serving engine's
    selection: it needs no log-probability."""
    return logits.float().argmax(dim=-1).to(torch.int32)


def filter_logits(logits, temperature=1.0, top_k=0, top_p=1.0):
    """The sampling filter of `_sample_token` on (B, V) f32 logits:
    divided by ``temperature``; with ``top_k`` > 0 every logit below the
    k-th largest set to -1e30 (ties at it kept); with ``top_p`` < 1
    every logit below the cutoff set to -1e30, the cutoff the smallest
    sorted logit whose preceding cumulative probability is < top_p (the
    most likely token is always kept)."""
    if temperature != 1.0:
        logits = logits / temperature
    if top_k and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits, float("inf")) \
            .amin(dim=-1)
        logits = torch.where(logits < cutoff[:, None], NEG_INF, logits)
    return logits


def gumbel_pick(logits, u, temperature=1.0, top_k=0, top_p=1.0):
    """The sampling arm of `_sample_token` on (B, V) f32 logits, given
    uniforms ``u`` in (0, 1) of the same shape: one token a row drawn
    from softmax(`filter_logits`' result) as `jax.random.categorical`
    draws, ``argmax(filtered + G)`` with ``G = -log(-log u)`` standard
    Gumbel noise. (B,) int32."""
    return _sample_token(filter_logits(logits, temperature, top_k, top_p)
                         - torch.log(-torch.log(u)))


def choose_token(logits, strategy="greedy_search", generator=None,
                 temperature=1.0, top_k=0, top_p=1.0):
    """≙ `_sample_token`: logits (B, V) -> (tokens (B,) int32, the
    chosen tokens' log-probabilities (B,) under the unfiltered
    log-softmax of the f32 logits). Greedy takes the argmax; sampling
    is `gumbel_pick` with uniforms from ``generator`` (on the logits'
    device)."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    if strategy == "greedy_search":
        tok = _sample_token(logits)
    else:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device).clamp_min(
            torch.finfo(torch.float32).tiny)
        tok = gumbel_pick(logits, u, temperature, top_k, top_p)
    return tok, logp.gather(-1, tok[:, None].long())[:, 0]


_MASK32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, in 16-bit halves so that no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _MASK32


def _hash32(x):
    """A 32-bit integer mix (xor-shift, multiply, twice: "lowbias32"), a
    bijection of [0, 2**32), elementwise on int64 tensors."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_uniform(key, shape):
    """Uniforms in (0, 1) of ``shape`` (R, V), float32, made without a
    generator's state from ``key``, a (2,) int32 tensor (seed, counter)
    on the device: element (r, v) is a hash of (seed, counter, r·V + v),
    its top 23 bits centred in their interval (exact in float32, so no
    uniform rounds to 0 or 1). The same key gives the
    same numbers on every run and every device, and a CUDA graph that
    reads its key from an input replays new numbers once the counter in
    that input moves: the serving engine's sampling stream."""
    k = key.to(torch.int64) & _MASK32
    base = _hash32(_hash32(k[0]) ^ k[1])
    salt = _hash32(base ^ 0x9E3779B9)
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, device=key.device, dtype=torch.int64)
    h = _hash32((_hash32(idx ^ base) + salt) & _MASK32).reshape(shape)
    return ((h >> 9) * 2 + 1).to(torch.float32) * 2.0 ** -24


def sample_tokens(logits, key, temperature=1.0, top_k=0, top_p=1.0):
    """The engine's sampling: (B, V) logits -> (B,) int32 tokens by
    `gumbel_pick` over f32 logits with `counter_uniform`'s uniforms for
    ``key`` (seed, counter)."""
    logits = logits.float()
    return gumbel_pick(logits, counter_uniform(key, logits.shape),
                       temperature, top_k, top_p)


def ban_repeat_ngrams(logits, buf, cur: int, n: int):
    """≙ `_ban_repeat_ngrams` (the ``no_repeat_ngram_size`` processor):
    set to -1e30 every token v that would complete an n-gram already in
    ``buf[:, :cur]`` (prompt and tokens emitted so far). buf (R, L)
    int32 on the logits' device; ``cur`` the count of valid tokens, a
    host int; logits (R, V). Windows over the whole buffer, those not
    wholly before the suffix masked, as JAX's static shapes have it."""
    r, length = buf.shape
    v_size = logits.shape[-1]
    if length < n:
        return logits
    dev = buf.device
    start = min(max(cur - (n - 1), 0), length - (n - 1))
    suffix = buf[:, start:start + n - 1]                    # (R, n-1)
    starts = torch.arange(length - n + 1, device=dev)
    win = starts[:, None] + torch.arange(n - 1, device=dev)[None, :]
    windows = buf[:, win]                                   # (R, W, n-1)
    match = (windows == suffix[:, None, :]).all(-1) \
        & (starts[None, :] <= cur - n)                      # (R, W)
    ban_tok = buf[:, starts + n - 1]
    idx = torch.where(match, ban_tok, v_size).long()
    banned = torch.zeros(r, v_size + 1, dtype=torch.bool, device=dev)
    banned.scatter_(1, idx, True)
    return logits.masked_fill(banned[:, :v_size], NEG_INF)


def penalize(logits, seen, t: int, rp: float, min_new: int, eos):
    """≙ `_penalize`, the processors every strategy shares: with ``rp``
    != 1 the CTRL repetition penalty on the tokens ``seen`` marks
    ((..., V) bool: positive logits divided by rp, negative multiplied),
    and -1e30 on ``eos`` while ``t``, the index of the token being
    generated, is below ``min_new``."""
    if rp != 1.0:
        pen = torch.where(logits > 0, logits / rp, logits * rp)
        logits = torch.where(seen, pen, logits)
    if eos is not None and min_new > 0 and t < min_new:
        col = torch.arange(logits.shape[-1], device=logits.device) == eos
        logits = torch.where(col, NEG_INF, logits)
    return logits


def _mark(seen, tok):
    """``seen`` (R, V) with each row's token ``tok`` (R,) set."""
    return seen.scatter(1, tok[:, None].long(), True)


class GenerationMixin:
    """`generate()` for cache-capable causal LMs (`LlamaForCausalLM`):
    ``forward(ids, past_key_values=[(k, v), ...], position_offset=...)``
    writes the caches in place and returns (B, S, V) logits; the decoder
    stack ``self.model`` (hidden states) and ``logits(hidden)`` let the
    prefill take the vocab matmul of its last row alone.

    ≙ PaddleNLP's ``GenerationMixin.generate`` surface, as the JAX
    package has it: greedy_search / sampling / beam_search; returns (ids,
    scores) — for greedy and sampling ids (B, n_new) int32 and each
    token's log-probability (B, n_new) f32; for beam search the best
    beam of each row (B, n_new) and its length-normalized score (B,)."""

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 decode_strategy: str = "greedy_search",
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, eos_token_id: int | None = None,
                 max_cache_len: int | None = None, use_cache: bool = True,
                 num_beams: int = 1, length_penalty: float = 0.0,
                 repetition_penalty: float = 1.0,
                 min_new_tokens: int = 0,
                 no_repeat_ngram_size: int = 0,
                 generator: torch.Generator | None = None):
        """The JAX ``generate``'s arguments, checks and errors, on the
        model's own device. ``generator`` is the sampling stream (the
        PyTorch form of JAX's ``default_generator.next_key()``): a
        `torch.Generator` on the model's device, or None for one seeded
        from torch's default generator. ``use_cache`` is accepted and
        ignored, as in JAX (the loop always caches). Past an
        ``eos_token_id`` a row emits it with log-probability 0."""
        if decode_strategy not in ("greedy_search", "sampling",
                                   "beam_search"):
            raise ValueError(
                f"decode_strategy {decode_strategy!r}: greedy_search, "
                "sampling, or beam_search")
        if decode_strategy == "beam_search" and num_beams < 2:
            raise ValueError("beam_search needs num_beams >= 2")
        if repetition_penalty <= 0:
            raise ValueError(
                f"repetition_penalty must be > 0, got {repetition_penalty}"
                " (1.0 disables it)")
        if no_repeat_ngram_size < 0:
            raise ValueError(
                f"no_repeat_ngram_size must be >= 0, got "
                f"{no_repeat_ngram_size} (0 disables it)")
        cfg = self.config
        dev = self.device
        ids = torch.as_tensor(input_ids).to(dev, torch.int32)
        b, prompt_len = ids.shape
        n_new = int(max_new_tokens)
        cache_len = int(max_cache_len or min(cfg.max_position_embeddings,
                                             prompt_len + n_new))
        if prompt_len + n_new > cache_len:
            raise ValueError(
                f"prompt {prompt_len} + max_new_tokens {n_new} exceeds "
                f"cache length {cache_len}")
        if decode_strategy == "sampling" and generator is None:
            generator = torch.Generator(dev).manual_seed(
                int(torch.randint(0, 2 ** 62, ()).item()))
        procs = dict(rp=float(repetition_penalty), min_new=int(min_new_tokens),
                     eos=eos_token_id, ngram=int(no_repeat_ngram_size))
        attrs = dict(strategy=decode_strategy, batch=b,
                     prompt_len=prompt_len, n_new=n_new)
        # ≙ :208-226: the JAX package builds a program per signature
        # under ``generate.build`` and runs it under ``generate.dispatch``;
        # the eager loop builds no program, so its ``generate.build`` is
        # the call's set-up (the zeroed caches), on every call
        with telemetry_span("generate.build", **attrs):
            caches = self._zero_caches(ids, cache_len)
        with telemetry_span("generate.dispatch", **attrs):
            logits0 = self._prefill(ids, caches)
            if decode_strategy == "beam_search":
                return self._beam_generate(ids, logits0, caches, n_new,
                                           int(num_beams),
                                           float(length_penalty), **procs)
            return self._generate(ids, logits0, caches, n_new,
                                  decode_strategy, generator,
                                  float(temperature), int(top_k),
                                  float(top_p), **procs)

    def _zero_caches_prefill(self, ids, cache_len):
        """≙ `_zero_caches_prefill`: zeroed static caches (B, cache_len,
        HK, D) in the parameters' dtype per layer, and ONE causal pass
        over the prompt into them (no mask: the flash attention kernel
        on the card). Returns (the last prompt row's logits (B, V), the
        caches). Only that row goes through the vocab matmul."""
        caches = self._zero_caches(ids, cache_len)
        return self._prefill(ids, caches), caches

    def _zero_caches(self, ids, cache_len):
        cfg = self.config
        dt = next(self.parameters()).dtype
        shape = (ids.shape[0], cache_len, cfg.num_key_value_heads,
                 cfg.head_dim)
        return [(torch.zeros(shape, dtype=dt, device=ids.device),
                 torch.zeros(shape, dtype=dt, device=ids.device))
                for _ in range(cfg.num_hidden_layers)]

    def _prefill(self, ids, caches):
        hidden = self.model(ids, caches, position_offset=0)
        return self.logits(hidden[:, -1])

    def _step_logits(self, tok, caches, pos: int):
        """One cached forward of (R,) tokens at position ``pos``: the
        (R, V) logits."""
        return self(tok[:, None], caches, position_offset=pos)[:, 0]

    def _generate(self, ids, logits0, caches, n_new, strategy, generator,
                  temperature, top_k, top_p, rp, min_new, eos, ngram):
        """≙ `_build_generate`'s program: the first token from the
        prefill's logits, then exactly ``n_new - 1`` decode steps."""
        b, prompt_len = ids.shape
        dev = ids.device
        v_size = logits0.shape[-1]
        rows = torch.arange(b, device=dev)
        track = rp != 1.0
        seen = torch.zeros(b, v_size, dtype=torch.bool, device=dev) \
            .scatter_(1, ids.long(), True) if track else None
        buf = None
        if ngram:
            buf = torch.zeros(b, prompt_len + n_new, dtype=torch.int32,
                              device=dev)
            buf[:, :prompt_len] = ids

        def pick(lg, t):
            lg = penalize(lg, seen, t, rp, min_new, eos)
            if ngram:
                lg = ban_repeat_ngrams(lg, buf, prompt_len + t, ngram)
            return choose_token(lg, strategy, generator, temperature, top_k,
                                top_p)

        toks = torch.empty(b, n_new, dtype=torch.int32, device=dev)
        lps = torch.empty(b, n_new, dtype=torch.float32, device=dev)
        tok, lp = pick(logits0, 0)
        fin = tok == eos if eos is not None \
            else torch.zeros(b, dtype=torch.bool, device=dev)
        for t in range(n_new):
            if t:
                tok, lp = pick(self._step_logits(toks[:, t - 1], caches,
                                                 prompt_len + t - 1), t)
                if eos is not None:
                    tok = torch.where(fin, eos, tok).to(torch.int32)
                    lp = torch.where(fin, 0.0, lp)
                    fin = fin | (tok == eos)
            toks[:, t] = tok
            lps[:, t] = lp
            if track:
                seen = _mark(seen, tok)
            if ngram:
                buf[rows, prompt_len + t] = tok
        return toks, lps

    def _beam_generate(self, ids, logits0, caches, n_new, K,
                       length_penalty, rp, min_new, eos, ngram):
        """≙ `_build_beam_generate`'s program: a (B·K)-row decode; each
        step one cached forward, a joint top-K over the K·V candidates
        (stable: among equal scores the lower flat index, as
        `jax.lax.top_k`), then a gather along the batch axis that
        reorders the caches, finished flags, emitted sequences and the
        processors' state to the surviving beams. A finished beam
        extends only with EOS at zero added log-probability. The best
        beam of each row by ``cum / len**length_penalty``.
        Deterministic."""
        b, prompt_len = ids.shape
        dev = ids.device
        v = logits0.shape[-1]
        length = prompt_len + n_new
        track = rp != 1.0
        seen0 = torch.zeros(b, v, dtype=torch.bool, device=dev) \
            .scatter_(1, ids.long(), True) if track else None
        lg0 = penalize(logits0.float(), seen0, 0, rp, min_new, eos)
        if ngram:
            buf0 = torch.cat([ids, torch.zeros(b, n_new, dtype=torch.int32,
                                               device=dev)], 1)
            lg0 = ban_repeat_ngrams(lg0, buf0, prompt_len, ngram)
        logp0 = torch.log_softmax(lg0, dim=-1)
        # K may exceed V: only V real beams exist after the first
        # expansion; the rest start dead at -1e30
        k0 = min(K, v)
        cum, tok0 = _top(logp0, k0)
        if k0 < K:
            cum = torch.cat([cum, cum.new_full((b, K - k0), NEG_INF)], 1)
            tok0 = torch.cat([tok0, tok0.new_zeros(b, K - k0)], 1)
        # beam j of row i lives at row i*K + j
        caches = [(kc.repeat_interleave(K, 0), vc.repeat_interleave(K, 0))
                  for kc, vc in caches]
        fin = tok0 == eos if eos is not None \
            else torch.zeros(b, K, dtype=torch.bool, device=dev)
        seqs = torch.zeros(b, K, n_new, dtype=torch.int32, device=dev)
        seqs[:, :, 0] = tok0
        seen = _mark(seen0.repeat_interleave(K, 0), tok0.reshape(-1)) \
            .reshape(b, K, v) if track else None
        buf = None
        if ngram:
            buf = buf0.repeat_interleave(K, 0).reshape(b, K, length)
            buf[:, :, prompt_len] = tok0
        if eos is not None:
            eos_row = torch.full((v,), NEG_INF, device=dev)
            eos_row[eos] = 0.0
        tok = tok0
        for t in range(1, n_new):
            lgf = penalize(
                self._step_logits(tok.reshape(b * K), caches,
                                  prompt_len - 1 + t).float(),
                seen.reshape(b * K, v) if track else None, t, rp, min_new,
                eos)
            if ngram:
                lgf = ban_repeat_ngrams(lgf, buf.reshape(b * K, length),
                                        prompt_len + t, ngram)
            lgp = torch.log_softmax(lgf, dim=-1).reshape(b, K, v)
            if eos is not None:
                lgp = torch.where(fin[:, :, None], eos_row, lgp)
            cum, flat = _top((cum[:, :, None] + lgp).reshape(b, K * v), K)
            src = flat // v                                    # (B, K)
            tok = (flat % v).to(torch.int32)
            gidx = (torch.arange(b, device=dev)[:, None] * K + src) \
                .reshape(-1)
            caches = [(kc.index_select(0, gidx), vc.index_select(0, gidx))
                      for kc, vc in caches]
            fin = fin.gather(1, src)
            if eos is not None:
                fin = fin | (tok == eos)
            seqs = seqs.gather(1, src[:, :, None].expand(b, K, n_new))
            seqs[:, :, t] = tok
            if track:
                seen = _mark(seen.gather(1, src[:, :, None].expand(b, K, v))
                             .reshape(b * K, v), tok.reshape(-1)) \
                    .reshape(b, K, v)
            if ngram:
                buf = buf.gather(1, src[:, :, None].expand(b, K, length))
                buf[:, :, prompt_len + t] = tok
        if eos is not None:
            iseos = (seqs == eos).int()
            lengths = torch.where(iseos.any(-1), iseos.argmax(-1) + 1, n_new)
        else:
            lengths = torch.full((b, K), n_new, device=dev)
        norm = cum / lengths.float() ** length_penalty
        best = norm.argmax(dim=1)
        out = seqs.gather(1, best[:, None, None].expand(b, 1, n_new))[:, 0]
        return out, norm.gather(1, best[:, None])[:, 0]


def _top(x, k: int):
    """The k largest of each row of ``x`` and their indices, among equal
    values the lower index first (`jax.lax.top_k`'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]
