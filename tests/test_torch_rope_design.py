"""The rope kernel's two designs (`paddle_tpu_torch.ops.rope`) on the CPU:
the routing rule `rope_design`, a plain model of `rope_vec`'s thread map
(`vec_plan` and `vec_thread_map` here, which must rotate every pair of q
and k once with the trig of its own position and pair), `_FusedRopeFn`
(q and k in one op) against two `rope_values` and against the JAX
package's `fused_rotary_position_embedding`, values and gradients, the
fallback to two single-tensor `_FusedRopeFn` calls (`rope_values`) for q
and k that do not match, and the C entries' ctypes declarations and the
grid's constants against `csrc/rope.cu`. The kernels themselves run on the
card (tests/test_torch_cuda_kernels.py).

Tolerances as tests/test_torch_rope.py: f32 rtol/atol 1e-6 against JAX
(XLA's CPU code may contract a product and a sum into an FMA), bf16 one
bf16 rounding; the port's own paths against each other bitwise (the same
plain ops on the same inputs)."""
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import rope as jrope
from paddle_tpu_torch.ops import launch_counts
from paddle_tpu_torch.ops import rope as trope

F32_TOL = dict(rtol=1e-6, atol=1e-6)


def _tables(max_len, d, theta=10000.0):
    inv = 1.0 / theta ** (np.arange(0, d, 2, dtype=np.float64) / d)
    ang = np.arange(max_len)[:, None] * inv[None, :]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7,
                                   atol=2 ** -7 * np.abs(want).max())


# -- rope_design ---------------------------------------------------------------

_BF, _F16, _F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("dtype,d,offset,want", [
    # heads of whole 16-byte vectors on 16 bytes: the vector design
    (_BF, 64, 0, "vec"), (_BF, 72, 0, "vec"), (_BF, 128, 0, "vec"),
    (_BF, 256, 0, "vec"), (_F16, 72, 0, "vec"), (_F16, 128, 0, "vec"),
    (_F32, 64, 0, "vec"), (_F32, 72, 0, "vec"), (_F32, 128, 0, "vec"),
    (_F32, 256, 0, "vec"), (_F32, 4, 0, "vec"),
    # a head's bytes off 16: D 2 in every dtype, D 4 / 6 in 16 bits
    (_BF, 2, 0, "pair"), (_F16, 2, 0, "pair"), (_F32, 2, 0, "pair"),
    (_BF, 4, 0, "pair"), (_F16, 6, 0, "pair"), (_F32, 6, 0, "pair"),
    # a pointer off 16 bytes but on its element pairs: the pair design
    (_BF, 128, 4, "pair"), (_BF, 128, 8, "pair"), (_F16, 72, 12, "pair"),
    (_F32, 128, 8, "pair"), (_F32, 64, 24, "pair"), (_BF, 2, 4, "pair"),
    # off its element pairs: no kernel
    (_BF, 128, 2, None), (_F16, 64, 6, None), (_F32, 128, 4, None),
    (_F32, 2, 12, None), (_BF, 2, 2, None),
    # odd D, another dtype
    (_BF, 127, 0, None), (_F32, 3, 0, None), (torch.float64, 128, 0, None),
    (torch.int32, 128, 0, None)])
def test_rope_design_by_dtype_width_and_pointer(dtype, d, offset, want):
    base = 1 << 20
    ptrs = [base, base + 4096, base + 8192]
    # any one pointer off by ``offset`` decides
    for i in range(len(ptrs)):
        moved = list(ptrs)
        moved[i] += offset
        assert trope.rope_design(dtype, d, *moved) == want


def test_vec_chunks_and_the_widest_head():
    assert trope.vec_chunks(_BF, 128) == 16
    assert trope.vec_chunks(_F16, 72) == 9
    assert trope.vec_chunks(_F32, 72) == 18
    assert trope.vec_chunks(_BF, 6) is None
    # at most a block's threads of vectors a head
    assert trope.vec_chunks(_BF, 8 * trope.VEC_MAX_BLOCK) == \
        trope.VEC_MAX_BLOCK
    assert trope.vec_chunks(_BF, 8 * trope.VEC_MAX_BLOCK + 8) is None
    assert trope.rope_design(_BF, 8 * trope.VEC_MAX_BLOCK + 8, 0) == "pair"


# -- rope_vec's thread map -------------------------------------------------------

# rope_vec's grid (kSlots, kMinBlock in csrc/rope.cu; kMaxBlock is
# trope.VEC_MAX_BLOCK): vectors a thread loads before any arithmetic,
# threads a block at least (positions share a block below it)
VEC_SLOTS = 4
VEC_MIN_BLOCK = 128


def vec_plan(dtype, npos: int, h: int, hk: int, d: int) -> dict:
    """`rope_vec`'s grid over ``npos`` = B S positions of q (``h`` heads)
    and k (``hk``, 0 for a single tensor), as `launch_vec` in
    `csrc/rope.cu` sets it: ``chunks`` (C, vectors a head), ``lanes`` (G,
    head lanes a position: a thread walks heads g, g + G, ... of the
    H + HK), ``per_position`` (G C threads), ``positions`` (a block's),
    ``threads`` (a block's) and ``blocks``."""
    c = trope.vec_chunks(dtype, d)
    if c is None:
        raise ValueError(f"rope_vec takes heads of whole 16-byte vectors; "
                         f"got D={d} {dtype}")
    g = -(-(h + hk) // VEC_SLOTS)
    if g * c > trope.VEC_MAX_BLOCK:
        g = trope.VEC_MAX_BLOCK // c
    tpp = g * c
    ppb = VEC_MIN_BLOCK // tpp if tpp < VEC_MIN_BLOCK else 1
    return dict(chunks=c, lanes=g, per_position=tpp, positions=ppb,
                threads=ppb * tpp, blocks=-(-npos // ppb))


def vec_thread_map(dtype, b: int, s: int, h: int, hk: int, d: int,
                   blocks=None) -> dict:
    """What `rope_vec`'s threads rotate, in plain PyTorch: for the blocks
    ``blocks`` (a range or index tensor; default all) of `vec_plan`'s
    grid, one entry per (thread, head walked, pair of its chunk), as the
    kernel maps them: position p = block * positions + t // per_position,
    head lane g and chunk j from t % per_position, heads g, g + G, ...
    below H + HK (q's, then k's), pairs j P .. j P + P - 1 (P pairs a
    vector), trig row p % S. Returns int64 tensors ``tensor`` (0 q, 1 k),
    ``position`` (b S + s), ``head``, ``pair``, ``trig_row``,
    ``trig_col``."""
    pl = vec_plan(dtype, b * s, h, hk, d)
    c, g, tpp, ppb = pl["chunks"], pl["lanes"], pl["per_position"], \
        pl["positions"]
    pairs = 8 // dtype.itemsize
    blk = torch.arange(pl["blocks"]) if blocks is None \
        else torch.as_tensor(blocks)
    t = torch.arange(pl["threads"])
    lp, r = t // tpp, t % tpp
    lane, chunk = r // c, r % c
    pos = blk[:, None] * ppb + lp[None, :]               # (blocks, T)
    trig_row = pos % s                                   # once a thread
    walked = torch.arange(-(-(h + hk) // g))
    head = lane[:, None] + walked[None, :] * g           # (T, walked)
    live = (pos < b * s)[:, :, None] & (head < h + hk)[None]
    pair = chunk[:, None] * pairs + torch.arange(pairs)  # (T, P)
    shape = (len(blk), len(t), len(walked), pairs)
    sel = live[..., None].expand(shape)

    def take(x):
        return x.expand(shape)[sel]
    head_all = take(head[None, :, :, None])
    is_k = (head_all >= h).long()
    col = take(pair[None, :, None, :])
    return dict(tensor=is_k, position=take(pos[:, :, None, None]),
                head=head_all - h * is_k, pair=col,
                trig_row=take(trig_row[:, :, None, None]), trig_col=col)


# (label, dtype, B, S, H, HK, D): the packed pretraining run's q + k, q and
# k alone, D 72 in f16 (9 vectors a head), S 999, HK 0, H 1, and more heads
# than one block's threads walk at once (the kernel's outer head loop)
MAP_CASES = [
    ("packed_qk", _BF, 2, 8192, 32, 8, 128),
    ("packed_q", _BF, 2, 8192, 32, 0, 128),
    ("packed_k", _BF, 2, 8192, 8, 0, 128),
    ("d72_f16", _F16, 2, 999, 3, 1, 72),
    ("s999_f32", _F32, 1, 999, 4, 2, 64),
    ("h1", _BF, 3, 7, 1, 0, 64),
    ("h1_hk1", _F32, 2, 5, 1, 1, 8),
    ("many_heads", _F16, 1, 5, 300, 20, 256),
]


@pytest.mark.parametrize("label,dtype,b,s,h,hk,d", MAP_CASES,
                         ids=[c[0] for c in MAP_CASES])
def test_vec_thread_map_covers_every_pair_once(label, dtype, b, s, h, hk,
                                               d):
    plan = vec_plan(dtype, b * s, h, hk, d)
    assert plan["threads"] <= trope.VEC_MAX_BLOCK
    assert plan["threads"] >= min(VEC_MIN_BLOCK, plan["per_position"])
    half = d // 2
    heads = (h, hk)
    counts = [torch.zeros(b * s * n * half, dtype=torch.int16)
              for n in heads]
    step = 2048
    for lo in range(0, plan["blocks"], step):
        m = vec_thread_map(dtype, b, s, h, hk, d,
                                 range(lo, min(lo + step, plan["blocks"])))
        # each pair turns by the trig of its own position and pair
        assert torch.equal(m["trig_row"], m["position"] % s)
        assert torch.equal(m["trig_col"], m["pair"])
        assert int(m["pair"].min()) >= 0 and int(m["pair"].max()) < half
        for t, n in enumerate(heads):
            on = m["tensor"] == t
            if not n:
                assert not bool(on.any())
                continue
            head, pos = m["head"][on], m["position"][on]
            assert int(head.min()) >= 0 and int(head.max()) < n
            flat = (pos * n + head) * half + m["pair"][on]
            counts[t].index_put_((flat,), torch.ones_like(
                flat, dtype=torch.int16), accumulate=True)
    for t, n in enumerate(heads):
        if n:
            assert bool((counts[t] == 1).all()), \
                f"{label}: {'qk'[t]} pairs not covered exactly once"


def test_vec_plan_grid():
    # the packed q + k: 40 heads of 16 vectors, 10 head lanes of 4 heads
    assert vec_plan(_BF, 16384, 32, 8, 128) == dict(
        chunks=16, lanes=10, per_position=160, positions=1, threads=160,
        blocks=16384)
    # k alone: 2 lanes of 4 heads, 4 positions a block
    assert vec_plan(_BF, 16384, 8, 0, 128) == dict(
        chunks=16, lanes=2, per_position=32, positions=4, threads=128,
        blocks=4096)
    # past a block's threads the lanes are capped and a thread walks more
    # heads than the slots
    p = vec_plan(_F16, 5, 300, 20, 256)
    assert p["lanes"] * p["chunks"] == trope.VEC_MAX_BLOCK
    with pytest.raises(ValueError, match="whole 16-byte vectors"):
        vec_plan(_BF, 10, 4, 0, 6)


# -- _FusedRopeFn against two rope_values and the JAX package ------------------

def _jax_fused(q, k, cos, sin, offset, dtype, gq, gk):
    qj, kj = (jnp.asarray(a).astype(dtype) for a in (q, k))

    def f(a, b):
        return (jrope.rope_values(a, jnp.asarray(cos), jnp.asarray(sin),
                                  offset),
                jrope.rope_values(b, jnp.asarray(cos), jnp.asarray(sin),
                                  offset))
    (yq, yk), vjp = jax.vjp(f, qj, kj)
    dq, dk = vjp((jnp.asarray(gq).astype(dtype),
                  jnp.asarray(gk).astype(dtype)))
    return [np.asarray(a.astype(jnp.float32)) for a in (yq, yk, dq, dk)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 37])
@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
def test_fused_rope_fn_matches_two_rope_values_and_jax(monkeypatch, pallas,
                                                       offset, dtype):
    monkeypatch.setattr(jrope, "_FORCE_PALLAS", pallas)
    b, s, h, hk, d = 2, 256, 4, 2, 32
    cos, sin = _tables(512, d)
    q, k = _x((b, s, h, d), 11), _x((b, s, hk, d), 12)
    gq, gk = _x((b, s, h, d), 13), _x((b, s, hk, d), 14)
    want = _jax_fused(q, k, cos, sin, offset, dtype, gq, gk)
    dt = getattr(torch, dtype)
    ct, st = torch.from_numpy(cos), torch.from_numpy(sin)
    applied = []
    real = trope._FusedRopeFn.apply
    monkeypatch.setattr(trope._FusedRopeFn, "apply",
                        lambda *a: applied.append(1) or real(*a))
    qt, kt = (torch.from_numpy(a).to(dt).requires_grad_() for a in (q, k))
    before = dict(launch_counts)
    yq, yk = trope.fused_rotary_position_embedding(qt, kt, ct, st, offset)
    assert applied == [1]
    torch.autograd.backward([yq, yk], [torch.from_numpy(gq).to(dt),
                                       torch.from_numpy(gk).to(dt)])
    assert launch_counts == before       # the CPU runs the plain version
    got = [a.detach().float().numpy() for a in (yq, yk, qt.grad, kt.grad)]
    for g, w in zip(got, want):
        _close(g, w, dtype)
    # the same values as two rope_values, bitwise
    q2, k2 = (torch.from_numpy(a).to(dt).requires_grad_() for a in (q, k))
    rq = trope.rope_values(q2, ct, st, offset)
    rk = trope.rope_values(k2, ct, st, offset)
    torch.autograd.backward([rq, rk], [torch.from_numpy(gq).to(dt),
                                       torch.from_numpy(gk).to(dt)])
    for a, r in ((yq, rq), (yk, rk), (qt.grad, q2.grad),
                 (kt.grad, k2.grad)):
        assert torch.equal(a.detach(), r.detach())


@pytest.mark.parametrize("reaches", ["q", "k"])
def test_fused_rope_fn_one_output_reaching_the_loss(reaches):
    """Only q' (or only k') reaches the loss: the other input gets no
    gradient (None, not zeros), and the one that does equals the inverse
    rotation of its cotangent."""
    cos, sin = _tables(64, 16)
    ct, st = torch.from_numpy(cos), torch.from_numpy(sin)
    q = torch.from_numpy(_x((1, 40, 3, 16), 21)).requires_grad_()
    k = torch.from_numpy(_x((1, 40, 1, 16), 22)).requires_grad_()
    g = torch.from_numpy(_x((1, 40, 3 if reaches == "q" else 1, 16), 23))
    yq, yk = trope.fused_rotary_position_embedding(q, k, ct, st, 5)
    (yq if reaches == "q" else yk).backward(g)
    used, unused = (q, k) if reaches == "q" else (k, q)
    assert unused.grad is None
    c, s = ct[5:45], st[5:45]
    assert torch.equal(used.grad, trope.rope_ref(g, c, s, -1.0))


def test_fused_rope_fn_against_jax_when_only_q_reaches_the_loss():
    b, s, h, hk, d = 1, 64, 2, 1, 16
    cos, sin = _tables(128, d)
    q, k, g = _x((b, s, h, d), 31), _x((b, s, hk, d), 32), \
        _x((b, s, h, d), 33)
    want = _jax_fused(q, k, cos, sin, 3, "float32", g, np.zeros_like(k))
    qt, kt = (torch.from_numpy(a).requires_grad_() for a in (q, k))
    yq, _ = trope.fused_rotary_position_embedding(
        qt, kt, torch.from_numpy(cos), torch.from_numpy(sin), 3)
    yq.backward(torch.from_numpy(g))
    np.testing.assert_allclose(qt.grad.numpy(), want[2], **F32_TOL)
    assert kt.grad is None and not want[3].any()


# (label, q shape, k shape, q dtype, k dtype): q and k that one launch
# cannot take together
MIXED = [("dtype", (2, 32, 4, 16), (2, 32, 2, 16), "float32", "bfloat16"),
         ("seq", (2, 32, 4, 16), (2, 24, 2, 16), "float32", "float32"),
         ("batch", (2, 32, 4, 16), (3, 32, 2, 16), "bfloat16", "bfloat16")]


@pytest.mark.parametrize("label,qs,ks,qd,kd", MIXED,
                         ids=[m[0] for m in MIXED])
def test_mixed_inputs_fall_back_to_two_rope_fns(monkeypatch, label, qs, ks,
                                                qd, kd):
    cos, sin = _tables(64, 16)
    ct, st = torch.from_numpy(cos), torch.from_numpy(sin)
    calls = {"fused": 0, "single": 0}
    real = trope._FusedRopeFn.apply

    def counted(*a):
        calls["single" if a[1] is None else "fused"] += 1
        return real(*a)
    monkeypatch.setattr(trope._FusedRopeFn, "apply", counted)
    q = torch.from_numpy(_x(qs, 41)).to(getattr(torch, qd))
    k = torch.from_numpy(_x(ks, 42)).to(getattr(torch, kd))
    yq, yk = trope.fused_rotary_position_embedding(q, k, ct, st, 2)
    assert calls == {"fused": 0, "single": 2}
    assert torch.equal(yq, trope.rope_values(q, ct, st, 2))
    assert torch.equal(yk, trope.rope_values(k, ct, st, 2))


def test_fused_positions_past_the_table_raise():
    cos, sin = _tables(16, 8)
    q, k = torch.zeros(1, 10, 2, 8), torch.zeros(1, 10, 1, 8)
    with pytest.raises(ValueError, match="exceeds precomputed table"):
        trope.fused_rotary_position_embedding(
            q, k, torch.from_numpy(cos), torch.from_numpy(sin), 7)


def test_kernel_route_demands_a_card():
    cos, sin = _tables(16, 8)
    q, k = torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        trope.fused_rotary_position_embedding(
            q, k, torch.from_numpy(cos), torch.from_numpy(sin),
            use_kernel=True)


# -- the C entries' declarations ------------------------------------------------

_CSRC = Path(trope.__file__).resolve().parents[1] / "csrc"
_CTYPE = {ctypes.c_void_p: "ptr", ctypes.c_int: "int"}


@pytest.mark.parametrize("symbol,argtypes", [
    ("pdt_rope", trope._ARGTYPES), ("pdt_rope_qk", trope._QK_ARGTYPES)])
def test_c_entries_take_the_declared_argument_types(symbol, argtypes):
    """Each rope entry's ctypes declaration matches its C signature
    parameter by parameter (a pointer where the source has one, an int
    where it has an int)."""
    text = (_CSRC / "rope.cu").read_text()
    m = re.search(rf'extern "C" int {symbol}\((.*?)\)', text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = ["ptr" if "*" in p else p.split()[0] for p in params]
    assert kinds == [_CTYPE[t] for t in argtypes]


def test_vec_grid_constants_match_the_source():
    text = (_CSRC / "rope.cu").read_text()
    for name, value in (("kSlots", VEC_SLOTS),
                        ("kMinBlock", VEC_MIN_BLOCK),
                        ("kMaxBlock", trope.VEC_MAX_BLOCK)):
        assert re.search(rf"constexpr int {name} = {value};", text), name
