"""The RMSNorm and LayerNorm backwards' two designs in the PyTorch port
(`paddle_tpu_torch.ops.norm_kernels`), on the CPU.

- `norm_bwd_design` picks the register-row backward (`csrc/norm_rows.cuh`)
  where `bwd_row_class` finds a class of warps a row and vectors a lane
  that holds the row (whole 16-byte vectors, at most 8 warps x 4 vectors
  a lane), and the rowblock kernels for every other row; a mirror of the
  lanes' vector map shows each class covers the row once, the lanes
  within one vector of each other.
- The persistent grid (`bwd_grid`, `group_rows`): every row walked by
  exactly one row group, the groups' runs contiguous and in order, within
  one row of each other, one wave of blocks at most.
- The private ``_design=`` of `_rms_bwd` / `_ln_bwd` refuses an input
  the named design cannot take, and a row neither takes, with a
  ValueError before any launch (and before the device check, so the
  refusal shows here).
- `norm_bwd_plan`, the register-row backward's plan in plain PyTorch
  (rows a group, partial rows a block, the column sums' order), against
  autograd of `rms_norm_ref` / `layer_norm_ref` and against the JAX
  package's `_rms` / `_ln` custom VJPs, whose backwards are the Pallas
  `_rms_bwd_kernel` / `_ln_bwd_kernel` in interpret mode (row counts that
  divide the block) or XLA autodiff (ragged rows), on numpy-seeded f32
  inputs under grids of several blocks and row groups. Tolerances: dx
  atol 1e-5 plus rtol 1e-5, dw and db atol/rtol 1e-4 (f32 sums over up
  to 512 rows in other orders).
"""
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import norm_kernels as jnk
from paddle_tpu_torch.ops import launch_counts
from paddle_tpu_torch.ops import norm_kernels as tnk

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
# one vector past the largest class's row: 8 warps x 32 lanes x 4 vectors
PAST = {torch.float32: 4100, torch.bfloat16: 8200, torch.float16: 8200}
DX_TOL = dict(atol=1e-5, rtol=1e-5)
SUM_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("h", [64, 100, 768, 1024, 3584, 4096, 4100, 8192,
                               "past"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_bwd_design_by_dtype_and_width(dtype, h):
    h = PAST[dtype] if h == "past" else h
    v = 4 if dtype == torch.float32 else 8
    fits = h % v == 0 and h // v <= 8 * 32 * 4
    assert tnk.norm_bwd_design(dtype, h) == \
        ("registers" if fits else "rowblock")
    assert (tnk.bwd_row_class(dtype, h) is not None) == fits


# (dtype, h) -> (warps a row, vectors a lane) at the main paths' widths
MAIN_CLASSES = [(torch.bfloat16, 4096, (4, 4)),   # Llama-3-8B
                (torch.bfloat16, 1024, (1, 4)),   # the bench recipe
                (torch.bfloat16, 3584, (4, 4)),   # Qwen2-MoE-A14B
                (torch.float32, 768, (2, 3)),     # BERT-base
                (torch.float32, 4096, (8, 4)),
                (torch.float16, 64, (1, 1))]


@pytest.mark.parametrize("dtype,h,want", MAIN_CLASSES)
def test_bwd_row_class_at_the_main_widths(dtype, h, want):
    assert tnk.bwd_row_class(dtype, h) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_bwd_class_covers_its_row_once_and_evenly(dtype):
    """Lane t of a class (w, nv) holds vectors t, t + 32 w, ... below
    h / V (`load_row` in csrc/norm_rows.cuh): every vector once, no lane
    more than one vector past another, the fewest warps that hold the row
    at 4 vectors a lane, and only the instances the C entries have (nv
    1-4 at one warp, 3-4 past it)."""
    v = 4 if dtype == torch.float32 else 8
    for nvec in range(1, 8 * 32 * 4 + 1):
        wpr, nv = tnk.bwd_row_class(dtype, nvec * v)
        tpr = 32 * wpr
        held = [[j * tpr + t for j in range(nv) if j * tpr + t < nvec]
                for t in range(tpr)]
        flat = sorted(i for lane in held for i in lane)
        assert flat == list(range(nvec)), (nvec, wpr, nv)
        counts = [len(lane) for lane in held]
        assert max(counts) - min(counts) <= 1
        assert wpr == 1 or nvec > 32 * (wpr // 2) * 4  # fewer too few
        assert wpr in tnk.BWD_ROW_WARPS
        assert 1 <= nv <= 4 and (wpr == 1 or nv >= 3)


@pytest.mark.parametrize("n", [1, 7, 300, 1001, 4096, 16384])
@pytest.mark.parametrize("wpr", [1, 2, 4, 8])
@pytest.mark.parametrize("sms,per_sm", [(132, 2), (132, 8), (4, 3)])
def test_grid_walks_every_row_once(n, wpr, sms, per_sm):
    blocks, groups = tnk.bwd_grid(n, wpr, sms, per_sm)
    assert 1 <= blocks <= per_sm * sms
    assert groups * 32 * wpr <= tnk.BWD_BLOCK
    # a full block of row groups unless the rows would not fill the SMs
    assert groups == (1 if -(-n // (tnk.BWD_BLOCK // (32 * wpr))) < sms
                      else tnk.BWD_BLOCK // (32 * wpr))
    runs = tnk.group_rows(n, blocks * groups)
    assert len(runs) == blocks * groups
    assert runs[0][0] == 0 and runs[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
    sizes = [hi - lo for lo, hi in runs]
    assert max(sizes) - min(sizes) <= 1 and sum(sizes) == n


@pytest.mark.parametrize("dtype,h", [(torch.bfloat16, 100),
                                     (torch.float16, 4100),
                                     (torch.bfloat16, PAST[torch.bfloat16]),
                                     (torch.float32, PAST[torch.float32])])
def test_registers_bwd_refuses_before_launch(dtype, h):
    x = torch.zeros(2, h, dtype=dtype)
    w = torch.ones(h, dtype=dtype)
    st = torch.ones(2)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="registers norm backward"):
        tnk._rms_bwd(x, w, st, x, _design="registers")
    with pytest.raises(ValueError, match="registers norm backward"):
        tnk._ln_bwd(x, w, st, st, x, _design="registers")
    assert launch_counts == before


def test_registers_bwd_refuses_a_row_off_16_bytes():
    buf = torch.zeros(2 * 768 + 1)
    x = buf[1:].view(2, 768)
    w = torch.ones(768)
    st = torch.ones(2)
    with pytest.raises(ValueError, match="off 16 bytes"):
        tnk._rms_bwd(x, w, st, x, _design="registers")
    with pytest.raises(ValueError, match="off 16 bytes"):
        tnk._ln_bwd(x, w, st, st, x, _design="registers")
    # the default route takes the rowblock design for it, as far as the
    # device check
    with pytest.raises(ValueError, match="CUDA device"):
        tnk._rms_bwd(x, w, st, x)


def test_other_bwd_refusals_before_launch():
    x = torch.zeros(2, 768)
    w = torch.ones(768)
    st = torch.ones(2)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="no norm backward design"):
        tnk._rms_bwd(x, w, st, x, _design="strided")
    with pytest.raises(ValueError, match="no norm backward design"):
        tnk._ln_bwd(x, w, st, st, x, _design="welford")
    # a design the input can take gets as far as the device check
    for design in (None, "registers", "rowblock"):
        with pytest.raises(ValueError, match="CUDA device"):
            tnk._rms_bwd(x, w, st, x, _design=design)
        with pytest.raises(ValueError, match="CUDA device"):
            tnk._ln_bwd(x, w, st, st, x, _design=design)
    # a row neither design takes: past the rowblock kernels' shared memory
    # and off 16 bytes (h odd)
    for fn, max_h, args in ((tnk._rms_bwd, 49152, (st,)),
                            (tnk._ln_bwd, 24576, (st, st))):
        h = max_h + 1
        xw = torch.zeros(2, h, dtype=torch.bfloat16)
        ww = torch.ones(h, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=f"h <= {max_h}"):
            fn(xw, ww, *args, xw)
        with pytest.raises(ValueError, match=f"h <= {max_h}"):
            fn(xw, ww, *args, xw, _design="rowblock")
    assert launch_counts == before


def _inputs(n, h, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, h)) * 3 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    b = (0.1 * rng.standard_normal(h)).astype(np.float32)
    g = (rng.standard_normal((n, h)) + 0.3).astype(np.float32)
    return x, w, b, g


# (rows, h, block_rows of the JAX kernel, SMs, blocks an SM of the
# modelled grid): one Pallas block, four blocks of 128, ragged rows (the
# XLA branch); grids of 1-row groups, several row groups a block, and a
# row group a block
PLAN_CASES = [(256, 128, 256, 4, 2), (512, 64, 128, 3, 8),
              (300, 96, 256, 132, 8), (6, 32, 256, 4, 1),
              (512, 1024, 128, 2, 3)]


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=[f"{c[0]}x{c[1]}_sm{c[3]}x{c[4]}"
                              for c in PLAN_CASES])
def test_rms_bwd_plan_matches_autograd_and_jax(case):
    n, h, br, sms, per_sm = case
    x, w, _, g = _inputs(n, h, n + h)
    xt, wt, gt = map(torch.from_numpy, (x, w, g))
    rstd = torch.rsqrt(xt.square().mean(-1) + 1e-5)
    dx, dw, db = tnk.norm_bwd_plan(xt, wt, gt, rstd, sms=sms,
                                   blocks_per_sm=per_sm)
    assert db is None and dx.dtype == dw.dtype == torch.float32
    leaves = [t.clone().requires_grad_() for t in (xt, wt)]
    rdx, rdw = torch.autograd.grad(tnk.rms_norm_ref(*leaves, 1e-5), leaves,
                                   gt)
    np.testing.assert_allclose(dx.numpy(), rdx.numpy(), **DX_TOL)
    np.testing.assert_allclose(dw.numpy(), rdw.numpy(), **SUM_TOL)

    def loss(xx, ww):
        o = jnk.rms_norm_values(xx, ww, 1e-5, block_rows=br)
        return jnp.sum(o.astype(jnp.float32) * g)
    jdx, jdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                              jnp.asarray(w))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **DX_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **SUM_TOL)


@pytest.mark.parametrize("case", PLAN_CASES,
                         ids=[f"{c[0]}x{c[1]}_sm{c[3]}x{c[4]}"
                              for c in PLAN_CASES])
def test_ln_bwd_plan_matches_autograd_and_jax(case):
    n, h, br, sms, per_sm = case
    x, w, b, g = _inputs(n, h, 2 * n + h)
    xt, wt, bt, gt = map(torch.from_numpy, (x, w, b, g))
    mu = xt.mean(-1)
    rstd = torch.rsqrt((xt - mu[:, None]).square().mean(-1) + 1e-5)
    dx, dw, db = tnk.norm_bwd_plan(xt, wt, gt, rstd, mu, sms=sms,
                                   blocks_per_sm=per_sm)
    leaves = [t.clone().requires_grad_() for t in (xt, wt, bt)]
    rgrads = torch.autograd.grad(tnk.layer_norm_ref(*leaves, 1e-5), leaves,
                                 gt)

    def loss(xx, ww, bb):
        o = jnk.layer_norm_values(xx, ww, bb, 1e-5, block_rows=br)
        return jnp.sum(o.astype(jnp.float32) * g)
    jgrads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    for got, want, jwant, tol in zip((dx, dw, db), rgrads, jgrads,
                                     (DX_TOL, SUM_TOL, SUM_TOL)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), **tol)


def test_bwd_plan_sums_in_the_kernels_order():
    """The plan's dw is the ordered sum the kernels take, not another: at
    a shape where f32 rounding depends on the order (a large column sum
    beside tiny terms), a sum of every row in one pass differs from it in
    the last bits, while the plan repeats itself bitwise."""
    n, h = 1024, 64
    x, w, _, g = _inputs(n, h, 5)
    g[0] *= 1e6
    xt, wt, gt = map(torch.from_numpy, (x, w, g))
    rstd = torch.rsqrt(xt.square().mean(-1) + 1e-5)
    a = tnk.norm_bwd_plan(xt, wt, gt, rstd, sms=4, blocks_per_sm=3)[1]
    c = tnk.norm_bwd_plan(xt, wt, gt, rstd, sms=4, blocks_per_sm=3)[1]
    assert torch.equal(a, c)
    one_pass = (gt * xt * rstd[:, None]).sum(0)
    torch.testing.assert_close(a, one_pass, rtol=1e-4, atol=1e-2)
    assert not torch.equal(a, one_pass)


_CSRC = Path(tnk.__file__).resolve().parents[1] / "csrc"
_CTYPE = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
          ctypes.c_float: "float"}


@pytest.mark.parametrize("src,symbol,argtypes", [
    ("rms_norm", "pdt_rms_norm_fwd", tnk._ARGTYPES),
    ("rms_norm", "pdt_rms_norm_bwd", tnk._BWD_ARGTYPES),
    ("layer_norm", "pdt_layer_norm_fwd", tnk._LN_ARGTYPES),
    ("layer_norm", "pdt_layer_norm_bwd", tnk._LN_BWD_ARGTYPES)])
def test_c_entries_take_the_declared_argument_types(src, symbol, argtypes):
    """Each norm entry's ctypes declaration matches its C signature
    parameter by parameter (a pointer where the source has one, an int
    where it has an int): a missing int would pass the stream as the
    device index and no stream at all."""
    text = (_CSRC / f"{src}.cu").read_text()
    m = re.search(rf'extern "C" int {symbol}\((.*?)\)', text, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = ["ptr" if "*" in p else p.split()[0] for p in params]
    assert kinds == [_CTYPE[t] for t in argtypes]
