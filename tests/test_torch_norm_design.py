"""The RMSNorm and LayerNorm forwards' two designs in the PyTorch port
(`paddle_tpu_torch.ops.norm_kernels`), on the CPU.

- `norm_design` picks the register-row kernels (`csrc/norm_rows.cuh`)
  where `row_class` finds a class of warps a row and vectors a lane that
  holds the row (whole 16-byte vectors, at most 4 warps x 8 vectors a
  lane), and the strided kernels for every other row; a Python mirror of
  the lanes' vector map shows each class covers the row once, the lanes
  within one vector of each other. The card tests
  (tests/test_torch_cuda_kernels.py) hold both designs against the plain
  versions.
- The private ``_design="registers"`` of `_rms_fwd` / `_ln_fwd` refuses
  an input the design cannot take with a ValueError before any launch
  (and before the device check, so the refusal shows here).
- The plain versions, which the card holds the new kernels against,
  still match the JAX package's `_rms_fwd_kernel` / `_ln_fwd_kernel` run
  in interpret mode at H 768 and 1024, 16 rows of f32 made from a numpy
  seed: outputs and statistics within atol 1e-5 plus rtol 1e-5 (the same
  f32 math, summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import norm_kernels as jnk
from paddle_tpu_torch.ops import launch_counts
from paddle_tpu_torch.ops import norm_kernels as tnk

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
# one vector past the largest class's row: 4 warps x 32 lanes x 8 vectors
PAST = {torch.float32: 4100, torch.bfloat16: 8200, torch.float16: 8200}
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h", [64, 100, 768, 1024, 1152, 3584, 4096, 4100,
                               "past"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_design_by_dtype_and_width(dtype, h):
    h = PAST[dtype] if h == "past" else h
    v = 4 if dtype == torch.float32 else 8
    fits = h % v == 0 and h // v <= 4 * 32 * 8
    assert tnk.norm_design(dtype, h) == ("registers" if fits else "strided")
    assert (tnk.row_class(dtype, h) is not None) == fits


# (dtype, h) -> (warps a row, vectors a lane) at the main paths' widths
MAIN_CLASSES = [(torch.float32, 768, (1, 6)),      # BERT-base
                (torch.bfloat16, 1024, (1, 4)),    # the bench recipe
                (torch.bfloat16, 3584, (2, 7)),    # Qwen2-MoE-A14B
                (torch.bfloat16, 4096, (2, 8)),    # Llama-3-8B
                (torch.float32, 4096, (4, 8)),
                (torch.float16, 64, (1, 1))]


@pytest.mark.parametrize("dtype,h,want", MAIN_CLASSES)
def test_row_class_at_the_main_widths(dtype, h, want):
    assert tnk.row_class(dtype, h) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_class_covers_its_row_once_and_evenly(dtype):
    """Lane t of a class (w, nv) holds vectors t, t + 32 w, ... below
    h / V (`load_row` in csrc/norm_rows.cuh): every vector once, no lane
    more than one vector past another, the fewest warps that hold the row
    at 8 vectors a lane, and only the instances the C entries have (nv
    1-8 at one warp, 5-8 past it)."""
    v = 4 if dtype == torch.float32 else 8
    for nvec in range(1, 4 * 32 * 8 + 1):
        wpr, nv = tnk.row_class(dtype, nvec * v)
        tpr = 32 * wpr
        held = [[j * tpr + t for j in range(nv) if j * tpr + t < nvec]
                for t in range(tpr)]
        flat = sorted(i for lane in held for i in lane)
        assert flat == list(range(nvec)), (nvec, wpr, nv)
        counts = [len(lane) for lane in held]
        assert max(counts) - min(counts) <= 1
        assert wpr == 1 or nvec > 32 * (wpr // 2) * 8  # fewer too few
        assert 1 <= nv <= 8 and (wpr == 1 or nv >= 5)


@pytest.mark.parametrize("dtype,h", [(torch.bfloat16, 100),
                                     (torch.float16, 4100),
                                     (torch.bfloat16, PAST[torch.bfloat16]),
                                     (torch.float32, PAST[torch.float32])])
def test_registers_design_refuses_before_launch(dtype, h):
    x = torch.zeros(2, h, dtype=dtype)
    w = torch.ones(h, dtype=dtype)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="registers norm design"):
        tnk._rms_fwd(x, w, 1e-5, _design="registers")
    with pytest.raises(ValueError, match="registers norm design"):
        tnk._ln_fwd(x, w, w, 1e-5, _design="registers")
    assert launch_counts == before


def test_registers_design_refuses_a_row_off_16_bytes():
    buf = torch.zeros(2 * 768 + 1)
    x = buf[1:].view(2, 768)
    w = torch.ones(768)
    with pytest.raises(ValueError, match="off 16 bytes"):
        tnk._rms_fwd(x, w, 1e-5, _design="registers")
    with pytest.raises(ValueError, match="off 16 bytes"):
        tnk._ln_fwd(x, w, w, 1e-5, _design="registers")


def test_other_refusals_before_launch():
    x = torch.zeros(2, 768)
    w = torch.ones(768)
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="no norm forward design"):
        tnk._rms_fwd(x, w, 1e-5, _design="welford")
    # a design the input can take gets as far as the device check
    for design in (None, "registers", "strided"):
        with pytest.raises(ValueError, match="CUDA device"):
            tnk._rms_fwd(x, w, 1e-5, _design=design)
        with pytest.raises(ValueError, match="CUDA device"):
            tnk._ln_fwd(x, w, w, 1e-5, _design=design)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tnk._rms_fwd(x.double(), w.double(), 1e-5)
    assert launch_counts == before


def _inputs(h, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((16, h)) * 3 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    b = (0.1 * rng.standard_normal(h)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("h", [768, 1024])
def test_plain_rms_forward_matches_interpret_kernel(h):
    x, w, _ = _inputs(h, h)
    o, rstd = jnk._rms_fwd(jnp.asarray(x), jnp.asarray(w), 1e-5, 16)
    xt = torch.from_numpy(x)
    out = tnk.rms_norm_ref(xt, torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(o), **TOL)
    want = torch.rsqrt(xt.square().mean(-1) + 1e-5)
    np.testing.assert_allclose(want.numpy(), np.asarray(rstd)[:, 0], **TOL)


@pytest.mark.parametrize("h", [768, 1024])
def test_plain_ln_forward_matches_interpret_kernel(h):
    x, w, b = _inputs(h, h + 1)
    o, mean, rstd = jnk._ln_fwd(*map(jnp.asarray, (x, w, b)), 1e-12, 16)
    xt = torch.from_numpy(x)
    out = tnk.layer_norm_ref(xt, torch.from_numpy(w), torch.from_numpy(b),
                             1e-12)
    np.testing.assert_allclose(out.numpy(), np.asarray(o), **TOL)
    mu = xt.mean(-1)
    want = torch.rsqrt((xt - mu[:, None]).square().mean(-1) + 1e-12)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mean)[:, 0], **TOL)
    np.testing.assert_allclose(want.numpy(), np.asarray(rstd)[:, 0], **TOL)
