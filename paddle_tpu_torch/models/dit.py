"""DiT, the diffusion transformer: training loss and DDIM sampling.

≙ `paddle_tpu/models/dit.py`: `DiTConfig` :20-47 (``xl_2``, ``tiny``),
`timestep_embedding` :50-61 (f32, cos before sin), `TimestepEmbedder`
:64-73, `LabelEmbedder` :76-84 (num_classes + 1 rows: the
classifier-free-guidance null class), `DiTBlock` :87-123 (adaLN-Zero:
LayerNorms without an affine at eps 1e-6, non-causal attention, tanh
GELU), `FinalLayer` :126-143, `DiT` :146-204 (the 2-D sin-cos
``pos_embed`` buffer; patchify and unpatchify are reshapes and a
transpose, with the patch embedding an ``nn.Linear``, so no convolution
is needed), `synthetic_dit_batch` :207-213 and `GaussianDiffusion`
:216-348.

Attention is flash attention, non-causal (the CUDA kernels forward and
backward on the card: head dim 72 at DiT-XL/2 runs the mma.sync design,
28 launches a forward); every LayerNorm is the port's LayerNorm kernel
pair with constant ones / zeros (57 forward and 57 backward launches a
training step at DiT-XL/2), whose backward spends no dw / db sums on
them (`nn.layers.LayerNorm`). ``ada`` and ``final_layer`` start at zero,
as in JAX, so an untrained model's output is exactly zero.

`GaussianDiffusion.ddim_sample` runs the JAX scan body's timestep grid and
update as an eager loop of ``num_steps`` forwards on the model's device
(JAX compiles the whole sampler into one program; a CUDA graph of the
loop is later work, ROADMAP.md queue A, item 11). Its x_T and eta noise,
and `training_loss`'s noise when none is given, come from
`torch.Generator` streams on the model's device: the same distributions
as JAX's draws, not the same numbers. `_ddim_loop` takes x_T, so that a
caller can hand it JAX's own. `models.convert.dit_state_from_numpy`
carries a JAX model's weights (``pos_embed`` is a non-persistent buffer,
recomputed, not carried).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..nn import functional as F
from ..nn.layers import LayerNorm
from ..ops import resolve_device
from .bert import _init

__all__ = ["DiTConfig", "DiT", "GaussianDiffusion", "synthetic_dit_batch",
           "timestep_embedding"]


@dataclass
class DiTConfig:
    input_size: int = 32          # latent H=W
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    learn_sigma: bool = True

    @staticmethod
    def xl_2():
        return DiTConfig()

    @staticmethod
    def tiny():
        return DiTConfig(input_size=8, patch_size=2, in_channels=4,
                         hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, num_classes=10)

    @property
    def num_patches(self):
        return (self.input_size // self.patch_size) ** 2

    @property
    def out_channels(self):
        return self.in_channels * (2 if self.learn_sigma else 1)

    def num_params(self) -> int:
        h, p = self.hidden_size, self.patch_size
        mh = int(h * self.mlp_ratio)
        out = p * p * self.out_channels
        block = 3 * h * h + 3 * h + h * h + h + 2 * h * mh + mh + h \
            + 6 * h * h + 6 * h
        return (p * p * self.in_channels * h + h) \
            + (256 * h + h + h * h + h) + (self.num_classes + 1) * h \
            + self.num_hidden_layers * block \
            + (2 * h * h + 2 * h + h * out + out)


def timestep_embedding(t, dim, max_period=10000):
    """Sinusoidal timestep embedding (B,) -> (B, dim) f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedder(torch.nn.Module):
    def __init__(self, hidden_size, freq_dim=256, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.freq_dim = freq_dim
        self.mlp = torch.nn.Sequential(
            torch.nn.Linear(freq_dim, hidden_size, **kw), torch.nn.SiLU(),
            torch.nn.Linear(hidden_size, hidden_size, **kw))

    def forward(self, t):
        emb = timestep_embedding(t, self.freq_dim)
        return self.mlp(emb.to(self.mlp[0].weight.dtype))


class LabelEmbedder(torch.nn.Module):
    def __init__(self, num_classes, hidden_size, device=None, dtype=None):
        super().__init__()
        # +1 slot: the classifier-free-guidance null class
        self.embedding_table = torch.nn.Embedding(
            num_classes + 1, hidden_size, device=device, dtype=dtype)
        self.num_classes = num_classes

    def forward(self, labels):
        return self.embedding_table(labels.long())


def _no_affine_norm(h, **kw):
    return LayerNorm(h, 1e-6, weight_attr=False, bias_attr=False, **kw)


class DiTBlock(torch.nn.Module):
    """adaLN-Zero block: condition c modulates scale/shift/gate of both
    the attention and MLP branches; gates start at zero."""

    def __init__(self, cfg: DiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.norm1 = _no_affine_norm(h, **kw)
        self.norm2 = _no_affine_norm(h, **kw)
        self.num_heads = cfg.num_attention_heads
        self.head_dim = h // cfg.num_attention_heads
        self.qkv = torch.nn.Linear(h, 3 * h, **kw)
        self.proj = torch.nn.Linear(h, h, **kw)
        mh = int(h * cfg.mlp_ratio)
        self.fc1 = torch.nn.Linear(h, mh, **kw)
        self.fc2 = torch.nn.Linear(mh, h, **kw)
        self.ada = torch.nn.Linear(h, 6 * h, **kw)

    def forward(self, x, c, use_kernel=None):
        b, s = x.shape[0], x.shape[1]
        mods = self.ada(F.silu(c))[:, None]              # (B, 1, 6H)
        sh1, sc1, g1, sh2, sc2, g2 = mods.chunk(6, dim=-1)
        h1 = self.norm1(x, use_kernel) * (1 + sc1) + sh1
        q, k, v = self.qkv(h1).reshape(b, s, 3, self.num_heads,
                                       self.head_dim).unbind(2)
        attn = F.scaled_dot_product_attention(q, k, v,
                                              use_kernel=use_kernel)
        x = x + g1 * self.proj(attn.reshape(b, s, -1))
        h2 = self.norm2(x, use_kernel) * (1 + sc2) + sh2
        return x + g2 * self.fc2(F.gelu(self.fc1(h2), approximate=True))


class FinalLayer(torch.nn.Module):
    def __init__(self, cfg: DiTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.norm = _no_affine_norm(h, **kw)
        self.ada = torch.nn.Linear(h, 2 * h, **kw)
        self.linear = torch.nn.Linear(
            h, cfg.patch_size * cfg.patch_size * cfg.out_channels, **kw)

    def forward(self, x, c, use_kernel=None):
        shift, scale = self.ada(F.silu(c))[:, None].chunk(2, dim=-1)
        return self.linear(self.norm(x, use_kernel) * (1 + scale) + shift)


class DiT(torch.nn.Module):
    """forward(x (B, C, H, W), t (B,), y (B,)) -> noise prediction (B,
    out_channels, H, W) in the model's dtype. Builds on the CUDA card
    unless ``device`` names another device (without CUDA and without a
    device it raises); ``dtype`` defaults to float32 (x is cast to it).
    ``seed`` seeds the `torch.Generator` that initialises the weights
    with the JAX initialisers; ``ada`` and ``final_layer`` start at
    zero."""

    def __init__(self, cfg: DiTConfig | None = None, device=None,
                 dtype=None, seed: int = 0):
        super().__init__()
        cfg = cfg or DiTConfig()
        device = resolve_device(device)
        dtype = dtype if dtype is not None else torch.float32
        kw = dict(device=device, dtype=dtype)
        self.config = cfg
        p = cfg.patch_size
        self.x_embedder = torch.nn.Linear(p * p * cfg.in_channels,
                                          cfg.hidden_size, **kw)
        pos = self._build_2d_sincos(cfg.hidden_size, cfg.input_size // p)
        # in the model's dtype, as `Module.to(dtype)` casts buffers
        self.register_buffer(
            "pos_embed", torch.from_numpy(pos[None].astype(np.float32))
            .to(**kw), persistent=False)
        self.t_embedder = TimestepEmbedder(cfg.hidden_size, **kw)
        self.y_embedder = LabelEmbedder(cfg.num_classes, cfg.hidden_size,
                                        **kw)
        self.blocks = torch.nn.ModuleList(
            [DiTBlock(cfg, **kw) for _ in range(cfg.num_hidden_layers)])
        self.final_layer = FinalLayer(cfg, **kw)
        _init(self, torch.Generator(device=device).manual_seed(seed))
        with torch.no_grad():
            for m in [blk.ada for blk in self.blocks] + [
                    self.final_layer.ada, self.final_layer.linear]:
                m.weight.zero_()
                m.bias.zero_()

    @property
    def device(self) -> torch.device:
        return self.x_embedder.weight.device

    @staticmethod
    def _build_2d_sincos(dim, grid):
        ys, xs = np.meshgrid(np.arange(grid), np.arange(grid),
                             indexing="ij")

        def emb_1d(posv, d):
            omega = 1.0 / 10000 ** (np.arange(d // 2) / (d / 2))
            out = posv.reshape(-1)[:, None] * omega[None]
            return np.concatenate([np.sin(out), np.cos(out)], axis=1)

        return np.concatenate([emb_1d(ys, dim // 2), emb_1d(xs, dim // 2)],
                              axis=1)

    def _patchify(self, x):
        p = self.config.patch_size
        b, c, hh, ww = x.shape
        gh, gw = hh // p, ww // p
        x = x.reshape(b, c, gh, p, gw, p).permute(0, 2, 4, 3, 5, 1)
        return x.reshape(b, gh * gw, p * p * c)          # B gh gw p p C

    def _unpatchify(self, x):
        cfg = self.config
        p, c = cfg.patch_size, cfg.out_channels
        g = cfg.input_size // p
        x = x.reshape(x.shape[0], g, g, p, p, c).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(x.shape[0], c, g * p, g * p)

    def forward(self, x, t, y, use_kernel=None):
        x = x.to(self.x_embedder.weight.dtype)
        h = self.x_embedder(self._patchify(x)) + self.pos_embed
        c = self.t_embedder(t) + self.y_embedder(y)
        for blk in self.blocks:
            h = blk(h, c, use_kernel)
        return self._unpatchify(self.final_layer(h, c, use_kernel))


def synthetic_dit_batch(batch_size, cfg: DiTConfig, seed=0):
    """(x (B, C, H, W) f32, t (B,) int32, y (B,) int32) on the CPU: the
    JAX package's numpy draws, value for value."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch_size, cfg.in_channels, cfg.input_size,
                         cfg.input_size)).astype(np.float32)
    t = rng.integers(0, 1000, (batch_size,)).astype(np.int32)
    y = rng.integers(0, cfg.num_classes, (batch_size,)).astype(np.int32)
    return torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y)


class GaussianDiffusion:
    """Diffusion training loss + DDIM sampler for DiT (a linear beta
    schedule over ``num_timesteps``). ``seed`` seeds the noise stream of
    `training_loss` (one `torch.Generator` a device, made at first use)."""

    def __init__(self, num_timesteps: int = 1000, beta_start: float = 1e-4,
                 beta_end: float = 0.02, seed: int = 0):
        self.num_timesteps = num_timesteps
        betas = np.linspace(beta_start, beta_end, num_timesteps,
                            dtype=np.float64)
        self.alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        self.seed = seed
        self._generators = {}

    def generator(self, device) -> torch.Generator:
        """The loss's noise stream on ``device``."""
        device = torch.device(device)
        if device not in self._generators:
            self._generators[device] = torch.Generator(device=device) \
                .manual_seed(self.seed)
        return self._generators[device]

    def training_loss(self, model: DiT, x0, t, y, noise=None,
                      use_kernel=None):
        """MSE (f32) between the predicted and the true noise at
        timesteps ``t``; ``noise`` (x0's shape, f32) defaults to a draw
        from `generator` on x0's device."""
        dev = x0.device
        if noise is None:
            noise = torch.randn(x0.shape, generator=self.generator(dev),
                                device=dev, dtype=torch.float32)
        ac = torch.from_numpy(self.alphas_cumprod).to(dev)
        a = ac[t.long()][:, None, None, None]
        xt = torch.sqrt(a) * x0.float() + torch.sqrt(1.0 - a) * noise
        pred = model(xt, t, y, use_kernel=use_kernel)
        c = x0.shape[1]
        eps = pred[:, :c] if pred.shape[1] != c else pred
        return ((eps.float() - noise) ** 2).mean()

    def ddim_sample(self, model: DiT, batch_size: int, y,
                    num_steps: int = 50, eta: float = 0.0,
                    seed: int | None = None, use_kernel=None):
        """DDIM sampler (eta 0 deterministic; eta > 0 adds the stochastic
        sigma_t term, eta 1 ~ DDPM): x_T ~ N(0, I) -> x_0 (B, C, H, W)
        f32 on the model's device. ``seed`` seeds the `torch.Generator`
        of x_T and of the eta noise; None draws the seed from torch's
        default generator."""
        cfg = model.config
        dev = model.device
        if seed is None:
            seed = int(torch.randint(0, 2 ** 62, ()).item())
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        x = torch.randn((batch_size, cfg.in_channels, cfg.input_size,
                         cfg.input_size), generator=gen, device=dev,
                        dtype=torch.float32)
        return self._ddim_loop(model, x, y, num_steps, eta, gen, use_kernel)

    @torch.no_grad()
    def _ddim_loop(self, model: DiT, x, y, num_steps: int, eta: float = 0.0,
                   generator=None, use_kernel=None):
        """The sampler from x_T ``x`` (f32): ≙ the JAX scan body, one
        model forward a step over the timestep grid ``linspace(T - 1, 0,
        num_steps)``. The schedule's scalars are f32 on the host (no step
        reads the device); with eta > 0 each step draws its noise from
        ``generator`` (the last step's is multiplied by 0, as in JAX)."""
        dev = x.device
        b, c = x.shape[0], model.config.in_channels
        y = torch.as_tensor(y).to(dev)
        ts = np.linspace(self.num_timesteps - 1, 0, num_steps) \
            .round().astype(np.int32)
        ac = self.alphas_cumprod
        f32, one = np.float32, np.float32(1.0)
        for i in range(num_steps):
            t_prev = int(ts[i + 1]) if i + 1 < num_steps else -1
            tb = torch.full((b,), int(ts[i]), dtype=torch.int32, device=dev)
            pred = model(x, tb, y, use_kernel=use_kernel)
            eps = (pred[:, :c] if pred.shape[1] != c else pred).float()
            a_t = ac[ts[i]]
            a_p = ac[t_prev] if t_prev >= 0 else one
            x0 = (x - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
            sigma = f32(eta) * np.sqrt(max(
                f32((one - a_p) / max(one - a_t, f32(1e-12))
                    * (one - a_t / a_p)), f32(0.0)))
            dir_coef = np.sqrt(max(f32(one - a_p - sigma * sigma), f32(0.0)))
            x = float(np.sqrt(a_p)) * x0 + float(dir_coef) * eps
            if eta > 0.0:
                noise = torch.randn(x.shape, generator=generator, device=dev,
                                    dtype=torch.float32)
                x = x + float(sigma if t_prev >= 0 else 0.0) * noise
        return x
