"""Gradient clips (≙ `paddle_tpu/nn/__init__.py` :10-30, applied as
`paddle_tpu/optimizer/__init__.py` :132-155 applies them). An optimizer
given one as ``grad_clip`` calls it on the list of gradients before its
update; each returns the clipped gradients in their own dtypes."""
from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm,
    clip_norm)``, the global norm taken in f32 over all of them."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __repr__(self):
        return f"ClipGradByGlobalNorm(clip_norm={self.clip_norm})"

    def __call__(self, grads):
        if not grads:
            return grads
        sq = torch.stack([g.float().square().sum() for g in grads])
        gn = sq.sum().sqrt()
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        return [(g.float() * scale).to(g.dtype) for g in grads]


class ClipGradByNorm:
    """Scale each gradient on its own by ``min(clip_norm / max(norm,
    1e-6), 1)``, its norm taken in f32."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads):
        out = []
        for g in grads:
            n = g.float().square().sum().sqrt()
            scale = torch.clamp(self.clip_norm / torch.clamp(n, min=1e-6),
                                max=1.0)
            out.append((g.float() * scale).to(g.dtype))
        return out


class ClipGradByValue:
    """Clamp every element to ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, grads):
        return [g.clamp(self.min, self.max) for g in grads]
