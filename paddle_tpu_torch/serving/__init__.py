"""The serving layer above one engine (≙ `paddle_tpu/serving`). Ported so
far: `model_store.py`, the fleet model store (registered checkpoints
and LoRA adapters, per-replica resident sets under a byte budget)."""
from .model_store import FleetModelStore, model_id, split_model_id

__all__ = ["FleetModelStore", "model_id", "split_model_id"]
