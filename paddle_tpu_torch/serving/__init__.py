"""The serving layer above one engine (≙ `paddle_tpu/serving`). Ported so
far: `model_store.py`, the fleet model store (registered checkpoints
and LoRA adapters, per-replica resident sets under a byte budget);
`transfer.py`, the KV page transfer plane (serialize, install and
migrate a request between engines); `prefix_store.py`, the fleet prefix
store (chain warmth and its host-RAM spill tier)."""
from . import transfer
from .model_store import FleetModelStore, model_id, split_model_id
from .prefix_store import FleetPrefixStore, chain_hashes
from .transfer import (TransferStageTimeout, install_request,
                       migrate_request, payload_nbytes, serialize_request)

__all__ = ["FleetModelStore", "model_id", "split_model_id",
           "FleetPrefixStore", "chain_hashes", "transfer",
           "serialize_request", "install_request", "migrate_request",
           "payload_nbytes", "TransferStageTimeout"]
