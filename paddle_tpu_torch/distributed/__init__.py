"""The distributed package of the port, one card so far: `checkpoint`
(state-dict save and restore, integrity manifests, the verify CLI) and
`fleet.elastic` (the atomic commit protocol, corruption-tolerant resume,
heartbeat membership) and `fleet.utils` (activation recompute)."""
