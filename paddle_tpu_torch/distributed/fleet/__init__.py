"""≙ `paddle_tpu/distributed/fleet/`: so far `elastic`, the train-loop
side of elastic training, and `utils` (`recompute`)."""
