"""Operators of the port (counterpart: `paddle_tpu/ops/`)."""
