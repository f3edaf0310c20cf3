"""Utilities of the port (counterpart of ray_tpu/util): so far the train
path's telemetry."""
