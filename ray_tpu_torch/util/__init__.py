"""Utilities of the port: the collective groups (`collective`), the
counterpart of `ray_tpu.util.collective`, and the metrics registry and
event ring (`metrics`), the counterpart of `ray_tpu.util.metrics`."""
