"""Utilities of the port: the collective groups (`collective`), the
counterpart of `ray_tpu.util.collective`."""
