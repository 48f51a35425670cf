"""The port's data plane: the device feed (`iter_device_batches`), the
counterpart of `ray_tpu.data`'s `Dataset.iter_jax_batches`."""

from ray_tpu_torch.data.dataset import iter_device_batches  # noqa: F401
