"""Importable app for the port's serve schema deploy test
(tests/test_torch_serve.py)."""
from ray_tpu_torch import serve


@serve.deployment
class Doubler:
    def double(self, x):
        return x * 2


app = Doubler.bind()
