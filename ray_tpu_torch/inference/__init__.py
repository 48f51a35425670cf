"""LLM inference on the port: bucketed prefill and continuous-batching
decode over the dense KV cache (counterpart of `ray_tpu.inference`)."""

from ray_tpu_torch.inference.engine import GenerationConfig, InferenceEngine  # noqa: F401
from ray_tpu_torch.inference.sampling import sample_token  # noqa: F401
