"""Predictors — checkpoint -> batch inference (reference: ray
python/ray/train/predictor.py Predictor, torch/torch_predictor.py,
_internal/dl_predictor.py).

The port's counterpart of `ray_tpu/train/predictor.py`. `Predictor`,
`_bucket` and `TorchPredictor` are copies (they import no JAX).
`CompiledPredictor` takes `JaxPredictor`'s place with its contract:
`apply_fn(params, inputs)`, `from_checkpoint(ckpt, apply_fn=...)`, and
batches padded with their last row to a power of two, so that there is
one compiled program per bucket. Where JAX jits the apply once and XLA
compiles it per shape, here the apply is `torch.compile`d (fullgraph,
static shapes: `dynamic=False`) and called under `torch.no_grad`; dynamo
compiles it once per bucket, and the predictor counts the compiles. A
compile that fails raises: no eager path takes over (fullgraph raises at
a graph break and at the recompile limit).

`BatchPredictor` maps a predictor over a dataset that comes in as an
argument (the runtime's `ray_tpu.data.Dataset`, or anything with
`map_batches(fn, batch_size=)`), with one predictor per worker process.
"""

from __future__ import annotations

import functools
import hashlib
import os
import pickle
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.optim import tree_leaves, tree_map


class Predictor:
    """Base: subclass implements _predict_numpy(batch) -> batch."""

    def __init__(self, preprocessor=None):
        self._preprocessor = preprocessor

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, data: Dict[str, np.ndarray], **kwargs
                ) -> Dict[str, np.ndarray]:
        if self._preprocessor is not None:
            data = self._preprocessor.transform_batch(dict(data))
        return self._predict_numpy(data, **kwargs)

    def _predict_numpy(self, batch: Dict[str, np.ndarray], **kwargs
                       ) -> Dict[str, np.ndarray]:
        raise NotImplementedError


def _bucket(n: int) -> int:
    """Round the batch dim up to a power of two so recompiles are
    O(log max_batch) instead of one per distinct size."""
    b = 1
    while b < n:
        b *= 2
    return b


class CompiledPredictor(Predictor):
    """apply_fn(params, inputs) -> outputs, compiled once per batch bucket.

    params: a tree of tensors or numpy arrays (moved to `device`, None =
    cuda). Checkpoint layout: `params.pkl` (a pickled tree, as JAX's
    predictor reads) or a tree written by `Checkpoint.from_arrays`; pass
    the model's apply function at from_checkpoint time. backend: the
    torch.compile backend. The default, "cudagraphs", replays the eager
    kernels from one CUDA graph a bucket: the eager forward's numbers, bit
    for bit, without its launch overhead (on CPU tensors it runs the traced
    graph as it is). "inductor" fuses the elementwise work, and its fused
    bf16 arithmetic rounds other than eager's. On ViT-B/16 in bf16 on an
    H100 (`chip_smoke.py --only o`) inductor took a third less device time
    at 32 and 64 rows, 2.8 times more at one row and about ten times the
    compile, and moved logits by up to 5e-2 from eager's, past the 1e-2
    the predictor is held to. Outputs come back as numpy, bf16 as fp32
    (numpy has no bf16). `compiles` counts the programs built, `buckets`
    the batch sizes they were built for.
    """

    def __init__(self, params, apply_fn: Callable, preprocessor=None,
                 input_column: str = "inputs",
                 output_column: str = "predictions", device=None,
                 backend: str = "cudagraphs"):
        super().__init__(preprocessor)
        self.device = resolve_device(device)
        self.params = tree_map(self._to_device, params)
        for leaf in tree_leaves(self.params):
            # the same tensors every call: a CUDA graph reads them in place
            torch._dynamo.mark_static_address(leaf)
        self.input_column = input_column
        self.output_column = output_column
        self.backend = backend
        self.compiles = 0
        self.buckets = []
        target = torch._dynamo.lookup_backend(backend)

        def counting(gm, example_inputs):
            self.compiles += 1
            return target(gm, example_inputs)

        self._apply = torch.compile(apply_fn, backend=counting,
                                    fullgraph=True, dynamic=False)

    def _to_device(self, x):
        """A tensor on the device; float64 arrays become fp32, as JAX
        (without x64) takes them."""
        if isinstance(x, np.ndarray) and x.dtype == np.float64:
            x = x.astype(np.float32)
        return torch.as_tensor(x).to(self.device)

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        apply_fn: Callable, **kwargs) -> "CompiledPredictor":
        with checkpoint.as_directory() as d:
            if os.path.exists(os.path.join(d, "tree.json")):
                params = checkpoint.to_arrays()
            else:
                with open(os.path.join(d, "params.pkl"), "rb") as f:
                    params = pickle.load(f)
        return cls(params, apply_fn, **kwargs)

    def _predict_numpy(self, batch, **kwargs):
        x = np.asarray(batch[self.input_column])
        n = len(x)
        b = _bucket(n)
        if b != n:
            pad = np.repeat(x[-1:], b - n, axis=0)
            x = np.concatenate([x, pad])
        if b not in self.buckets:
            self.buckets.append(b)
        with torch.no_grad():
            out = self._apply(self.params, self._to_device(x))[:n]
        if out.dtype == torch.bfloat16:
            out = out.float()
        return {self.output_column: out.cpu().numpy()}


class TorchPredictor(Predictor):
    """torch.nn.Module inference (reference: torch/torch_predictor.py).
    Checkpoint layout: `model.pt` (whole pickled module) or pass `model=`."""

    def __init__(self, model, preprocessor=None,
                 input_column: str = "inputs",
                 output_column: str = "predictions"):
        super().__init__(preprocessor)
        self.model = model.eval()
        self.input_column = input_column
        self.output_column = output_column

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        model=None, **kwargs) -> "TorchPredictor":
        with checkpoint.as_directory() as d:
            if os.path.exists(f"{d}/model.pt"):
                model = torch.load(f"{d}/model.pt", weights_only=False)
            elif model is not None:
                state = torch.load(f"{d}/model_state.pt",
                                   weights_only=True)
                model.load_state_dict(state)
            else:
                raise ValueError(
                    "checkpoint has no model.pt; pass model= to load a "
                    "state dict into")
        return cls(model, **kwargs)

    def _predict_numpy(self, batch, **kwargs):
        x = torch.as_tensor(np.asarray(batch[self.input_column]))
        with torch.no_grad():
            out = self.model(x)
        return {self.output_column: out.cpu().numpy()}


# The worker process's predictors (see BatchPredictor.predict); at most
# PREDICTOR_CACHE_SIZE, the oldest evicted first.
_PREDICTOR_CACHE: Dict[Any, Predictor] = {}
PREDICTOR_CACHE_SIZE = 4


class BatchPredictor:
    """Dataset-scale inference: a predictor per worker process of the
    dataset's `map_batches` (reference: train/batch_predictor.py)."""

    def __init__(self, checkpoint: Checkpoint, predictor_cls,
                 **predictor_kwargs):
        self._checkpoint = checkpoint
        self._cls = predictor_cls
        self._kwargs = predictor_kwargs
        # The key is taken now: torch.compile sets attributes on the
        # function it compiles, which would change a later digest.
        try:
            digest = hashlib.sha256(pickle.dumps(
                sorted(predictor_kwargs.items(), key=lambda kv: kv[0]))
            ).hexdigest()
        except Exception:  # noqa: BLE001 — unpicklable kwargs: no sharing
            digest = repr(id(predictor_kwargs))
        self._key = (predictor_cls.__name__,
                     getattr(checkpoint, "path", id(checkpoint)), digest)

    def cache_key(self):
        """(class name, checkpoint path, digest of the kwargs), taken at
        construction: the key survives the function's pickling, so the map
        tasks of one process share one predictor; unpicklable kwargs share
        nothing."""
        return self._key

    def predict(self, dataset, *, batch_size: Optional[int] = 256):
        """`dataset.map_batches` of the predictor's `predict`, batches of
        `batch_size` rows."""
        fn = functools.partial(_predict_cached, self._key, self._cls,
                               self._checkpoint, self._kwargs)
        return dataset.map_batches(fn, batch_size=batch_size)


def _predict_cached(key, cls, checkpoint, kwargs, batch):
    """One batch through this process's predictor for `key`, loaded on
    first use. A module-level function, so that a map task pickles it by
    reference and finds this process's cache, not a copy of it."""
    p = _PREDICTOR_CACHE.get(key)
    if p is None:
        # evict before the load: at most the bound of models held
        while len(_PREDICTOR_CACHE) >= PREDICTOR_CACHE_SIZE:
            _PREDICTOR_CACHE.pop(next(iter(_PREDICTOR_CACHE)))
        p = cls.from_checkpoint(checkpoint, **kwargs)
        _PREDICTOR_CACHE[key] = p
    return p.predict(batch)
