"""The port's `BatchPredictor` against the JAX package's, on the CPU.

Over the runtime's `ray_tpu.data.from_items` (map tasks in worker
processes), the port's BatchPredictor with `CompiledPredictor` gives JAX's
BatchPredictor with `JaxPredictor` on the same checkpoint and rows: the
linear apply of tests/test_predictors.py to 1e-6, a tiny ViT (converted
weights, fp32) to the 2e-5 that tests/test_torch_predictor.py holds the
predictors to. Each worker process keeps one predictor. In one process,
over a stand-in dataset, the cache's keys, its bound of 4 and its
eviction before a load are JAX's.
"""

import os
import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu import data
from ray_tpu.models import vit as jvit
from ray_tpu.train import predictor as jpred
from ray_tpu.train.checkpoint import Checkpoint as JaxCheckpoint
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.convert import params_from_jax_numpy
from ray_tpu_torch.train import BatchPredictor
from ray_tpu_torch.train import predictor as tpred
from ray_tpu_torch.train.checkpoint import Checkpoint

# a lambda (pickled by value): the map tasks need not import this module
_linear_apply = lambda params, x: x @ params["w"] + params["b"]  # noqa: E731
VIT = dict(image_size=224, patch_size=16, d_model=64, n_layers=2,
           n_heads=4, d_ff=128, num_classes=10)
VIT_TOL = 2e-5


class InProcessDataset:
    """A dataset whose `map_batches` runs its blocks in this process."""

    def __init__(self, rows):
        self.rows = rows

    def map_batches(self, fn, batch_size=None):
        size = batch_size or len(self.rows)
        out = []
        for i in range(0, len(self.rows), size):
            block = self.rows[i:i + size]
            batch = {k: np.stack([r[k] for r in block]) for k in block[0]}
            res = fn(batch)
            out += [{k: v[j] for k, v in res.items()}
                    for j in range(len(block))]
        return InProcessDataset(out)

    def take_all(self):
        return list(self.rows)


@pytest.fixture
def runtime():
    ray_tpu.init(num_cpus=4)
    yield
    ray_tpu.shutdown()


@pytest.fixture
def linear_checkpoint(tmp_path):
    params = {"w": np.array([[2.0], [1.0]], np.float32),
              "b": np.array([0.5], np.float32)}
    d = str(tmp_path / "ck")
    os.makedirs(d)
    with open(os.path.join(d, "params.pkl"), "wb") as f:
        pickle.dump(params, f)
    return d


def _by_input(rows, key="inputs"):
    return sorted(rows, key=lambda r: np.asarray(r[key]).ravel().tolist())


def test_linear_over_the_runtime_matches_jax(runtime, linear_checkpoint):
    rows = [{"inputs": np.array([float(i), 0.5 * i], np.float32)}
            for i in range(10)]
    want = jpred.BatchPredictor(
        JaxCheckpoint(linear_checkpoint), jpred.JaxPredictor,
        apply_fn=_linear_apply).predict(data.from_items(rows),
                                        batch_size=4).take_all()
    got = BatchPredictor(
        Checkpoint(linear_checkpoint), tpred.CompiledPredictor,
        apply_fn=_linear_apply, device="cpu",
        backend="aot_eager").predict(data.from_items(rows),
                                     batch_size=4).take_all()
    assert len(got) == len(want) == 10
    for g, w in zip(_by_input(got, "predictions"),
                    _by_input(want, "predictions")):
        np.testing.assert_allclose(g["predictions"], w["predictions"],
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        sorted(float(np.ravel(r["predictions"])[0]) for r in got),
        [2.5 * i + 0.5 for i in range(10)], rtol=1e-6)


def test_tiny_vit_over_the_runtime_matches_jax(runtime, tmp_path):
    jcfg = jvit.ViTConfig(**VIT, dtype=jnp.float32, remat=False)
    tcfg = tvit.ViTConfig(**VIT, dtype=torch.float32, remat=False)
    jparams = jax.device_get(jvit.init(jcfg, jax.random.PRNGKey(0)))
    d = str(tmp_path / "vit")
    os.makedirs(d)
    with open(os.path.join(d, "params.pkl"), "wb") as f:
        pickle.dump(jparams, f)
    port_ck = Checkpoint.from_arrays(
        params_from_jax_numpy(jparams, tcfg, device="cpu"),
        str(tmp_path / "port"))
    rng = np.random.default_rng(3)
    rows = [{"inputs": rng.standard_normal((224, 224, 3)).astype(np.float32),
             "i": np.int64(i)} for i in range(6)]
    want = jpred.BatchPredictor(
        JaxCheckpoint(d), jpred.JaxPredictor,
        apply_fn=partial(jvit.forward, config=jcfg)).predict(
            data.from_items(rows), batch_size=4).take_all()
    got = BatchPredictor(
        port_ck, tpred.CompiledPredictor,
        apply_fn=partial(tvit.forward, config=tcfg), device="cpu",
        backend="aot_eager").predict(data.from_items(rows),
                                     batch_size=4).take_all()
    assert len(got) == len(want) == 6
    for g, w in zip(_by_input(got, "predictions"),
                    _by_input(want, "predictions")):
        assert g["predictions"].shape == (10,)
        np.testing.assert_allclose(g["predictions"], w["predictions"],
                                   rtol=VIT_TOL, atol=VIT_TOL)


def test_one_predictor_per_worker_process(runtime, linear_checkpoint):
    class Recording(tpred.CompiledPredictor):
        def predict(self, batch, **kw):
            out = super().predict(batch, **kw)
            n = len(out["predictions"])
            return {**out, "pid": np.full(n, os.getpid()),
                    "predictor": np.full(n, id(self))}

    rows = [{"inputs": np.array([float(i), 1.0], np.float32)}
            for i in range(24)]
    out = BatchPredictor(
        Checkpoint(linear_checkpoint), Recording, apply_fn=_linear_apply,
        device="cpu", backend="aot_eager").predict(
            data.from_items(rows), batch_size=4).take_all()
    assert len(out) == 24
    by_pid, rows_by_pid = {}, {}
    for r in out:
        by_pid.setdefault(int(r["pid"]), set()).add(int(r["predictor"]))
        rows_by_pid[int(r["pid"])] = rows_by_pid.get(int(r["pid"]), 0) + 1
    assert all(len(ids) == 1 for ids in by_pid.values()), by_pid
    # 8 blocks of 3 rows: some process mapped more than one block
    assert max(rows_by_pid.values()) > 3, rows_by_pid


def _loads_in_order(make_bp, cache):
    """Run six BatchPredictors of distinct kwargs, then the first again,
    over a stand-in dataset: -> the cache size at each load, the cache's
    keys at the end, and the outputs."""
    sizes = []

    class Rec:
        def __init__(self, scale):
            self.scale = scale

        @classmethod
        def from_checkpoint(cls, checkpoint, *, scale):
            sizes.append(len(cache))
            return cls(scale)

        def predict(self, batch):
            return {"out": batch["x"] * self.scale}

    ds = InProcessDataset([{"x": np.float32(i)} for i in range(5)])
    outs = []
    for scale in (1, 2, 3, 4, 5, 6, 1):
        res = make_bp(Rec, scale).predict(ds, batch_size=2).take_all()
        outs.append([float(r["out"]) for r in res])
    return sizes, list(cache), outs


def test_the_cache_behaves_as_jax(tmp_path):
    path = str(tmp_path)
    jpred._PREDICTOR_CACHE.clear()
    tpred._PREDICTOR_CACHE.clear()
    try:
        want = _loads_in_order(
            lambda cls, s: jpred.BatchPredictor(
                JaxCheckpoint(path), cls, scale=s), jpred._PREDICTOR_CACHE)
        got = _loads_in_order(
            lambda cls, s: BatchPredictor(
                Checkpoint(path), cls, scale=s), tpred._PREDICTOR_CACHE)
    finally:
        jpred._PREDICTOR_CACHE.clear()
        tpred._PREDICTOR_CACHE.clear()
    # five scales fill the cache to its bound of 4; each load after that
    # evicts the oldest first; scale 1 was evicted, so it loads again
    assert got[0] == want[0] == [0, 1, 2, 3, 3, 3, 3]
    assert got[1] == want[1] and len(got[1]) == tpred.PREDICTOR_CACHE_SIZE
    assert got[2] == want[2]
    key = BatchPredictor(Checkpoint(path), tpred.CompiledPredictor,
                         scale=2).cache_key()
    assert key[:2] == ("CompiledPredictor", os.path.abspath(path))


def test_a_second_predict_reuses_the_compiled_predictor(linear_checkpoint):
    """torch.compile sets attributes on the function it compiles: the key
    is taken before, so a second pass finds the first pass's predictor."""
    loads = []

    class Counted(tpred.CompiledPredictor):
        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            loads.append(1)
            return super().from_checkpoint(checkpoint, **kwargs)

    def apply(params, x):
        return x @ params["w"] + params["b"]

    tpred._PREDICTOR_CACHE.clear()
    try:
        bp = BatchPredictor(Checkpoint(linear_checkpoint), Counted,
                            apply_fn=apply, device="cpu",
                            backend="aot_eager")
        ds = InProcessDataset([{"inputs": np.array([float(i), 1.0],
                                                   np.float32)}
                               for i in range(6)])
        first = bp.predict(ds, batch_size=4).take_all()
        second = bp.predict(ds, batch_size=4).take_all()
        pred = tpred._PREDICTOR_CACHE[bp.cache_key()]
    finally:
        tpred._PREDICTOR_CACHE.clear()
    assert len(loads) == 1
    assert pred.compiles == len(pred.buckets) == 2  # buckets 4 and 2
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a["predictions"], b["predictions"])
