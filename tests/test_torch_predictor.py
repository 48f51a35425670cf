"""The port's `CompiledPredictor` against the JAX package's `JaxPredictor`,
on the CPU.

The same checkpoints (a pickled numpy `params.pkl`, as
`tests/test_predictors.py` writes it) and the same numpy batches go
through both predictors: the linear apply of the JAX tests, and a tiny ViT
(ViT-B/16's image and patch at narrow width) on weights converted from
the JAX init. Outputs agree to 1e-6 (linear) and 2e-5 (ViT, fp32), batches
are padded with their last row to a power of two and cut back, and the
predictor builds exactly one program per bucket. The port compiles with
`backend="aot_eager"` here (inductor needs Triton, which the CPU host has
not), and dynamo is reset between tests.
"""

import os
import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vit as jvit
from ray_tpu.train.predictor import JaxPredictor
from ray_tpu.train.checkpoint import Checkpoint as JaxCheckpoint
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.convert import params_from_jax_numpy
from ray_tpu_torch.train import predictor as tpred
from ray_tpu_torch.train.checkpoint import Checkpoint

_linear_apply = lambda params, x: x @ params["w"] + params["b"]  # noqa: E731
VIT = dict(image_size=224, patch_size=16, d_model=64, n_layers=2,
           n_heads=4, d_ff=128, num_classes=10)
VIT_TOL = 2e-5


@pytest.fixture(autouse=True)
def _fresh_dynamo():
    torch._dynamo.reset()
    yield
    torch._dynamo.reset()


@pytest.fixture
def linear_checkpoint(tmp_path):
    params = {"w": np.array([[2.0], [1.0]], np.float32),
              "b": np.array([0.5], np.float32)}
    d = str(tmp_path / "ck")
    os.makedirs(d)
    with open(os.path.join(d, "params.pkl"), "wb") as f:
        pickle.dump(params, f)
    return d


def _port(path, apply_fn, **kw):
    return tpred.CompiledPredictor.from_checkpoint(
        Checkpoint(path), apply_fn=apply_fn, device="cpu",
        backend="aot_eager", **kw)


def test_linear_predictions_and_buckets_match_jax(linear_checkpoint):
    jp = JaxPredictor.from_checkpoint(JaxCheckpoint(linear_checkpoint),
                                      apply_fn=_linear_apply)
    tp = _port(linear_checkpoint, _linear_apply)
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 4, 7, 3, 8, 1):
        x = rng.random((n, 2)).astype(np.float32)
        want = jp.predict({"inputs": x})["predictions"]
        got = tp.predict({"inputs": x})["predictions"]
        assert got.shape == want.shape == (n, 1)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert tp.buckets == [1, 2, 4, 8]
    assert tp.compiles == 4
    out = tp.predict({"inputs": np.array([[1.0, 2.0], [3.0, 4.0]])})
    np.testing.assert_allclose(out["predictions"].ravel(), [4.5, 10.5])
    assert tp.compiles == 4


def test_padding_is_the_last_row_and_is_cut_back(linear_checkpoint):
    seen = []

    def apply(params, x):
        seen.append(x.shape[0])
        return x * params["w"][0, 0]
    tp = _port(linear_checkpoint, apply)
    x = np.arange(5, dtype=np.float32)[:, None]
    out = tp.predict({"inputs": x})["predictions"]
    np.testing.assert_array_equal(out, 2 * x)
    assert seen == [8]  # traced once, at the bucket's size


def test_preprocessor_runs_before_the_apply(linear_checkpoint):
    class Doubler:
        def transform_batch(self, b):
            return {"inputs": b["inputs"] * 2}
    tp = _port(linear_checkpoint, _linear_apply, preprocessor=Doubler())
    out = tp.predict({"inputs": np.array([[1.0, 0.0]], np.float32)})
    np.testing.assert_allclose(out["predictions"].ravel(), [4.5])


def test_vit_predictions_match_jax(tmp_path):
    jcfg = jvit.ViTConfig(**VIT, dtype=jnp.float32, remat=False)
    tcfg = tvit.ViTConfig(**VIT, dtype=torch.float32, remat=False)
    jparams = jax.device_get(jvit.init(jcfg, jax.random.PRNGKey(0)))
    d = str(tmp_path / "vit")
    os.makedirs(d)
    with open(os.path.join(d, "params.pkl"), "wb") as f:
        pickle.dump(jparams, f)
    jp = JaxPredictor.from_checkpoint(JaxCheckpoint(d), apply_fn=partial(
        jvit.forward, config=jcfg))
    # the port's own format, from the converted weights
    port_ck = Checkpoint.from_arrays(
        params_from_jax_numpy(jparams, tcfg, device="cpu"),
        str(tmp_path / "port"))
    tp = tpred.CompiledPredictor.from_checkpoint(
        port_ck, apply_fn=partial(tvit.forward, config=tcfg), device="cpu",
        backend="aot_eager")
    rng = np.random.default_rng(1)
    for n in (1, 3, 2):
        x = rng.standard_normal((n, 224, 224, 3)).astype(np.float32)
        want = jp.predict({"inputs": x})["predictions"]
        got = tp.predict({"inputs": x})["predictions"]
        assert got.shape == want.shape == (n, 10)
        np.testing.assert_allclose(got, want, rtol=VIT_TOL, atol=VIT_TOL)
    assert tp.buckets == [1, 4, 2] and tp.compiles == 3


def test_a_compile_failure_raises(linear_checkpoint):
    def breaks(params, x):
        torch._dynamo.graph_break()
        return x
    tp = _port(linear_checkpoint, breaks)
    with pytest.raises(Exception, match="graph_break|graph break"):
        tp.predict({"inputs": np.zeros((2, 2), np.float32)})


def test_compiled_predictor_needs_cuda_unless_asked_for_cpu(
        monkeypatch, linear_checkpoint):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpred.CompiledPredictor.from_checkpoint(
            Checkpoint(linear_checkpoint), apply_fn=_linear_apply)


def test_bucket_is_jax_bucket():
    from ray_tpu.train.predictor import _bucket

    for n in range(1, 130):
        assert tpred._bucket(n) == _bucket(n)


def test_torch_predictor_as_on_jax(tmp_path):
    model = torch.nn.Linear(2, 1)
    with torch.no_grad():
        model.weight.copy_(torch.tensor([[2.0, 1.0]]))
        model.bias.fill_(0.5)
    d = tmp_path / "ck"
    d.mkdir()
    torch.save(model, d / "model.pt")
    p = tpred.TorchPredictor.from_checkpoint(Checkpoint(str(d)))
    out = p.predict({"inputs": np.array([[1.0, 2.0]], np.float32)})
    np.testing.assert_allclose(out["predictions"].ravel(), [4.5])
    d2 = tmp_path / "ck2"
    d2.mkdir()
    torch.save(model.state_dict(), d2 / "model_state.pt")
    p2 = tpred.TorchPredictor.from_checkpoint(Checkpoint(str(d2)),
                                              model=torch.nn.Linear(2, 1))
    out = p2.predict({"inputs": np.array([[3.0, 4.0]], np.float32)})
    np.testing.assert_allclose(out["predictions"].ravel(), [10.5])
    with pytest.raises(ValueError, match="pass model="):
        tpred.TorchPredictor.from_checkpoint(Checkpoint(str(tmp_path)))


def test_default_backend_replays_cuda_graphs_and_runs_on_the_cpu(
        linear_checkpoint):
    """The default backend ("cudagraphs") replays the eager kernels on the
    card; on CPU tensors it runs the traced graph, the same numbers, one
    compile a bucket."""
    tp = tpred.CompiledPredictor.from_checkpoint(
        Checkpoint(linear_checkpoint), apply_fn=_linear_apply, device="cpu")
    assert tp.backend == "cudagraphs"
    x = np.random.default_rng(2).random((5, 2)).astype(np.float32)
    out = tp.predict({"inputs": x})["predictions"]
    np.testing.assert_allclose(out, x @ [[2.0], [1.0]] + 0.5, rtol=1e-6)
    assert tp.buckets == [8] and tp.compiles == 1
