"""The port's `Checkpoint` against the JAX package's, on the CPU.

A numpy tree goes through both packages' `from_arrays` / `to_arrays` and
comes back with equal leaves, dtypes and structure. The port's own format
(leaves in `arrays.npz`, the structure in `tree.json`) round-trips a bf16
`TrainState` bit for bit, its `AdamWState` and step included, and training
resumed from a checkpoint after one AdamW step takes the same two steps as
uninterrupted training: the losses and the parameters are identical. A
DTensor leaf is saved whole: `tests/test_torch_mesh_sharding.py`'s gang
holds that.
"""

import dataclasses
from functools import partial

import jax
import numpy as np
import pytest
import torch

from ray_tpu.train.checkpoint import Checkpoint as JaxCheckpoint
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import (AdamWState, TrainState, adamw,
                                 init_train_state, make_train_step)
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.optim import tree_leaves

VOCAB = 128


def _numpy_tree():
    r = np.random.default_rng(0)
    return {"w": r.standard_normal((3, 4)).astype(np.float32),
            "layers": [{"b": r.integers(0, 9, 5)},
                       (r.random(3) > 0.5, np.float16(1.5))],
            "count": np.asarray(7, np.int32)}


def test_numpy_tree_round_trips_as_on_jax(tmp_path):
    tree = _numpy_tree()
    want = JaxCheckpoint.from_arrays(tree, str(tmp_path / "jax")).to_arrays()
    got = Checkpoint.from_arrays(tree, str(tmp_path / "port")).to_arrays()
    wl, wdef = jax.tree_util.tree_flatten(want)
    gl, gdef = jax.tree_util.tree_flatten(got)
    assert gdef == wdef
    for g, w in zip(gl, wl):
        assert isinstance(g, np.ndarray)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _config(dtype):
    return dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=dtype)


def _state(cfg, seed, opt):
    return init_train_state(
        lambda dev: tl.init(cfg, torch.Generator().manual_seed(seed), dev),
        opt, device="cpu")


def _tokens(i):
    return {"tokens": torch.from_numpy(
        np.random.default_rng(10 + i).integers(0, VOCAB, (2, 33)))}


def _state_leaves(s):
    return tree_leaves([s.params, s.opt_state.mu, s.opt_state.nu, s.step])


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_states_identical(got, want):
    assert type(got) is TrainState and type(got.opt_state) is AdamWState
    assert got.opt_state.count == want.opt_state.count
    gl, wl = _state_leaves(got), _state_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g.cpu()), _bits(w.cpu()))


def _load_into(state, restored):
    """Copy a restored tree's tensors into a live state's (on its device)."""
    with torch.no_grad():
        for dst, src in zip(_state_leaves(state), _state_leaves(restored)):
            dst.copy_(src)
    state.opt_state.count = restored.opt_state.count


def test_bf16_train_state_round_trips_bit_for_bit(tmp_path):
    cfg = _config(torch.bfloat16)
    opt = adamw(1e-3, weight_decay=1e-4)
    state = _state(cfg, 0, opt)
    step = make_train_step(partial(tl.loss_fn, config=cfg), opt,
                           compiled=False)
    state, _ = step(state, _tokens(0))
    assert state.opt_state.mu["lm_head"].dtype == torch.bfloat16
    back = Checkpoint.from_arrays(state, str(tmp_path)).to_arrays()
    _assert_states_identical(back, state)
    assert back.step.shape == () and back.step.dtype == torch.int32
    assert (tmp_path / "arrays.npz").exists()
    assert (tmp_path / "tree.json").exists()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resumed_training_equals_uninterrupted(tmp_path, dtype):
    """Three AdamW steps, and one step, a checkpoint, a fresh state (from
    another seed) restored from it and two more steps: identical."""
    cfg = _config(dtype)
    opt = adamw(1e-3, weight_decay=1e-4)
    step = make_train_step(partial(tl.loss_fn, config=cfg), opt,
                           compiled=False)
    state = _state(cfg, 0, opt)
    losses = []
    for i in range(3):
        state, m = step(state, _tokens(i))
        losses.append(float(m["loss"]))
        if i == 0:
            ckpt = Checkpoint.from_arrays(state, str(tmp_path))
    resumed = _state(cfg, 1, opt)
    _load_into(resumed, ckpt.to_arrays())
    for i in (1, 2):
        resumed, m = step(resumed, _tokens(i))
        assert float(m["loss"]) == losses[i]
    assert int(resumed.step) == 3
    _assert_states_identical(resumed, state)


def test_checkpoint_directory_api_follows_jax(tmp_path):
    ck = Checkpoint.from_dict({"a": 1, "b": [2, 3]})
    assert ck.to_dict() == {"a": 1, "b": [2, 3]}
    ck.update_metadata({"epoch": 4})
    assert ck.get_metadata() == {"epoch": 4}
    dest = ck.to_directory(str(tmp_path / "copy"))
    assert Checkpoint.from_directory(dest).to_dict() == {"a": 1, "b": [2, 3]}
    assert Checkpoint(dest) == Checkpoint.from_directory(dest)
    with ck.as_directory() as d:
        assert d == ck.path
    for name in ("from_directory", "as_directory", "to_directory",
                 "from_dict", "to_dict", "update_metadata", "get_metadata",
                 "from_arrays", "to_arrays"):
        assert hasattr(JaxCheckpoint, name) and hasattr(Checkpoint, name)


def test_checkpoint_refuses_what_it_cannot_restore(tmp_path):
    with pytest.raises(TypeError, match="neither a tensor"):
        Checkpoint.from_arrays({"f": object()}, str(tmp_path / "a"))
    with pytest.raises(TypeError, match="must be strings"):
        Checkpoint.from_arrays({1: np.zeros(2)}, str(tmp_path / "b"))
    # a JAX checkpoint (a pickled treedef) is not the port's format
    JaxCheckpoint.from_arrays(_numpy_tree(), str(tmp_path / "jax"))
    with pytest.raises(FileNotFoundError):
        Checkpoint(str(tmp_path / "jax")).to_arrays()


def test_chip_smoke_phase_o_rehearsed_on_the_cpu(monkeypatch, capsys,
                                                 tmp_path, request):
    """`chip_smoke.py --only o` with the card stubbed (as
    tests/test_torch_flash_sm90.py rehearses main()) and the kernels'
    plain versions: (o-1) at the tiny train config compiled on aot_eager
    (2L / L / L launches over its 6 steps), (o-2) over a tiny ViT at
    (o-2)'s batches with one compile per bucket, (o-3) the batch predictor
    over the tiny ViT's checkpoint, 24 rows in batches of 8; the last line
    is the ok object."""
    import json

    from ray_tpu_torch.models import vit

    from test_torch_flash_sm90 import rehearse_on_the_cpu

    torch._dynamo.reset()
    request.addfinalizer(torch._dynamo.reset)
    smoke = rehearse_on_the_cpu(monkeypatch, tmp_path, request)
    monkeypatch.setattr(smoke, "bench_config", smoke.tiny_train_config)
    monkeypatch.setattr(smoke, "TRAIN_ATTN", (2, 64, 64, 4, 2, 32, True))
    monkeypatch.setattr(vit.ViTConfig, "base_16",
                        staticmethod(vit.ViTConfig.tiny))
    monkeypatch.setattr(smoke, "BATCH_PREDICT_ROWS", 24)
    monkeypatch.setattr(smoke, "BATCH_PREDICT_SIZE", 8)
    assert smoke.main(["--only", "o"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    for tag in ("[o-1]", "[o-2]", "[o-3]", "[o]"):
        assert any(line.startswith(tag) for line in lines), tag
    assert lines[-3] == "NVIDIA H100 80GB HBM3, 700.00 W"
    out = json.loads(lines[-2])
    # six steps (four uninterrupted, two resumed) at one layer
    assert out["checkpoint_launches"] == {"flash_fwd": 12, "flash_bwd_dq": 6,
                                          "flash_bwd_dkv": 6}
    assert out["predictor"]["compiles"] == 4
    assert sorted(out["predictor"]["buckets"]) == [1, 4, 32, 64]
    # (o-3): 24 rows in batches of 8, one load, one compile (bucket 8)
    assert {k: out["predictor"]["batch_predictor"][k] for k in (
        "rows", "batch_size", "loads", "compiles")} == {
        "rows": 24, "batch_size": 8, "loads": 1, "compiles": 1}
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
