"""Train's backend in the port (`ray_tpu_torch.train.TorchConfig`,
`TorchBackend`) under the runtime's own `DataParallelTrainer`, on the CPU.

The port's config is the trainer's `backend_config`. With
`TorchConfig(device="cpu", distributed=True, mesh_config=MeshConfig(dp=2,
tp=2))` four runtime workers become one gloo gang and build the dp=2 x
tp=2 mesh through a collective group; each reads the rows of its data
position of a `ray_tpu.data.from_items` dataset (`split_by_data_position`)
through the per-position feed (`iter_device_batches(local_rows=True)`)
and takes four AdamW steps of the tiny fp32 Llama from the JAX init's
weights. Every rank reports the same mesh, each position reads exactly
`split_shard(position, 2)`, the tp peers of a position read the same rows,
and the losses are within 1e-5 of `ray_tpu.train.step` on a 4-device CPU
submesh fed the same global batches. The same run with every rank raising
once (on a marker file, after the report that follows its step-2
checkpoint) is restarted by `FailureConfig(max_failures=1)` from the
port's `Checkpoint` placed back on the mesh (`place_like`): every step
reported, the re-reported step within 1e-4 of its first report, the whole
trajectory within 1e-5 of JAX's. JAX's config refusal, a gloo gang without
a mesh and the default device (the card) on a host without CUDA.

The train functions call `ray_tpu.train.report` and `get_checkpoint`, so
they belong to the user: the factories here build them as nested defs,
which travel to the workers by value.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

import ray_tpu as rt
from ray_tpu import data
from ray_tpu.air import FailureConfig, RunConfig, ScalingConfig
from ray_tpu.models import llama as jl
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel.sharding import LogicalAxisRules, logical_sharding
from ray_tpu.train import DataParallelTrainer
from ray_tpu.train.backend import JaxBackend, JaxConfig
from ray_tpu.train.step import init_train_state as jax_init_train_state
from ray_tpu.train.step import make_train_step as jax_make_train_step
from ray_tpu_torch.parallel.mesh import MeshConfig
from ray_tpu_torch.train import TorchBackend, TorchConfig
from ray_tpu_torch.util.collective import CollectiveGroupError

WORLD = 4
MESH = dict(dp=2, tp=2)
POSITIONS = 2
ROWS = 2          # rows a data position feeds a step
STEPS = 4
SEQ = 64
VOCAB = 128
LR = 1e-3
LOSS_RTOL = 1e-5  # fp32 on both sides, sums in another order
LOSS_ATOL = 1e-4  # a re-reported step (tests/test_spmd_trainer.py:40)


def _jcfg():
    return dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=VOCAB),
                               dtype=jnp.float32)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(5).integers(
        0, VOCAB, (STEPS * POSITIONS * ROWS, SEQ + 1))


@pytest.fixture(scope="module")
def cluster():
    # Four workers, and room for the read tasks each one's dataset shard
    # runs while a restarted gang's placement group is still being freed.
    rt.init(num_cpus=12)
    yield
    rt.shutdown()


@pytest.fixture(scope="module")
def dataset(cluster, tokens):
    # one block a data position
    return data.from_items([{"tokens": t} for t in tokens],
                           override_num_blocks=POSITIONS)


@pytest.fixture(scope="module")
def position_rows(dataset):
    """Each data position's rows, as `split_shard` gives them."""
    return [np.concatenate([b["tokens"] for b in dataset.split_shard(
        p, POSITIONS).iter_batches(batch_size=ROWS, batch_format="numpy")])
        for p in range(POSITIONS)]


@pytest.fixture(scope="module")
def jax_run(position_rows):
    """JAX's sharded init and STEPS steps of optax.adamw(LR) on dp=2 x tp=2
    of 4 CPU devices, step i fed every position's i-th rows in position
    order: -> (initial weights, losses)."""
    cfg = _jcfg()
    sizes = jmesh.MeshConfig(**MESH).resolved(WORLD).axis_sizes()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(
        tuple(sizes[a] for a in jmesh.AXIS_ORDER)), jmesh.AXIS_ORDER)
    rules = LogicalAxisRules()
    opt = optax.adamw(LR)
    state, shardings = jax_init_train_state(
        functools.partial(jl.init, cfg), opt, jl.param_logical_axes(cfg),
        mesh, jax.random.PRNGKey(0), rules)
    init = jax.device_get(state.params)
    bs = logical_sharding(mesh, ("batch", "seq"), rules)
    step = jax_make_train_step(
        functools.partial(jl.loss_fn, config=cfg, mesh=mesh, rules=rules),
        opt, shardings, batch_sharding={"inputs": bs, "targets": bs})
    losses = []
    for i in range(STEPS):
        toks = np.concatenate([r[i * ROWS:(i + 1) * ROWS]
                               for r in position_rows])
        state, m = step(state, {"inputs": jax.device_put(toks[:, :-1], bs),
                                "targets": jax.device_put(toks[:, 1:], bs)})
        losses.append(float(m["loss"]))
    return init, losses


def _make_train_fn():
    """The user's train function: the tiny fp32 Llama on the gang's mesh
    from the given weights, restored from the runtime's checkpoint when
    there is one, fed its data position's rows; each rank writes what it
    was fed to config["out"], reports each step, and a checkpoint every
    second step; with config["fail"], every rank raises once after the
    report of step 2."""

    def train_fn(config):
        import dataclasses
        import functools
        import itertools
        import json
        import os

        import torch

        from ray_tpu import train as rt_train
        from ray_tpu_torch.data import (iter_device_batches,
                                        split_by_data_position)
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models.convert import params_from_jax_numpy
        from ray_tpu_torch.parallel.mesh import mesh_sizes
        from ray_tpu_torch.train import (Checkpoint, adamw, get_mesh,
                                         host_tree, init_train_state,
                                         make_train_step, place_like)
        from ray_tpu_torch.train.spmd import batch_sharding, data_position

        torch.set_num_threads(1)
        mesh = get_mesh()
        rank = torch.distributed.get_rank()
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(
            vocab_size=config["vocab"]), dtype=torch.float32)
        opt = adamw(config["lr"], weight_decay=1e-4)  # optax.adamw's
        state = init_train_state(
            lambda dev: params_from_jax_numpy(config["params"], cfg, dev),
            opt, device="cpu", param_logical_axes=llama.param_logical_axes(
                cfg), mesh=mesh)
        start = 0
        ckpt = rt_train.get_checkpoint()
        if ckpt is not None:
            host = Checkpoint.from_directory(ckpt.path).to_arrays()
            start = int(host["step"])
            state = place_like(host["state"], state)
        step = make_train_step(functools.partial(
            llama.loss_fn, config=cfg, mesh=mesh), opt, compiled=False)
        sharding = batch_sharding(mesh)
        rows = itertools.islice(split_by_data_position(
            config["data"], mesh).iter_batches(
                batch_size=config["rows"], batch_format="numpy"), start, None)
        feed = iter_device_batches(
            ({"inputs": r["tokens"][:, :-1], "targets": r["tokens"][:, 1:]}
             for r in rows), device="cpu", sharding=sharding, mesh=mesh,
            local_rows=True)
        for i, batch in zip(range(start, config["steps"]), feed):
            state, m = step(state, batch)
            with open(os.path.join(config["out"], f"rank{rank}.jsonl"),
                      "a") as f:
                f.write(json.dumps({
                    "step": i, "position": data_position(sharding, mesh),
                    "mesh": mesh_sizes(mesh),
                    "local": batch["inputs"].to_local().tolist(),
                    "global": batch["inputs"].full_tensor().tolist()}) + "\n")
            ck = None
            if (i + 1) % 2 == 0:
                ck = Checkpoint.from_arrays(
                    host_tree({"state": state, "step": i + 1}))
            rt_train.report({"loss": float(m["loss"]), "step": i},
                            checkpoint=ck)
            marker = os.path.join(config["out"], f"failed_rank{rank}")
            if config["fail"] and i == 2 and not os.path.exists(marker):
                open(marker, "w").close()
                raise RuntimeError(f"rank {rank} fails once after step {i}")

    return train_fn


def _fit(tmp_path, dataset, params, fail):
    out = tmp_path / "fed"
    out.mkdir()
    trainer = DataParallelTrainer(
        _make_train_fn(),
        train_loop_config={"vocab": VOCAB, "lr": LR, "params": params,
                           "data": dataset, "rows": ROWS, "steps": STEPS,
                           "out": str(out), "fail": fail},
        backend_config=TorchConfig(device="cpu", distributed=True,
                                   mesh_config=MeshConfig(**MESH)),
        scaling_config=ScalingConfig(num_workers=WORLD),
        run_config=RunConfig(storage_path=str(tmp_path / "runs"),
                             failure_config=FailureConfig(max_failures=1)))
    result = trainer.fit()
    assert result.error is None, result.error
    with open(os.path.join(result.path, "result.json")) as f:
        reports = [json.loads(line) for line in f]
    fed = {}
    for r in range(WORLD):
        with open(out / f"rank{r}.jsonl") as f:
            fed[r] = [json.loads(line) for line in f]
    return reports, fed


def _check_fed(fed, position_rows, tokens):
    for r, steps in fed.items():
        assert {json.dumps(s["mesh"]) for s in steps} == {json.dumps(
            {"pp": 1, "dp": 2, "fsdp": 1, "ep": 1, "sp": 1, "tp": 2})}
        pos, n = steps[0]["position"]
        assert n == POSITIONS and pos == r // 2  # tp peers share a position
        for s in steps:
            i = s["step"]
            mine = position_rows[pos][i * ROWS:(i + 1) * ROWS, :-1]
            assert np.array_equal(s["local"], mine), (r, i)
            assert np.array_equal(s["global"], np.concatenate([
                p[i * ROWS:(i + 1) * ROWS, :-1] for p in position_rows]))
    # every position's rows are split_shard's, and all of the data
    assert sorted(map(tuple, np.concatenate(position_rows))) == sorted(
        map(tuple, tokens))


def test_data_parallel_trainer_runs_the_port_gang_on_a_mesh(
        tmp_path, dataset, position_rows, tokens, jax_run):
    params, want = jax_run
    reports, fed = _fit(tmp_path, dataset, params, fail=False)
    assert [r["step"] for r in reports] == list(range(STEPS))
    _check_fed(fed, position_rows, tokens)
    for r in range(WORLD):
        assert [s["step"] for s in fed[r]] == list(range(STEPS))
    np.testing.assert_allclose([r["loss"] for r in reports], want,
                               rtol=LOSS_RTOL)


def test_a_restarted_gang_resumes_from_the_port_checkpoint(
        tmp_path, dataset, position_rows, tokens, jax_run):
    params, want = jax_run
    reports, fed = _fit(tmp_path, dataset, params, fail=True)
    steps = [r["step"] for r in reports]
    # steps 0-2, the failure, then from the step-2 checkpoint steps 2-3
    assert steps == [0, 1, 2, 2, 3]
    assert all((tmp_path / "fed" / f"failed_rank{r}").exists()
               for r in range(WORLD))
    _check_fed(fed, position_rows, tokens)
    first, again = reports[2]["loss"], reports[3]["loss"]
    assert abs(first - again) <= LOSS_ATOL
    merged = {r["step"]: r["loss"] for r in reports}
    np.testing.assert_allclose([merged[i] for i in range(STEPS)], want,
                               rtol=LOSS_RTOL)


def _make_allreduce_fn():
    def train_fn():
        import torch
        import torch.distributed as dist

        from ray_tpu import train as rt_train
        from ray_tpu_torch.train import get_mesh

        x = torch.tensor([float(dist.get_rank() + 1)])
        dist.all_reduce(x)
        rt_train.report({"sum": float(x), "backend": dist.get_backend(),
                         "mesh": get_mesh() is None})

    return train_fn


def test_a_gloo_gang_without_a_mesh_all_reduces(cluster, tmp_path):
    result = DataParallelTrainer(
        _make_allreduce_fn(),
        backend_config=TorchConfig(device="cpu", distributed=True),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    assert result.metrics["sum"] == 3.0
    assert result.metrics["backend"] == "gloo" and result.metrics["mesh"]


def test_the_default_device_is_the_card_and_raises_without_cuda(cluster,
                                                                tmp_path):
    trainer = DataParallelTrainer(
        _make_allreduce_fn(), backend_config=TorchConfig(distributed=True),
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(storage_path=str(tmp_path)))
    with pytest.raises(CollectiveGroupError, match="needs a CUDA card"):
        trainer.fit()


def test_mesh_mode_multiworker_requires_distributed():
    """JAX's refusal (tests/test_spmd_trainer.py::
    test_mesh_mode_multiworker_requires_distributed), in both packages."""

    class _Gang:
        num_workers = 2

    for backend, cfg in (
            (JaxBackend(), JaxConfig(distributed=False, mesh_config=(
                jmesh.MeshConfig(dp=2)))),
            (TorchBackend(), TorchConfig(distributed=False,
                                         mesh_config=MeshConfig(dp=2)))):
        with pytest.raises(ValueError, match="distributed=True") as err:
            backend.on_start(_Gang(), cfg)
        assert "2 workers 2 independent local meshes" in str(err.value)
    assert TorchConfig().backend_cls is TorchBackend
