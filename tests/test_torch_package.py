"""Boundaries of the port package `ray_tpu_torch`.

It imports neither JAX nor anything of `ray_tpu` (it keeps its own copy of
what it needs), and its entry points run on CUDA unless the caller asks for
the CPU: without CUDA they raise instead of falling back.
"""

import ast
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch import device_info, resolve_device
from ray_tpu_torch._private.accelerators.nvidia import (
    bf16_peak_flops_per_device)
from ray_tpu_torch.inference import InferenceEngine
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import (adamw_state_from_jax_numpy,
                                          params_from_jax_numpy)
from ray_tpu_torch.train import adamw, init_train_state

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_ray_tpu(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "ray_tpu"), (
            f"{path.relative_to(ROOT)} imports {mod}")


def test_importing_the_port_loads_no_jax():
    # Only what the port's import adds counts: a site hook may load
    # modules into every interpreter.
    code = ("import sys; before = set(sys.modules); "
            "import ray_tpu_torch, ray_tpu_torch.inference, "
            "ray_tpu_torch.models.llama, ray_tpu_torch.models.convert, "
            "ray_tpu_torch.ops.flash_attention, ray_tpu_torch.ops._build, "
            "ray_tpu_torch.train, ray_tpu_torch._private.accelerators.nvidia, "
            "ray_tpu_torch.inference.paged_engine, "
            "ray_tpu_torch.inference.benchmarks, "
            "ray_tpu_torch._private.kv_registry, "
            "ray_tpu_torch._private.device_profiler, ray_tpu_torch.bench, "
            "ray_tpu_torch.graft_entry, ray_tpu_torch.parallel.moe, "
            "ray_tpu_torch.models.mixtral, ray_tpu_torch.models.vit, "
            "ray_tpu_torch.models.t5, ray_tpu_torch.models.mlp, "
            "ray_tpu_torch.parallel.mesh, ray_tpu_torch.parallel.sharding, "
            "ray_tpu_torch.parallel.ring_attention, "
            "ray_tpu_torch.parallel.pipeline, "
            "ray_tpu_torch.parallel.gang_cases, ray_tpu_torch.train.backend, "
            "ray_tpu_torch.parallel.train_gang_cases, "
            "ray_tpu_torch._private.pinned_pages, ray_tpu_torch._private.gang, "
            "ray_tpu_torch.train.checkpoint, "
            "ray_tpu_torch.train.spmd, ray_tpu_torch.train.spmd_bench, "
            "ray_tpu_torch._private.backend_probe, ray_tpu_torch.rllib, "
            "ray_tpu_torch.rllib.rl_module, ray_tpu_torch.rllib.convert, "
            "ray_tpu_torch.rllib.envs, ray_tpu_torch.rllib.learner, "
            "ray_tpu_torch.rllib.env_runner, ray_tpu_torch.rllib.catalog, "
            "ray_tpu_torch.rllib.exploration, ray_tpu_torch.rllib.callbacks, "
            "ray_tpu_torch.rllib.offline, ray_tpu_torch.rllib.algorithms, "
            "ray_tpu_torch.rllib.algorithms.registry, "
            "ray_tpu_torch.rllib.benchmarks, "
            "ray_tpu_torch.rllib.remote_cases, ray_tpu_torch._private.actors, "
            "ray_tpu_torch.rllib.dataflow, ray_tpu_torch.dag, "
            "ray_tpu_torch.rllib.dataflow_cases, "
            "ray_tpu_torch._private.serialization, "
            "ray_tpu_torch._private.dataplane_bench, ray_tpu_torch.data, "
            "ray_tpu_torch.data.dataset, ray_tpu_torch.util, "
            "ray_tpu_torch.util.collective, "
            "ray_tpu_torch.util.collective.collective, "
            "ray_tpu_torch.parallel.hlo_report, "
            "ray_tpu_torch.api, ray_tpu_torch.actor, "
            "ray_tpu_torch.remote_function, ray_tpu_torch.runtime_context, "
            "ray_tpu_torch._raylet, ray_tpu_torch.exceptions, "
            "ray_tpu_torch.util.placement_group, "
            "ray_tpu_torch.util.scheduling_strategies, "
            "ray_tpu_torch.util.profiling, "
            "ray_tpu_torch.gcs.server, "
            "ray_tpu_torch.raylet.raylet, ray_tpu_torch.raylet.worker_pool, "
            "ray_tpu_torch.raylet.memory_monitor, "
            "ray_tpu_torch.raylet.external_storage, "
            "ray_tpu_torch.worker.core_worker, "
            "ray_tpu_torch.worker.executor, "
            "ray_tpu_torch.worker.plasma_provider, "
            "ray_tpu_torch._private.shm_store, ray_tpu_torch._native, "
            "ray_tpu_torch._private.rpc, ray_tpu_torch._private.latency, "
            "ray_tpu_torch._private.spawn_diag, "
            "ray_tpu_torch._private.workers.default_worker, "
            "ray_tpu_torch._private.workers.zygote, ray_tpu_torch.health, "
            "ray_tpu_torch.serve, ray_tpu_torch.serve.llm, "
            "ray_tpu_torch.serve.schema, ray_tpu_torch.serve.benchmarks, "
            "ray_tpu_torch.serve._private.controller, "
            "ray_tpu_torch.serve._private.proxy, "
            "ray_tpu_torch.experimental.internal_kv, "
            "ray_tpu_torch._private.event_watch; "
            "print(sorted(m for m in set(sys.modules) - before "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.tiny(vocab_size=64)
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 device_info,
                 lambda: llama.init(cfg, torch.Generator()),
                 lambda: llama.init_kv_cache(cfg, 1, 8),
                 lambda: params_from_jax_numpy({}, cfg),
                 lambda: adamw_state_from_jax_numpy(types.SimpleNamespace(
                     count=0, mu={}, nu={}), cfg),
                 lambda: init_train_state(lambda dev: {}, adamw(1e-3))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    params = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert params["embed"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(params, cfg)
    eng = InferenceEngine(params, cfg, max_batch=1, max_len=16, device="cpu")
    assert eng.cache["k"].device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_paged_serving_entry_points_need_cuda_unless_asked_for_cpu(
        monkeypatch):
    from ray_tpu_torch._private.device_profiler import (DeviceStepProfiler,
                                                        get_profiler)
    from ray_tpu_torch.inference.benchmarks import benchmark_engine
    from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.tiny(vocab_size=64)
    params = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for call in (lambda: PagedInferenceEngine(params, cfg),
                 lambda: llama.init_paged_kv_cache(cfg, 3, 8),
                 lambda: benchmark_engine(cfg),
                 lambda: get_profiler("decode"),
                 lambda: DeviceStepProfiler("decode")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    eng = PagedInferenceEngine(params, cfg, max_batch=1, max_len=16,
                               block_size=8, device="cpu")
    assert eng.pool["k"].device.type == "cpu"
    assert eng.profiler.report()["hbm"] == {}  # no device memory on the CPU
    params["lm_head"] = params["lm_head"].to("meta")
    with pytest.raises(ValueError, match="meta"):
        PagedInferenceEngine(params, cfg, device="cpu")


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12)])
def test_peak_table_knows_the_h100_parts(name, peak):
    assert bf16_peak_flops_per_device(name) == peak


def test_peak_table_refuses_a_card_it_does_not_know():
    """A wrong peak would give a wrong MFU without a word, so an unknown
    card raises where the TPU table falls back to a default."""
    for name in ("NVIDIA A100-SXM4-80GB", "NVIDIA H200", "cpu"):
        with pytest.raises(ValueError, match="no peak rates"):
            bf16_peak_flops_per_device(name)


def test_model_zoo_entry_points_need_cuda_unless_asked_for_cpu(
        monkeypatch):
    from ray_tpu_torch.models import mixtral, mlp, t5, vit

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module, cfg in ((mixtral, mixtral.MixtralConfig.tiny(64)),
                        (vit, vit.ViTConfig.tiny()), (t5, t5.T5Config.tiny()),
                        (mlp, mlp.MLPConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.init(cfg, torch.Generator())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params_from_jax_numpy({}, cfg)
        params = module.init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        assert {t.device.type for t in _leaves(params)} == {"cpu"}


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def test_params_from_numpy_go_where_asked():
    cfg = llama.LlamaConfig.tiny(vocab_size=64)
    rng = np.random.default_rng(0)
    shapes = llama.param_shapes(cfg)
    tree = {name: ({n: rng.standard_normal(s).astype(np.float32)
                    for n, s in shape.items()} if name == "layers"
                   else rng.standard_normal(shape).astype(np.float32))
            for name, shape in shapes.items()}
    p = params_from_jax_numpy(tree, cfg, device="cpu")
    assert p["layers"]["w_up"].dtype == torch.bfloat16
    assert p["lm_head"].shape == shapes["lm_head"]


def test_engine_refuses_params_on_another_device():
    cfg = llama.LlamaConfig.tiny(vocab_size=64)
    params = llama.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    params["lm_head"] = params["lm_head"].to("meta")
    with pytest.raises(ValueError, match="meta"):
        InferenceEngine(params, cfg, device="cpu")


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    """Here there is no CUDA; alone in a directory it also lacks the port.
    Either way it exits non-zero with nothing on stdout's last line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, PYTHONPATH="")
    for cwd in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
