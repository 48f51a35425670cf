"""The port's bench (`python -m ray_tpu_torch.bench`) and the train-loop
scopes of its device profiler, on the CPU.

The bench prints one JSON line of `bench.py`'s headline shape; without
CUDA it raises unless given --device cpu, and a CPU run reports no MFU and
no device memory. The profiler's step and phase scopes are held to the
reference's accounting (`tests/test_device_profiler.py`): phase totals and
fractions, compile seconds, MFU = flops_per_step / device_execute seconds
/ peak (one card).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ray_tpu_torch import bench
from ray_tpu_torch._private.device_profiler import (DeviceStepProfiler,
                                                    get_profiler)

ROOT = Path(__file__).resolve().parent.parent


def test_bench_on_the_cpu_prints_one_json_line():
    # One intra-op thread: the tiny model gains nothing from more, and test
    # workers share the cores.
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.bench", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert res["metric"] == "llama_train_tokens_per_sec_per_gpu"
    assert res["unit"] == "tokens/s/gpu" and res["value"] > 0
    det = res["detail"]
    assert (det["seq_len"], det["global_batch"]) == (bench.CPU_SEQ,
                                                     bench.CPU_BATCH)
    assert det["step_time_ms"] > 0 and det["compiled"] is True
    assert det["backend"] == "aot_eager" and det["remat_policy"] == "dots"
    # No device metric from a CPU run.
    assert det["platform"] == "cpu" and det["mfu"] is None
    assert det["peak_memory_bytes"] is None and det["nvidia_smi"] is None
    phases = det["train_step_phases"]
    assert phases["steps"] == 1 + bench.CPU_STEPS
    assert set(phases["phase_seconds"]) == {"compile", "input_wait", "h2d",
                                            "device_execute"}
    assert det["compile_s"] == phases["compile_s"] > 0


def test_bench_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_bench_config_is_the_jax_bench_proxy():
    cfg = bench.bench_config()
    assert (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_head, cfg.d_ff, cfg.loss_chunk_size) == (
        32_000, 4096, 5, 32, 8, 128, 14_336, 1024)
    assert cfg.dtype == torch.bfloat16 and cfg.remat_policy == "dots"
    assert (bench.BATCH, bench.SEQ, bench.STEPS) == (4, 2048, 20)


def test_step_scopes_account_phases():
    prof = DeviceStepProfiler("scopes", device="cpu")
    with prof.step(tokens=10) as sp:
        sp.external("input_wait", 0.4)
        with sp.phase("device_execute") as ph:
            assert ph.fence({"x": [torch.ones(2)]})["x"][0].sum() == 2
    with prof.step(tokens=20) as sp:
        sp.external("compile", 1.5)
    rep = prof.report()
    assert rep["steps"] == 2
    assert rep["phase_seconds"]["input_wait"] == pytest.approx(0.4)
    assert rep["compile_s"] == pytest.approx(1.5)
    assert rep["accounted_s"] == pytest.approx(
        sum(rep["phase_seconds"].values()), abs=1e-5)
    assert rep["compile_frac"] == pytest.approx(1.5 / rep["accounted_s"],
                                                abs=1e-3)
    assert [r["tokens"] for r in rep["recent_steps"]] == [10, 20]
    assert rep["mfu"] is None  # no flops given
    assert rep["hbm"] == {}  # no device memory on the CPU


def test_a_failed_step_records_nothing():
    prof = DeviceStepProfiler("failed", device="cpu")
    with pytest.raises(ValueError):
        with prof.step() as sp:
            with sp.phase("device_execute"):
                raise ValueError("step failed")
    assert prof.report()["steps"] == 0


def test_mfu_from_the_flops_of_a_step():
    prof = DeviceStepProfiler("mfu", device="cpu", flops_per_step=5e11,
                              peak_flops_per_chip=2e12)
    prof.record_step({"device_execute": 0.5})
    # 5e11 flops / 0.5 s / 2e12 flop/s = 0.5
    assert prof.report()["mfu"] == pytest.approx(0.5, rel=1e-6)
    # A step without device_execute (the compile step) leaves it as it was.
    prof.record_step({"compile": 3.0})
    rep = prof.report()
    assert rep["mfu"] == pytest.approx(0.5, rel=1e-6)
    assert [r["mfu"] for r in rep["recent_steps"]] == [
        pytest.approx(0.5), None]
    prof.reset()
    assert prof.report()["mfu"] is None


def test_train_profiler_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceStepProfiler("train", flops_per_step=1.0,
                           peak_flops_per_chip=1.0)
    assert get_profiler("train-cpu", device="cpu").device.type == "cpu"
