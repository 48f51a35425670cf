"""The port's device feed (`ray_tpu_torch.data.iter_device_batches`) against
the JAX package's `Dataset.iter_jax_batches`, on the CPU.

Over a `ray_tpu.data` Dataset the port's feed, given the Dataset's numpy
batches, yields the batches `iter_jax_batches` yields, at prefetch 0 and 1;
dtype casts, a producer error, an early close and the stats follow
`tests/test_dataplane.py`'s feed cases; each pull's wait goes to a step
scope as `input_wait`. The data-plane bench runs on the CPU, and
`chip_smoke.py --only n` is rehearsed at tiny sizes with the card stubbed.
The sharded feed runs in the gloo gang of tests/test_torch_mesh_sharding.py.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.data import iter_device_batches


@pytest.fixture(autouse=True)
def no_wire_after():
    """The bench and the rehearsal deserialize tensors, which installs the
    typed wire in this process: leave none installed for the next test."""
    yield
    from ray_tpu_torch._private.serialization import uninstall_tensor_wire

    uninstall_tensor_wire()


def _toy_dataset(rows=2048):
    from ray_tpu import data as rd

    def to_col(batch):
        k = len(batch["id"])
        base = np.asarray(batch["id"], dtype=np.float32).reshape(k, 1)
        return {"x": base + np.zeros((k, 32), dtype=np.float32)}

    return rd.range(rows).map_batches(to_col, batch_size=256)


def _feed_threads():
    return [t for t in threading.enumerate()
            if t.name == "rt-data-device-feed" and t.is_alive()]


@pytest.mark.parametrize("prefetch", [0, 1])
def test_feed_yields_the_batches_of_iter_jax_batches(ray_start_regular,
                                                     prefetch):
    ds = _toy_dataset()
    stats = {}
    want = list(ds.iter_jax_batches(batch_size=128, prefetch=prefetch))
    got = list(iter_device_batches(
        ds.iter_batches(batch_size=128, batch_format="numpy",
                        drop_last=True),
        device="cpu", prefetch=prefetch, stats=stats))
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"x"}
        assert g["x"].device.type == "cpu"
        np.testing.assert_array_equal(g["x"].numpy(), np.asarray(w["x"]))
    assert stats["batches"] == 16 and stats["produce_s"] >= 0
    assert 0.0 <= stats["overlap_frac"] <= 1.0
    if prefetch == 0:
        assert stats["overlap_frac"] == 0.0
        assert stats["wait_s"] == stats["produce_s"]


def _source(n=6):
    for i in range(n):
        yield {"x": np.full((4, 3), i, np.float32),
               "y": np.arange(4, dtype=np.int64) + i}


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_dtypes_cast_on_the_host_and_batches_are_owned(prefetch):
    src = list(_source())
    out = list(iter_device_batches(iter(src), device="cpu", prefetch=prefetch,
                                   dtypes={"y": np.int32}))
    assert [b["y"].dtype for b in out] == [torch.int32] * 6
    assert [b["x"].dtype for b in out] == [torch.float32] * 6
    for b, s in zip(out, src):
        np.testing.assert_array_equal(b["y"].numpy(), s["y"])
        b["x"] += 1  # a copy: the source is not written
        assert (s["x"] == s["x"][0, 0]).all()


def test_producer_error_is_raised_at_the_consumer():
    def bad():
        yield {"x": np.zeros(2)}
        raise RuntimeError("bad batch")

    it = iter_device_batches(bad(), device="cpu", prefetch=1)
    assert next(it)["x"].shape == (2,)
    with pytest.raises(RuntimeError, match="bad batch"):
        next(it)
    assert not _feed_threads()


def test_dataset_map_error_is_raised_at_the_consumer(ray_start_regular):
    from ray_tpu import data as rd

    def boom(batch):
        raise RuntimeError("bad batch")

    ds = rd.range(512).map_batches(boom, batch_size=256)
    with pytest.raises(Exception):
        list(iter_device_batches(ds.iter_batches(batch_size=128,
                                                 batch_format="numpy"),
                                 device="cpu"))


def test_early_close_stops_and_joins_the_producer():
    it = iter_device_batches(({"x": np.zeros(8)} for _ in range(10_000)),
                             device="cpu", prefetch=2)
    next(it)
    assert _feed_threads()
    it.close()
    deadline = time.time() + 10
    while _feed_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _feed_threads()


@pytest.mark.parametrize("prefetch", [0, 1])
def test_each_wait_goes_to_the_step_scope(prefetch):
    from ray_tpu_torch._private.device_profiler import DeviceStepProfiler

    def slow():
        for i in range(3):
            time.sleep(0.02)
            yield {"x": np.full(2, i)}

    prof = DeviceStepProfiler("feed-test", device="cpu")
    current = [None]
    stats = {}
    feed = iter_device_batches(slow(), device="cpu", prefetch=prefetch,
                               stats=stats, scope=lambda: current[0])
    for _ in range(3):
        with prof.step() as current[0]:
            next(feed)
    assert next(feed, None) is None
    rep = prof.report()
    assert rep["steps"] == 3
    waits = [s["phases"]["input_wait"] for s in rep["recent_steps"]]
    assert all(w > 0 for w in waits)
    assert sum(waits) <= stats["wait_s"] + 1e-9
    # a step scope given directly takes every wait of the feed
    prof.reset()
    with prof.step() as scope:
        list(iter_device_batches(slow(), device="cpu", prefetch=prefetch,
                                 scope=scope))
    assert prof.report()["phase_seconds"]["input_wait"] >= 0.04


def test_the_feed_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iter_device_batches(_source())
    from ray_tpu_torch._private import dataplane_bench

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dataplane_bench.run()


def test_dataplane_bench_on_the_cpu(capsys, monkeypatch):
    from ray_tpu_torch._private import dataplane_bench

    monkeypatch.setattr(dataplane_bench, "FEED_STEPS", 3)
    assert dataplane_bench.main(["--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    d = out["detail"]
    assert out["metric"] == "tensor_put_gbps" and d["device"] == "cpu"
    assert set(d["object_put_gbps"]) == {"numpy", "cpu_tensor"}
    assert "pinned_d2h_gbps" not in d  # no card, no card numbers
    assert d["typed_tensor_puts"] == 1 + dataplane_bench.PUT_ITERS
    assert d["payload_flattens"] == 0
    feed = d["feed"]
    assert feed["config"] == "tiny"
    assert feed["prefetch0"]["loss"] == feed["prefetch1"]["loss"]
    assert feed["prefetch0"]["overlap_frac"] == 0.0
    assert feed["prefetch1"]["batches"] == 4


def test_chip_smoke_phase_n_rehearsed_on_the_cpu(monkeypatch, capsys,
                                                 tmp_path, request):
    """`chip_smoke.py --only n` at tiny sizes with the card stubbed (as
    tests/test_torch_flash_sm90.py rehearses main()): every check of (n-1),
    (n-2) and (n-3) runs; the launches it reports are (n-1)'s fed runs,
    2L / L / L a step; the last line is the ok object."""
    import torch._dynamo

    from test_torch_flash_sm90 import rehearse_on_the_cpu

    from ray_tpu_torch._private import dataplane_bench

    torch._dynamo.reset()
    request.addfinalizer(torch._dynamo.reset)
    smoke = rehearse_on_the_cpu(monkeypatch, tmp_path, request)
    monkeypatch.setattr(smoke, "bench_config", smoke.tiny_train_config)
    monkeypatch.setattr(smoke, "TRAIN_ATTN", (2, 64, 64, 4, 2, 32, True))
    monkeypatch.setattr(smoke, "FEED_STEPS", 4)
    monkeypatch.setattr(smoke, "VIT_CUT", dict(
        image_size=32, patch_size=8, d_model=32, n_layers=2, n_heads=2,
        d_ff=64, num_classes=10))
    monkeypatch.setattr(smoke, "VIT_BATCH", 4)
    monkeypatch.setattr(smoke, "VIT_FEED_POOL", 8)
    monkeypatch.setattr(smoke, "RACE_BATCHES", 20)
    monkeypatch.setattr(smoke, "long_kernel", lambda: None)

    def profile_feed(fn):
        fn()
        return 10.0, 5.0, 1.0

    monkeypatch.setattr(smoke, "profile_feed", profile_feed)
    monkeypatch.setattr(dataplane_bench, "FEED_STEPS", 2)
    assert smoke.main(["--only", "n"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    for tag in ("[n-1]", "[n-2]", "[n-3]", "[n] the data plane",
                "[n] launches on the fed training path"):
        assert any(line.startswith(tag) for line in lines), tag
    for text in ("the first step's loss identical in all four runs",
                 "every yielded batch equals its source",
                 "stream race at prefetch 1", "stream race at prefetch 2",
                 "host-to-device copies", "one typed put and get each"):
        assert any(text in line for line in lines), text
    bench = next(json.loads(line) for line in lines
                 if line.startswith('{"metric": "tensor_put_gbps"'))
    assert bench["detail"]["device"] == "cpu"
    assert lines[-3] == "NVIDIA H100 80GB HBM3, 700.00 W"
    layers = smoke.tiny_train_config().n_layers
    steps = 2 * 4  # prefetch 1 and 0, FEED_STEPS each
    assert json.loads(lines[-2]) == {"feed_launches": {
        "flash_fwd": steps * 2 * layers, "flash_bwd_dq": steps * layers,
        "flash_bwd_dkv": steps * layers}}
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
