"""Typed tensors through the runtime's shm object store, on the CPU.

`ray_tpu_torch._private.dataplane_bench.run(device="cpu", runtime=api)`
runs the store-path bench on `ray_tpu.init` with the JAX bench's method
(64 MiB values put by the driver, read by a same-node worker whose cached
value is dropped before every read, the feed's overlap from the runtime's
Dataset) and is held against the JAX bench's own `main()` run beside it:
the same figures under the same keys (`jax` -> the tensor kinds), the CPU
tensor's put within JAX's 1.2x of numpy's, each the least of JAX's 5
rounds, no payload flattened, every value read back exact. Both benches
run in a process of their own, so that their feeds leave nothing in this
process's profiler families. A worker's get of a CPU tensor from the arena
is a view of the arena's pages, counted as a typed get and never as a
pageable one; `pinned_pages` finds the arena's mapping (a shared memfd)
and would register the windows of it that an object spans, once, where a
private buffer is left alone (registration stubbed: there is no card
here).
"""

import json
import mmap
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest
import torch

import ray_tpu as rt
from ray_tpu_torch._private import dataplane_bench
from ray_tpu_torch._private import pinned_pages
from ray_tpu_torch._private import serialization as ser

# JAX's key -> the port's, where the port's values are tensors.
TENSOR_KEYS = {"jax_put_slowdown_vs_numpy": "cpu_tensor_put_slowdown_vs_numpy",
               "typed_array_puts": "typed_tensor_puts"}
SLOWDOWN_LIMIT = 1.2  # ray_tpu/_private/dataplane_bench.py:10


def _drop_cached():
    """`drop_cached(ref)` for the bench's reader, by value: it runs in the
    worker, which cannot import this module."""

    def drop(ref):
        from ray_tpu._raylet import get_core_worker

        get_core_worker().memory_store.delete([ref.object_id()])

    return drop


def _runtime_api():
    from ray_tpu import data

    return types.SimpleNamespace(
        put=rt.put, get=rt.get, remote=rt.remote, drop_cached=_drop_cached(),
        dataset=data.range(dataplane_bench.OVERLAP_ROWS).map_batches(
            dataplane_bench.overlap_columns, batch_size=512))


def run_both_benches() -> None:
    """JAX's bench (it starts and stops its own runtime), then the port's
    on a fresh `ray_tpu.init`; prints [JAX's detail, the port's result]
    as the last line."""
    import contextlib
    import io

    from ray_tpu._private import dataplane_bench as jax_bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_bench.main() == 0
    jax_detail = json.loads(out.getvalue().strip().splitlines()[-1])["detail"]
    rt.init(num_cpus=2)
    try:
        port = dataplane_bench.run("cpu", runtime=_runtime_api())
    finally:
        rt.shutdown()
    print(json.dumps([jax_detail, port]))


@pytest.fixture(scope="module")
def figures():
    """-> (JAX's detail, the port's result), from `run_both_benches` in a
    process of its own."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-c", "import test_torch_store as t; "
         "t.run_both_benches()"],
        cwd=here, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [here, os.path.dirname(here), os.environ.get("PYTHONPATH", "")])})
    assert out.returncode == 0, out.stderr[-4000:]
    jax_detail, port = json.loads(out.stdout.strip().splitlines()[-1])
    return jax_detail, port


def test_the_store_bench_reports_jax_figures_under_the_same_keys(figures):
    jax_detail, port = figures
    d = port["detail"]
    assert port["metric"] == "object_put_gbps_tensor" and port["unit"] == "GB/s"
    assert port["value"] == d["object_put_gbps"]["cpu_tensor"] > 0
    want = {TENSOR_KEYS.get(k, k) for k in jax_detail}
    assert want <= set(d), want - set(d)
    for key in ("object_put_gbps", "object_get_gbps"):
        assert set(jax_detail[key]) == {"numpy", "jax"}
        assert set(d[key]) == {"numpy", "cpu_tensor"}
        assert all(v > 0 for v in d[key].values())
    assert d["payload_bytes"] == jax_detail["payload_bytes"]
    assert 0.0 <= d["input_pipeline_overlap_frac"] <= 1.0
    assert d["ingest_producer_busy_s"] > 0


def test_a_cpu_tensor_put_is_within_jax_criterion_of_numpy(figures):
    _, port = figures
    d = port["detail"]
    assert d["cpu_tensor_put_slowdown_vs_numpy"] <= SLOWDOWN_LIMIT, d
    assert d["typed_tensor_puts"] == dataplane_bench.PUT_ITERS == 5
    assert d["driver_payload_flattens"] == 0


def test_every_value_read_back_through_the_store_is_exact(figures):
    # run() raises if a value read back differs; the worker's reads were
    # typed and none took the pageable route.
    _, port = figures
    stats = port["detail"]["worker_copy_stats"]
    assert stats["typed_tensor_get"] >= dataplane_bench.GET_ITERS
    assert stats["typed_tensor_get_pageable"] == 0
    assert stats["payload_flatten"] == 0


@pytest.fixture
def runtime():
    rt.init(num_cpus=2)
    ser.install_tensor_wire()
    yield
    rt.shutdown()
    ser.uninstall_tensor_wire()


def test_a_cpu_get_from_the_arena_is_a_view_counted_as_typed(runtime):
    t = torch.arange(1 << 18, dtype=torch.float32)  # 1 MiB: in the arena
    ref = rt.put(t)

    @rt.remote
    def read(refs):
        from ray_tpu_torch._private import pinned_pages as pp
        from ray_tpu_torch._private import serialization as s

        before = dict(s.COPY_STATS)
        x = rt.get(refs[0])
        m = pp.mapping_of(x.data_ptr(), x.nbytes)
        after = dict(s.COPY_STATS)
        return ({k: after[k] - before[k] for k in after}, m,
                pp.registrable(m), x.clone())

    counts, m, registrable, got = rt.get(read.remote([ref]), timeout=120)
    assert torch.equal(got, t)
    assert counts == {"payload_flatten": 0, "typed_tensor_put": 0,
                      "typed_tensor_get": 1, "typed_tensor_get_pageable": 0}
    assert m.shared and m.path.startswith("/memfd:") and registrable


def test_pin_range_registers_the_arena_window_once_and_no_private_memory(
        runtime):
    ref = rt.put(np.arange(1 << 17, dtype=np.int64))

    @rt.remote
    def pin(refs):
        import numpy as np

        from ray_tpu_torch._private import pinned_pages as pp

        calls = []
        pp._register = lambda start, size, writable: calls.append(
            ("register", start, size, writable))
        pp._unregister = lambda start: calls.append(("unregister", start))
        x = rt.get(refs[0])  # a view of the arena
        arena = pp.mapping_of(x.ctypes.data, x.nbytes)
        private = np.zeros(1 << 16)
        out = [pp.pin_range(x.ctypes.data, x.nbytes),
               pp.pin_range(x.ctypes.data + 8, 8),
               pp.pin_range(private.ctypes.data, private.nbytes),
               pp.pinned_windows()]
        out += [pp.unpin_mapping(x.ctypes.data), pp.pinned_windows()]
        return arena, x.ctypes.data, x.nbytes, out, calls

    arena, addr, nbytes, out, calls = rt.get(pin.remote([ref]), timeout=120)
    w = pinned_pages.WINDOW_BYTES
    start = arena.start + (addr - arena.start) // w * w
    end = min(start + w, arena.end)
    assert addr + nbytes <= end  # 1 MiB at the arena's start: one window
    assert out == [[(addr, addr + nbytes)], [(addr + 8, addr + 16)], None,
                   [(start, end, True)], True, []]
    assert calls == [("register", start, end - start, True),
                     ("unregister", start)]
    assert arena.shared and arena.path.startswith("/memfd:")
    assert arena.end - arena.start > w  # the arena is not registered whole


def _shared_pages(size):
    """A read-only shared mapping of a `size`-byte memfd, and a float32
    view of it."""
    fd = os.memfd_create("test_torch_store")
    try:
        os.ftruncate(fd, size)
        reader = mmap.mmap(fd, size, prot=mmap.PROT_READ)
    finally:
        os.close(fd)
    return reader, np.frombuffer(reader, dtype=np.float32)


@pytest.fixture
def stubbed_registration(monkeypatch):
    """CUDA's registration and pinned copy stubbed, windows of 1 MiB: ->
    (registrations, pinned copies as (src, spans))."""
    calls, copies = [], []
    monkeypatch.setattr(pinned_pages, "WINDOW_BYTES", 1 << 20)
    monkeypatch.setattr(pinned_pages, "_register", lambda *a: calls.append(a))
    monkeypatch.setattr(pinned_pages, "_unregister",
                        lambda start: calls.append(("unregister", start)))
    monkeypatch.setattr(pinned_pages, "copy_pinned",
                        lambda dst, src, spans=None:
                        copies.append((src, spans)) or dst)
    yield calls, copies
    # the registry of this process forgets the stubbed registrations
    pinned_pages._starts.clear()
    pinned_pages._mappings.clear()
    pinned_pages._windows.clear()


def test_pin_range_splits_a_buffer_at_its_mapping_s_window_edges(
        stubbed_registration):
    calls, _ = stubbed_registration
    reader, view = _shared_pages(3 << 20)
    base = view.ctypes.data
    mib = 1 << 20
    assert pinned_pages.pin_range(base + mib - 8, mib + 16) == [
        (base + mib - 8, base + mib), (base + mib, base + 2 * mib),
        (base + 2 * mib, base + 2 * mib + 8)]
    assert calls == [(base, mib, False), (base + mib, mib, False),
                     (base + 2 * mib, mib, False)]
    # a window is registered once; the whole mapping is never read again
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pinned_pages, "mapping_of", lambda *a: 1 / 0)
        assert pinned_pages.pin_range(base + 5, 4) == [(base + 5, base + 9)]
    assert len(calls) == 3
    assert pinned_pages.unpin_mapping(base + 1)
    assert calls[3:] == [("unregister", base + w * mib)
                         for w in range(3)]
    del view
    reader.close()


def test_a_card_get_takes_the_pinned_route_from_shared_pages_only(
        stubbed_registration, monkeypatch):
    """`_to_card`'s routes, to the meta device (no card here), CUDA's
    registration and pinned copy stubbed: a view of a read-only shared
    mapping registers the windows it spans, once, and copies pinned,
    split at their edges; a pinned buffer copies pinned; private memory
    takes the pageable route, counted, and a bytes or bytearray buffer
    does so without a look at the process's mappings; an empty tensor
    copies nothing."""
    calls, copies = stubbed_registration
    meta = torch.device("meta")
    reader, view = _shared_pages(2 << 20)
    base = view.ctypes.data
    mib = 1 << 20
    pageable = ser.COPY_STATS["typed_tensor_get_pageable"]
    for part in (view[:256], view[1024:4096], view[mib // 4 - 8:]):
        with warnings.catch_warnings():  # read-only pages
            warnings.simplefilter("ignore", UserWarning)
            t = torch.from_numpy(part)
        out = ser._to_card(t, meta)
        assert out.device == meta and out.shape == t.shape
    assert calls == [(base, mib, False), (base + mib, mib, False)]
    assert [(c.data_ptr(), spans) for c, spans in copies] == [
        (base, [(base, base + 1024)]),
        (base + 4096, [(base + 4096, base + 4 * 4096)]),
        (base + mib - 32, [(base + mib - 32, base + mib),
                           (base + mib, base + 2 * mib)])]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.Tensor, "is_pinned", lambda self: True)
        one = torch.ones(3)
        ser._to_card(one, meta)
        # registered windows read as pinned: still copied window by window
        ser._to_card(t, meta)
    assert [(c.data_ptr(), spans) for c, spans in copies[3:]] == [
        (one.data_ptr(), [(one.data_ptr(), one.data_ptr() + 12)]),
        (base + mib - 32, [(base + mib - 32, base + mib),
                           (base + mib, base + 2 * mib)])]
    assert len(calls) == 2
    monkeypatch.setattr(pinned_pages, "copy_pinned",
                        lambda *a: pytest.fail("a pinned copy"))
    assert ser.COPY_STATS["typed_tensor_get_pageable"] == pageable
    out = ser._to_card(torch.ones(3), meta)
    assert out.device == meta
    assert ser.COPY_STATS["typed_tensor_get_pageable"] == pageable + 1
    monkeypatch.setattr(pinned_pages, "mapping_of",
                        lambda *a: pytest.fail("a look at the mappings"))
    # the frames as the wire reads them (views of views of the frame),
    # rebuilt for a card and copied to the meta device
    to_card = ser._to_card
    monkeypatch.setattr(ser, "_target_device",
                        lambda *a: torch.device("cuda", 0))
    monkeypatch.setattr(ser, "_to_card", lambda t, target, exporter=None:
                        to_card(t, meta, exporter))
    frame = ser.serialize(torch.arange(16.0)).to_bytes()
    for data in (frame, memoryview(bytearray(frame)).toreadonly()[0:]):
        got = ser.deserialize(ser.SerializedObject.from_bytes(data))
        assert got.device == meta and got.shape == (16,)
    assert ser.COPY_STATS["typed_tensor_get_pageable"] == pageable + 3
    assert ser._to_card(torch.ones(0, 5), meta).shape == (0, 5)
    assert ser.COPY_STATS["typed_tensor_get_pageable"] == pageable + 3


def test_chip_smoke_phase_t_rehearsed_on_the_cpu(monkeypatch, capsys,
                                                 tmp_path, request):
    """`chip_smoke.py --only t` with the card stubbed (as
    tests/test_torch_flash_sm90.py rehearses main()), at a small arena:
    (t-1) against a probe process that answers one H100, (t-2)'s round
    trips through the memfd arena (CPU views here, so its copies and
    their rates are the card's alone and stubbed), no pageable get, the
    mapping released; the last line is the ok object."""
    from test_torch_flash_sm90 import rehearse_on_the_cpu

    from ray_tpu_torch._private import backend_probe

    smoke = rehearse_on_the_cpu(monkeypatch, tmp_path, request)
    request.addfinalizer(ser.uninstall_tensor_wire)  # the gets install it
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(backend_probe, "_PROBE", (
        "import json; print(json.dumps([['NVIDIA H100 80GB HBM3', "
        "85000000000]]))"))
    monkeypatch.setattr(smoke, "STORE_ARENA_BYTES", 8 << 20)
    monkeypatch.setattr(smoke, "STORE_PAYLOAD_BYTES", 1 << 20)
    rated = []

    def store_rates(src, n, dev):
        rated.append((src.nbytes, n, dev))
        assert torch.equal(src[:8 * 4].view(torch.int64),
                           torch.arange(4))  # the put's bytes, in place
        return {"pageable": 8.0, "pinned_h2d": 50.0}

    monkeypatch.setattr(smoke, "store_rates", store_rates)
    pageable = ser.COPY_STATS["typed_tensor_get_pageable"]
    assert smoke.main(["--only", "t"]) == 0
    assert rated == [(1 << 20, 1 << 20, torch.device("cpu"))]
    assert ser.COPY_STATS["typed_tensor_get_pageable"] == pageable
    assert pinned_pages.pinned_windows() == []
    lines = capsys.readouterr().out.strip().splitlines()
    for text in ("[t-1] (NVIDIA H100 80GB HBM3, 700.00 W) node_advertisement"
                 "(): resources {'GPU': 1.0, 'GPU-H100-SXM': 1.0}",
                 "[t-2] (NVIDIA H100 80GB HBM3, 700.00 W) fp32, bf16, int64, "
                 "bool, empty and 0-d tensors through a 8 MiB memfd arena",
                 "0 pageable gets", "[t] the advertisement and the arena"):
        assert any(text in line for line in lines), text
    store = json.loads(lines[-2])["store"]
    assert store["advertisement"]["labels"] == {
        "ray_tpu_torch.io/accelerator-type": "H100 SXM"}
    assert store["gbps"]["pinned_h2d"] == 50.0 and store["gbps"]["put"] > 0
    assert lines[-3] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
