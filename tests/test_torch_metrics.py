"""The port's metrics and events against the JAX package's, on the CPU.

`ray_tpu_torch.util.metrics` renders the same Prometheus text as
`ray_tpu.util.metrics` for the same operations; the same recorded phases
through JAX's and the port's profilers give equal histogram buckets, MFU
gauges and `perf.phase_report` fields; JAX's and the port's tiny paged
engines under the same requests give equal `ray_tpu_kv_blocks` totals;
every event the port emits has the fields of `event_log`'s schemas; a tiny
torch.compile fires `compile.start` / `compile.end`; and after
`use_runtime(...)` the runtime's `prometheus_text()` holds the port's
families, its event log the port's events, and a runtime worker's
`memory_report()["kv"]` lists a port engine.
"""

import collections
import gc
import os
import weakref

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.util.metrics as jm
from ray_tpu._private import device_profiler as jdp
from ray_tpu._private import event_log
from ray_tpu._private import kv_registry as jkv
from ray_tpu.inference import GenerationConfig as JGen
from ray_tpu.inference.paged_engine import PagedInferenceEngine as JPaged
from ray_tpu_torch._private import device_profiler as tdp
from ray_tpu_torch._private import kv_registry as tkv
from ray_tpu_torch.inference import GenerationConfig
from ray_tpu_torch.inference.paged_engine import PagedInferenceEngine
from ray_tpu_torch.util import metrics as tm
from test_torch_paged_engine import tiny_models

PHASE_STEPS = [
    {"input_wait": 2e-4, "h2d": 3e-3, "device_execute": 0.04, "reply": 1e-5},
    {"input_wait": 0.3, "prefill": 0.02, "device_execute": 7e-5},
    {"device_execute": 1.2, "reply": 400.0},
]


@pytest.fixture(autouse=True)
def local_port():
    """Every test starts and ends with the port's own registry and ring."""
    tm.use_runtime()
    yield
    tm.use_runtime()


@pytest.fixture
def fresh_kv(monkeypatch):
    """Both engine registries empty: engines of other tests that are still
    alive in this process do not count."""
    for reg in (jkv, tkv):
        monkeypatch.setattr(reg, "_engines", weakref.WeakValueDictionary())


def family(text, name):
    """The lines of `text` (Prometheus exposition) of the family `name`."""
    out = []
    for line in text.splitlines():
        head = line.split("{")[0].split(" ")[0]
        if (line.startswith((f"# HELP {name} ", f"# TYPE {name} "))
                or head in (name, f"{name}_bucket", f"{name}_sum",
                            f"{name}_count", f"{name}_quantile")):
            out.append(line)
    return out


def labelled(text, name, **tags):
    """The lines of family `name` whose labels include `tags`."""
    want = [f'{k}="{v}"' for k, v in tags.items()]
    return [line for line in family(text, name)
            if all(w in line for w in want)]


def test_prometheus_text_is_the_runtime_registry_s():
    for mod in (jm, tm):
        c = mod.get_or_create_counter("rtt_parity_requests", "Requests",
                                      tag_keys=("route", "code"))
        c.inc(tags={"route": "/a", "code": "200"})
        c.inc(2.5, tags={"route": "/b", "code": "500"})
        g = mod.Gauge("rtt_parity_depth", "Queue depth", tag_keys=("q",))
        g.set(7, tags={"q": "main"})
        g.set(3.5, tags={"q": "side"})
        g.set(1)
        h = mod.get_or_create_histogram(
            "rtt_parity_latency", "Latency", boundaries=[0.1, 1.0, 10.0],
            tag_keys=("op",))
        for v in (0.05, 0.5, 0.5, 5.0, 50.0):
            h.observe(v, tags={"op": "get"})
        d = mod.Histogram("rtt_parity_default", tag_keys=())
        d.observe(0.02)
        assert mod.get_or_create_histogram("rtt_parity_latency") is h
        assert mod.get_metric("rtt_parity_depth") is g
        with pytest.raises(ValueError, match="unknown tag keys"):
            c.inc(tags={"bogus": "x"})
        with pytest.raises(ValueError, match="positive"):
            c.inc(0)
    jt, tt = jm.prometheus_text(), tm.prometheus_text()
    for name in ("rtt_parity_requests", "rtt_parity_depth",
                 "rtt_parity_latency", "rtt_parity_default"):
        assert family(tt, name) == family(jt, name) != []
    assert tm.LATENCY_BOUNDARIES == jm.LATENCY_BOUNDARIES


@pytest.fixture
def fresh_data_series():
    """Both phase histograms without the "data" profiler's series: the
    device feeds of other tests in this process (`observe_phase`) do not
    count. What they had is added back afterwards."""
    saved = []
    for hist in (jdp._metrics()[0], tdp._metrics()[0]):
        with hist._lock:
            keys = [k for k in hist._counts if dict(k)["profiler"] == "data"]
            saved.append((hist, {k: (hist._counts.pop(k), hist._sums.pop(k),
                                     hist._totals.pop(k)) for k in keys}))
    yield
    for hist, series in saved:
        with hist._lock:
            for k, (counts, total_s, n) in series.items():
                mine = hist._counts.setdefault(k, [0] * len(counts))
                hist._counts[k] = [a + b for a, b in zip(mine, counts)]
                hist._sums[k] += total_s
                hist._totals[k] += n


def test_profilers_export_what_jax_s_export(fresh_data_series):
    name = "rtt-parity-prof"
    jp = jdp.DeviceStepProfiler(name, flops_per_step=4e12,
                                peak_flops_per_chip=1e15)
    tp = tdp.DeviceStepProfiler(name, device="cpu", flops_per_step=4e12,
                                peak_flops_per_chip=1e15)
    for phases in PHASE_STEPS:
        jp.record_step(dict(phases), tokens=8)
        tp.record_step(dict(phases), tokens=8)
    tdp.observe_phase("input_wait", 0.25)
    jdp.observe_phase("input_wait", 0.25)
    jt, tt = jm.prometheus_text(), tm.prometheus_text()
    for fam, tags in (("ray_tpu_step_phase_seconds", {"profiler": name}),
                      ("ray_tpu_step_phase_seconds", {"profiler": "data"}),
                      ("ray_tpu_device_mfu", {"profiler": name})):
        want = labelled(jt, fam, **tags)
        assert labelled(tt, fam, **tags) == want != []
    # the families' descriptions, kinds, tag keys and boundaries
    for fam in ("ray_tpu_step_phase_seconds", "ray_tpu_device_mfu",
                "ray_tpu_hbm_bytes_in_use", "ray_tpu_hbm_bytes_peak"):
        assert family(tt, fam)[:2] == family(jt, fam)[:2]
        assert tm.get_metric(fam)._tag_keys == jm.get_metric(fam)._tag_keys
    assert (tm.get_metric("ray_tpu_step_phase_seconds")._boundaries
            == jm.get_metric("ray_tpu_step_phase_seconds")._boundaries
            == tdp._PHASE_BOUNDARIES)
    # the phase reports and their events
    seq = max([e["seq"] for e in event_log._ring] or [0])
    t_seq = max([e["seq"] for e in tm.events()] or [0])
    jr, tr = jp.report(), tp.report()
    for k in ("steps", "phase_seconds", "accounted_s", "compile_s", "mfu"):
        assert tr[k] == jr[k], k
    assert {k: v for k, v in tr.items() if k.endswith("_frac")} == {
        k: v for k, v in jr.items() if k.endswith("_frac")}
    (je,) = [e for e in event_log._ring if e["seq"] > seq
             and e["type"] == "perf.phase_report"]
    (te,) = [e for e in tm.events("perf.") if e["seq"] > t_seq]
    assert te["data"] == je["data"]
    assert set(te["data"]) == set(event_log.EVENT_SCHEMAS["perf.phase_report"])


def test_kv_blocks_gauge_sums_the_engines_as_jax_does(fresh_kv):
    jcfg, tcfg, jp, tp = tiny_models()
    kw = dict(max_batch=2, max_len=64, block_size=8, n_blocks=20,
              decode_chunk=4)
    system = [5] * 20
    prompts = [system + [1, 2], system + [3], [7] * 9]
    engines = (JPaged(jp, jcfg, **kw),
               PagedInferenceEngine(tp, tcfg, device="cpu", **kw))
    for eng, gen in zip(engines, (JGen, GenerationConfig)):
        eng.generate(prompts, gen(max_new_tokens=5))
    totals = []
    for reg, mod in ((jkv, jm), (tkv, tm)):
        reports = reg.report_all()
        assert len(reports) == 1
        values = mod.get_metric("ray_tpu_kv_blocks")._values
        got = {dict(k)["state"]: v for k, v in values.items()}
        assert got == {s: float(reports[0][f"{s}_blocks"])
                       for s in ("free", "cached", "active")}
        totals.append(got)
    assert totals[0] == totals[1]
    assert totals[1]["cached"] > 0  # the prompts' full blocks stay cached
    assert sum(totals[1].values()) == kw["n_blocks"] - 1  # block 0: scratch


@pytest.mark.parametrize("prefetch,waits", [(0, 5), (1, 6)])
def test_the_feed_s_waits_reach_the_phase_histogram(prefetch, waits):
    """As JAX's feed: one input_wait sample of profiler "data" per pull
    (per batch synchronously; with a producer, also the pull that finds
    the end), each the wait the feed counts in wait_s."""
    from ray_tpu_torch.data import iter_device_batches

    def counts():
        hist = tdp._metrics()[0]
        key = (("phase", "input_wait"), ("profiler", "data"))
        return hist._totals.get(key, 0), hist._sums.get(key, 0.0)

    before = counts()
    stats = {}
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    out = list(iter_device_batches(iter(batches), device="cpu",
                                   prefetch=prefetch, stats=stats))
    after = counts()
    assert len(out) == stats["batches"] == 5
    assert after[0] - before[0] == waits
    assert after[1] - before[1] == pytest.approx(stats["wait_s"], abs=1e-9)


def test_port_events_have_the_event_log_fields(monkeypatch):
    """Every port event type is one of the event log's, with at least the
    fields its schema asks for; those of the other slices exactly them.
    The rl.* types list what their call sites pass (JAX's sites pass more
    than JAX's schema lists), `actor_id` among them as the envelope's
    keyword."""
    for etype, fields in tm.EVENT_SCHEMAS.items():
        assert set(event_log.EVENT_SCHEMAS[etype]) <= set(fields), etype
        if not etype.startswith("rl."):
            assert event_log.EVENT_SCHEMAS[etype] == fields
    prof = tdp.DeviceStepProfiler("rtt-fields", device="cpu")
    prof.record_step({"device_execute": 0.1})
    prof.report()
    with pytest.raises(ValueError, match="unknown event type"):
        tm.emit("compile.middle", source="x")
    with pytest.raises(ValueError, match="takes the fields"):
        tm.emit("compile.end", source="x")
    for e in tm.events():
        assert set(e["data"]) == (set(tm.EVENT_SCHEMAS[e["type"]])
                                  - set(tm.ENVELOPE))
        assert set(event_log.EVENT_SCHEMAS[e["type"]]) <= set(e["data"])
    # a full ring makes room and counts what it pushed out
    monkeypatch.setattr(tm, "_ring", collections.deque(maxlen=2))
    before = tm.event_stats()
    for i in range(5):
        tm.emit("perf.phase_report", profiler="ring", steps=i, fracs={})
    after = tm.event_stats()
    assert after["evicted"] - before["evicted"] == 3
    assert after["emitted"] - before["emitted"] == 5
    assert [e["data"]["steps"] for e in tm.events()] == [3, 4]


def test_a_tiny_compile_fires_compile_events():
    prof = tdp.DeviceStepProfiler("rtt-compile", device="cpu")
    seq = max([e["seq"] for e in tm.events()] or [0])
    stats0 = tdp.compile_stats()
    torch._dynamo.reset()
    marker = float(os.getpid() % 997) + 0.5
    fn = torch.compile(lambda x: x * marker + 1.5, backend="aot_eager")
    with prof.step() as sp:
        with sp.phase("device_execute") as ph:
            ph.fence(fn(torch.ones(4, 4)))
    new = [e for e in tm.events("compile.") if e["seq"] > seq]
    starts = [e for e in new if e["type"] == "compile.start"]
    ends = [e for e in new if e["type"] == "compile.end"]
    stats = tdp.compile_stats()
    assert len(starts) == len(ends) == stats["compiles"] - stats0[
        "compiles"] >= 1
    assert all(e["data"]["t_start"] <= e["time"] for e in starts)
    assert all(e["data"]["source"].startswith("torch._dynamo")
               for e in new)
    took = sum(e["data"]["duration_s"] for e in ends)
    assert took == pytest.approx(stats["compile_s"] - stats0["compile_s"],
                                 rel=1e-9)
    rec = prof.report(recent=1)["recent_steps"][0]["phases"]
    assert rec["compile"] == pytest.approx(took, rel=1e-9)
    # a step with a compile phase of its own keeps it as it is
    fn2 = torch.compile(lambda x: x - marker, backend="aot_eager")
    with prof.step() as sp:
        sp.external("compile", 5.0)
        fn2(torch.ones(3))
    assert prof.report(recent=1)["recent_steps"][0]["phases"] == {
        "compile": 5.0}
    torch._dynamo.reset()


def test_use_runtime_routes_families_events_and_engines(fresh_kv):
    jcfg, tcfg, jp, tp = tiny_models()
    seq = max([e["seq"] for e in event_log._ring] or [0])
    tm.use_runtime(metrics=jm, emit=event_log.emit, kv_registry=jkv)
    prof = tdp.DeviceStepProfiler("rtt-routed", device="cpu",
                                  flops_per_step=1e9,
                                  peak_flops_per_chip=1e12)
    prof.record_step({"device_execute": 0.01})
    prof.report()
    eng = PagedInferenceEngine(tp, tcfg, device="cpu", max_batch=2,
                               max_len=64, block_size=8, n_blocks=13)
    eng.generate([[3] * 17], GenerationConfig(max_new_tokens=3))
    assert [r["n_blocks"] for r in jkv.report_all()] == [13]
    tkv.report_all()
    text = jm.prometheus_text()
    assert labelled(text, "ray_tpu_step_phase_seconds",
                    profiler="rtt-routed")
    assert labelled(text, "ray_tpu_device_mfu", profiler="rtt-routed")
    assert labelled(text, "ray_tpu_kv_blocks", state="cached")
    assert len(family(text, "ray_tpu_kv_blocks")) == 5  # HELP, TYPE, 3
    (e,) = [e for e in event_log._ring if e["seq"] > seq
            and e["type"] == "perf.phase_report"
            and e["data"]["profiler"] == "rtt-routed"]
    assert e["data"]["steps"] == 1
    assert not [e for e in tm.events("perf.")
                if e["data"]["profiler"] == "rtt-routed"]
    del eng
    gc.collect()
    assert jkv.report_all() == []


def test_a_runtime_worker_s_memory_report_lists_a_port_engine():
    from ray_tpu._private import memory_obs
    from ray_tpu.util.state.api import get_cluster_memory

    @ray_tpu.remote
    class PortEngineHolder:
        def __init__(self):
            import ray_tpu.util.metrics as rm
            from ray_tpu._private import event_log as rel
            from ray_tpu._private import kv_registry as rkv
            from ray_tpu_torch.inference import GenerationConfig as G
            from ray_tpu_torch.inference.paged_engine import (
                PagedInferenceEngine as P)
            from ray_tpu_torch.models import llama
            from ray_tpu_torch.util import metrics as pm

            cfg = llama.LlamaConfig.tiny(vocab_size=64)
            params = llama.init(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
            self.engine = P(params, cfg, device="cpu", max_batch=2,
                            max_len=64, block_size=8, n_blocks=11)
            pm.use_runtime(metrics=rm, emit=rel.emit, kv_registry=rkv)
            self.engine.generate([[2] * 9], G(max_new_tokens=2))
            self._rm = rm

        def pid(self):
            return os.getpid()

        def metrics_text(self):
            from ray_tpu_torch._private import kv_registry as pkv

            pkv.report_all()
            return self._rm.prometheus_text()

    ray_tpu.init(num_cpus=2)
    try:
        holder = PortEngineHolder.remote()
        pid = ray_tpu.get(holder.pid.remote(), timeout=120)
        text = ray_tpu.get(holder.metrics_text.remote(), timeout=60)
        report = get_cluster_memory()
        kvs = [kv for _n, p, rep in memory_obs.iter_worker_reports(report)
               if int(p) == pid for kv in rep.get("kv") or ()]
    finally:
        ray_tpu.shutdown()
    assert [kv["n_blocks"] for kv in kvs] == [11]
    assert kvs[0]["cached_blocks"] >= 1
    assert labelled(text, "ray_tpu_kv_blocks", state="free")
    samples = [line for line in labelled(text, "ray_tpu_kv_blocks")
               if not line.startswith("#")]
    assert np.isclose(sum(float(line.rsplit(" ", 1)[1])
                          for line in samples), 10.0)
