"""The store-path data-plane bench on the card, through the runtime.

Marked `cuda`: it skips without an NVIDIA card. It starts `ray_tpu.init`
and runs `dataplane_bench.run(runtime=api)` on cuda:0 (64 MiB of numpy, a
CPU tensor and a CUDA tensor put by the driver, read by a same-node worker
with its cached value dropped before every read): every value read back
exact, the CUDA tensor's gets at the pinned rate with no pageable get.
It needs a machine with both a card and the runtime (the runtime is the
JAX package's, with its native store); this file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_store_card.py
"""

import types

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def runtime():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import ray_tpu
    from ray_tpu import data

    from ray_tpu_torch._private import dataplane_bench

    def drop_cached(ref):
        from ray_tpu._raylet import get_core_worker

        get_core_worker().memory_store.delete([ref.object_id()])

    ray_tpu.init(num_cpus=2)
    yield types.SimpleNamespace(
        put=ray_tpu.put, get=ray_tpu.get, remote=ray_tpu.remote,
        drop_cached=drop_cached,
        dataset=data.range(dataplane_bench.OVERLAP_ROWS).map_batches(
            dataplane_bench.overlap_columns, batch_size=512))
    ray_tpu.shutdown()


def test_the_store_bench_runs_on_the_card(runtime):
    from ray_tpu_torch._private import dataplane_bench

    out = dataplane_bench.run("cuda", runtime=runtime)  # raises if inexact
    d = out["detail"]
    assert d["device"] == torch.cuda.get_device_name(0)
    assert set(d["object_get_gbps"]) == {"numpy", "cpu_tensor",
                                         "cuda_tensor"}
    assert d["worker_copy_stats"]["typed_tensor_get_pageable"] == 0
    assert d["driver_payload_flattens"] == 0
    print(out)
