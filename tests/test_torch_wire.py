"""The port's typed torch.Tensor wire against the JAX package's, on the CPU.

A tensor's out-of-band buffer holds the same bytes as
`_maybe_reduce_jax_array`'s shard buffer for the same numpy input. With
`install_tensor_wire()`, the runtime's own `serialize` / `deserialize`
(`ray_tpu._private.serialization`, cloudpickle's pickler) carry tensors out
of band, exact, while `torch.save` / `torch.load(weights_only=True)` stay as
they were; a tensor the test puts comes back from a worker task on the
typed wire. The port's own pickler round-trips every dtype and layout it
takes, refuses a DTensor that spans ranks, and leaves what it does not take
to torch's own reduce.
"""

import io
import pickle
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu._private import serialization as jser
from ray_tpu_torch._private import serialization as tser

MIB2 = 2 * 1024 * 1024


@pytest.fixture(autouse=True)
def no_wire_after():
    """A get installs the wire (a process that received a typed tensor
    sends typed tensors): leave none installed for the next test."""
    yield
    tser.uninstall_tensor_wire()


@pytest.fixture
def wire():
    assert tser.install_tensor_wire()


def _both(x: np.ndarray, dtype: str):
    """The same numpy input as a jax array and a torch tensor of `dtype`."""
    if dtype == "bfloat16":
        return (jnp.asarray(x, dtype=jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x.astype(dtype)), torch.from_numpy(x.astype(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_buffer_bytes_equal_the_jax_typed_wire(dtype):
    x = np.random.default_rng(0).standard_normal((16, 24)).astype(np.float32)
    if dtype == "int32":
        x = x * 1000
    ja, tt = _both(x, dtype)
    jfn, (jmeta, jbuf) = jser._maybe_reduce_jax_array(ja)
    tfn, (tmeta, tbuf) = tser._maybe_reduce_tensor(tt)
    assert tfn is tser._rebuild_tensor
    assert bytes(tbuf.raw()) == bytes(jbuf.raw())
    assert tmeta[:2] == (dtype, (16, 24)) and jmeta[1] == (16, 24)


def _runtime_round_trip(value):
    so = jser.serialize(value)
    got, _ = jser.deserialize(so)
    return so, got


CASES = {
    "fp32": lambda g: torch.randn((512, 1024), generator=g),
    "bf16": lambda g: torch.randn((1024, 1024), generator=g).to(
        torch.bfloat16),
    "fp16 requires_grad": lambda g: torch.randn(
        (1024, 1024), generator=g).half().requires_grad_(True),
    "int64": lambda g: torch.randint(-2**40, 2**40, (512, 512), generator=g),
    "uint8": lambda g: torch.randint(0, 256, (MIB2,), generator=g,
                                     dtype=torch.uint8),
    "bool": lambda g: torch.randn((MIB2,), generator=g) > 0,
    "complex64": lambda g: torch.randn((256, 1024), generator=g,
                                       dtype=torch.complex64),
}


@pytest.mark.parametrize("name", list(CASES))
def test_runtime_serialize_carries_tensors_out_of_band(wire, name):
    t = CASES[name](torch.Generator().manual_seed(1))
    assert t.numel() * t.element_size() == MIB2
    puts = tser.COPY_STATS["typed_tensor_put"]
    so, got = _runtime_round_trip({"x": t, "again": t})
    assert len(so.inband) < 1024
    assert [b.raw().nbytes for b in so.buffers] == [MIB2]
    assert tser.COPY_STATS["typed_tensor_put"] == puts + 1
    assert got["x"] is got["again"]
    assert type(got["x"]) is torch.Tensor
    assert got["x"].dtype == t.dtype and got["x"].shape == t.shape
    assert got["x"].requires_grad == t.requires_grad
    assert torch.equal(got["x"].detach(), t.detach())


def test_runtime_round_trips_parameters_views_and_scalars(wire):
    g = torch.Generator().manual_seed(2)
    p = torch.nn.Parameter(torch.randn((8, 4), generator=g))
    frozen = torch.nn.Parameter(torch.randn(3, generator=g),
                                requires_grad=False)
    base = torch.randn((6, 10), generator=g)
    values = {"param": p, "frozen": frozen, "strided": base[:, ::3],
              "transposed": base.t(), "0-d": torch.tensor(2.5),
              "empty": torch.empty((0, 5), dtype=torch.int16),
              "neg": torch.randn(4, generator=g)._neg_view(),
              "conj": torch.randn(4, dtype=torch.complex64,
                                  generator=g).conj()}
    so, got = _runtime_round_trip(values)
    assert len(so.buffers) == len(values)
    assert type(got["param"]) is torch.nn.Parameter
    assert got["param"].requires_grad and not got["frozen"].requires_grad
    for k, v in values.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        assert torch.equal(got[k].detach(), v.detach().resolve_conj()
                           .resolve_neg()), k
        assert not got[k].is_conj() and not got[k].is_neg()


def test_without_the_wire_the_runtime_pickles_in_band():
    t = CASES["bf16"](torch.Generator().manual_seed(1))
    tser.uninstall_tensor_wire()
    so, got = _runtime_round_trip(t)
    assert len(so.inband) > MIB2 and so.buffers == []
    assert torch.equal(got, t)


def test_torch_save_is_unchanged_while_the_wire_is_installed(wire):
    g = torch.Generator().manual_seed(3)
    state = {"w": torch.randn((4, 8), generator=g).to(torch.bfloat16),
             "p": torch.nn.Parameter(torch.randn(3, generator=g)),
             "step": torch.tensor(7)}
    f = io.BytesIO()
    torch.save(state, f)
    saved = f.getvalue()
    f.seek(0)
    loaded = torch.load(f, weights_only=True)
    assert all(torch.equal(loaded[k], state[k]) for k in state)
    tser.uninstall_tensor_wire()
    f2 = io.BytesIO()
    torch.save(state, f2)
    # the archive's data.pkl, which a copyreg entry would have changed
    assert _data_pkl(saved) == _data_pkl(f2.getvalue())


def _data_pkl(archive: bytes) -> bytes:
    import zipfile

    with zipfile.ZipFile(io.BytesIO(archive)) as z:
        return z.read(next(n for n in z.namelist()
                           if n.endswith("data.pkl")))


def test_install_is_idempotent_and_uninstall_restores():
    import cloudpickle

    table = cloudpickle.Pickler.dispatch_table
    assert tser.install_tensor_wire() and tser.install_tensor_wire()
    assert table.maps[0][torch.Tensor] is tser._dispatch_reduce
    assert torch.Tensor not in pickle.dispatch_table  # copyreg untouched
    tser.uninstall_tensor_wire()
    assert torch.Tensor not in table and torch.nn.Parameter not in table


def test_install_without_cloudpickle_is_a_no_op(monkeypatch):
    monkeypatch.setitem(sys.modules, "cloudpickle", None)
    assert tser.install_tensor_wire() is False
    t = torch.arange(6.0)
    calls = []
    monkeypatch.setattr(tser, "install_tensor_wire",
                        lambda: calls.append(1))
    assert torch.equal(tser.deserialize(tser.serialize(t)), t)
    assert calls == []  # a get does not try the import again


def test_a_received_tensor_installs_the_wire():
    tser.uninstall_tensor_wire()
    t = torch.arange(10)
    got = tser.deserialize(tser.serialize(t))
    so, _ = _runtime_round_trip(got)
    assert [b.raw().nbytes for b in so.buffers] == [80]


@pytest.mark.parametrize("name", list(CASES))
def test_port_pickler_round_trip_counts_and_views(name):
    t = CASES[name](torch.Generator().manual_seed(4)).detach()
    puts, gets = (tser.COPY_STATS["typed_tensor_put"],
                  tser.COPY_STATS["typed_tensor_get"])
    flat = tser.serialize([t, {"same": t}]).to_bytes()
    obj = tser.SerializedObject.from_bytes(flat)  # read-only memory
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = tser.deserialize(obj)
    assert tser.COPY_STATS["typed_tensor_put"] == puts + 1
    assert tser.COPY_STATS["typed_tensor_get"] == gets + 1
    assert got[0] is got[1]["same"] and torch.equal(got[0], t)
    # a zero-copy view of the received buffer
    assert got[0].untyped_storage().data_ptr() == np.frombuffer(
        obj.buffers[0], np.uint8).ctypes.data


def test_write_into_an_arena_and_read_back():
    t = torch.randn(1000).to(torch.bfloat16)
    so = tser.serialize({"t": t, "n": 3})
    arena = bytearray(so.wire_size() + 16)
    assert so.write_into(memoryview(arena)) == so.wire_size()
    assert bytes(arena[:so.wire_size()]) == so.to_bytes()
    got = tser.deserialize(tser.SerializedObject.from_bytes(
        memoryview(arena).toreadonly()[:so.wire_size()]))
    assert got["n"] == 3 and torch.equal(got["t"], t)
    assert so.total_bytes() == len(so.inband) + 2000


def test_what_the_wire_does_not_take_goes_to_torch():
    dense = torch.randn(4, 4)
    values = {"sparse": dense.to_sparse(), "meta": torch.empty(3,
                                                               device="meta")}
    for name, v in values.items():
        assert tser._maybe_reduce_tensor(v) is None, name
    got = tser.deserialize(tser.serialize(values["sparse"]))
    assert torch.equal(got.to_dense(), dense)
    assert tser._dispatch_reduce(values["sparse"])[0] is not \
        tser._rebuild_tensor


def test_a_dtensor_on_two_ranks_is_refused(wire):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    for world in (2, 1):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            mesh = init_device_mesh("cpu", (world,))
            local = torch.arange(6.0).view(2, 3)
            for placement in (Shard(0), Replicate()):
                dt = DTensor.from_local(local, mesh, [placement],
                                        run_check=False)
                if world == 2:
                    for serialize in (jser.serialize, tser.serialize):
                        with pytest.raises(TypeError,
                                           match="only its own shards"):
                            serialize({"x": dt})
                else:  # one rank holds it all: a plain tensor
                    _, got = _runtime_round_trip(dt)
                    assert type(got) is torch.Tensor
                    assert torch.equal(got, local)
        finally:
            dist.destroy_process_group()


def test_a_worker_task_returns_the_put_tensor_typed(ray_start_regular,
                                                       wire):
    import ray_tpu

    t = CASES["bf16"](torch.Generator().manual_seed(5))
    ref = ray_tpu.put(t)

    @ray_tpu.remote
    def echo(x):
        from ray_tpu_torch._private import serialization as ser

        return x, dict(ser.COPY_STATS)

    gets = tser.COPY_STATS["typed_tensor_get"]
    got, worker_stats = ray_tpu.get(echo.remote(ref), timeout=120)
    assert got.dtype == torch.bfloat16 and torch.equal(got, t)
    assert worker_stats["typed_tensor_get"] >= 1
    assert tser.COPY_STATS["typed_tensor_get"] > gets
