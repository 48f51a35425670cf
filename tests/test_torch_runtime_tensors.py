"""Tensors through the port's own runtime and its native shm store, on the
CPU.

fp32, bf16, int64, bool, empty and 0-d tensors and a 64 MiB one go through
`put`/`get`, and as a task's arguments and returns, exact, with dtype,
shape and requires_grad kept. The large ones land in the node's native
shm store. The runtime's pickler carries them typed with no
`install_tensor_wire()` (and its gets leave cloudpickle's table as it
was), and their out-of-band buffers hold the same bytes as the JAX
runtime's serialize with the wire installed.
"""

import cloudpickle
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu._private import serialization as jser
from ray_tpu_torch._private import serialization as tser
from ray_tpu_torch._raylet import global_state

MIB64 = 64 * 1024 * 1024


def _cases():
    g = torch.Generator().manual_seed(3)
    return {
        "fp32": torch.randn((64, 96), generator=g),
        "bf16": torch.randn((128, 64), generator=g).to(torch.bfloat16),
        "int64": torch.randint(-2**40, 2**40, (4096,), generator=g),
        "bool": torch.randn((33, 7), generator=g) > 0,
        "empty": torch.empty((0, 5)),
        "0-d": torch.tensor(2.5, dtype=torch.float64),
        "requires_grad": torch.randn((8, 8), generator=g).requires_grad_(),
        "64 MiB": torch.randint(0, 256, (MIB64,), generator=g,
                                dtype=torch.uint8),
    }


CASES = _cases()


@pytest.fixture(scope="module")
def runtime():
    tser.uninstall_tensor_wire()
    rt.init(num_cpus=2)
    try:
        yield
    finally:
        rt.shutdown()
        tser.uninstall_tensor_wire()


def _same(a, b):
    return (type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape
            and a.requires_grad == b.requires_grad
            and torch.equal(a.detach(), b.detach()))


@rt.remote
def echo(t):
    return t


@rt.remote
def describe(t):
    return str(t.dtype), tuple(t.shape), t.requires_grad, t.sum().item()


@pytest.mark.parametrize("name", list(CASES))
def test_put_get_is_exact(runtime, name):
    t = CASES[name]
    assert _same(rt.get(rt.put(t)), t)


@pytest.mark.parametrize("name", list(CASES))
def test_task_arguments_and_returns_are_exact(runtime, name):
    t = CASES[name]
    assert _same(rt.get(echo.remote(t)), t)
    assert _same(rt.get(echo.remote(rt.put(t))), t)
    dtype, shape, grad, total = rt.get(describe.remote(t))
    assert (dtype, shape, grad) == (str(t.dtype), tuple(t.shape),
                                    t.requires_grad)
    assert total == t.sum().item()


def test_large_tensors_live_in_the_native_store(runtime):
    cw = global_state.core_worker
    assert cw.plasma is not None  # the native shm store is up
    ref = rt.put(CASES["64 MiB"])
    entry = cw.memory_store.get_entry(ref.object_id())
    assert entry is not None and entry.in_plasma


def test_the_runtime_needs_no_installed_wire(runtime):
    """Typed without install_tensor_wire, and a get installs nothing."""
    table = cloudpickle.Pickler.dispatch_table.maps[0]
    assert torch.Tensor not in table
    so = tser.serialize({"t": CASES["bf16"]})
    assert [b.raw().nbytes for b in so.buffers] == [128 * 64 * 2]
    rt.get(echo.remote(CASES["fp32"]))
    assert torch.Tensor not in table and tser._installed is None


@pytest.mark.parametrize("name", list(CASES))
def test_buffers_hold_the_jax_runtimes_bytes(name):
    t = CASES[name]
    port = tser.serialize(t)
    assert tser.install_tensor_wire()
    try:
        jax_rt = jser.serialize(t)
    finally:
        tser.uninstall_tensor_wire()
    assert len(port.buffers) == len(jax_rt.buffers) == 1
    assert bytes(port.buffers[0].raw()) == bytes(jax_rt.buffers[0].raw())
