"""The port's ring attention and sharded flash attention against the JAX
package's, on the CPU.

One 4-rank gloo gang (spawned once for the file) runs
`ray_tpu_torch.parallel.ring_attention.ring_attention_sharded` on DTensors
sharded on the sequence over sp=2 (with tp=2 or fsdp=2 beside it) and
sp=4, causal and not, and `ray_tpu_torch.ops.flash_attention.
flash_attention_sharded` on fsdp x tp (KV heads split), tp=4 (KV heads
repeated first), dp=4 with a batch that does not divide (left whole) and
sp x tp (the sequence gathered); the whole output and the gradients of
sum(o * dO) are held against the JAX package's `ring_attention_sharded` /
`flash_attention_sharded` and `jax.grad` on the same mesh shape of the 8
virtual CPU devices (fp32, atol 2e-5 on o; gradients 5e-5 of their
largest value), and each rank's flash calls against the schedule: under
causal the ring's rank at sp coordinate c calls the forward and the
backward c + 1 times, the flash wrapper once each. Locally: the lse merge
(with a part whose rows saw no key) and the plain ring against whole
attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ray_tpu.ops.flash_attention import (
    flash_attention_sharded as jax_flash_sharded)
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel.ring_attention import (
    ring_attention_sharded as jax_ring)
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.parallel import gang_cases
from ray_tpu_torch.parallel.ring_attention import (merge_partials,
                                                   ring_attention_plain)
from ray_tpu_torch.train.backend import launch_gang

WORLD = 4
GANG_TIMEOUT_S = 240
ATOL = 2e-5          # fp32 o: the same function, blocked differently
GRAD_ATOL = 5e-5     # of max|grad|

B, S, H, H_KV, D = 2, 64, 4, 2, 32
CASES = [
    (dict(sp=2, tp=2), True),
    (dict(sp=2, tp=2), False),
    (dict(sp=2, fsdp=2), True),
    (dict(sp=4), True),
    (dict(sp=4), False),
]
# flash_attention_sharded: (mesh, causal)
FLASH_CASES = [
    (dict(fsdp=2, tp=2), True),
    (dict(tp=4), True),
    (dict(dp=4), False),
    (dict(sp=2, tp=2), True),
]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, H_KV, D)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, S, H, D)).astype(np.float32)
    return q, k, v, do


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    cases = []
    for fn, table in (("ring", CASES), ("flash", FLASH_CASES)):
        for i, (mesh_kw, causal) in enumerate(table):
            q, k, v, do = _inputs(i if fn == "ring" else 10 + i)
            cases.append(dict(fn=fn, mesh=mesh_kw, causal=causal, q=q, k=k,
                              v=v, do=do))
    store = tmp_path_factory.mktemp("gang") / "store"
    return launch_gang(gang_cases.run_cases, WORLD, "cpu", GANG_TIMEOUT_S,
                       args=([("attention_cases", (cases,))],),
                       init_method=f"file://{store}")


def _jax(mesh_kw, causal, q, k, v, do, fn="ring"):
    sizes = jmesh.MeshConfig(**mesh_kw).resolved(WORLD).axis_sizes()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(
        tuple(sizes[a] for a in jmesh.AXIS_ORDER)), jmesh.AXIS_ORDER)
    rep = H // H_KV

    def f(q, k, v):
        if fn == "flash":  # it repeats the KV heads itself
            return jax_flash_sharded(q, k, v, mesh, causal=causal)
        kr, vr = (jnp.repeat(t, rep, axis=2) for t in (k, v))
        return jax_ring(q, kr, vr, mesh, causal=causal)

    o = jax.jit(f)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * do),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"{m}-{'causal' if c else 'full'}"
                              for m, c in CASES])
def test_ring_matches_jax_ring(gang, i):
    mesh_kw, causal = CASES[i]
    q, k, v, do = _inputs(i)
    o, (dq, dk, dv) = _jax(mesh_kw, causal, q, k, v, do)
    got = gang[0][0][i]
    np.testing.assert_allclose(got["o"], o, atol=ATOL, rtol=0)
    for name, want in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(
            got[name], want, rtol=0,
            atol=GRAD_ATOL * float(np.abs(want).max())), name
    # every rank holds the same whole result
    for rank in range(1, WORLD):
        np.testing.assert_array_equal(gang[rank][0][i]["o"], got["o"])


@pytest.mark.parametrize("i", range(len(CASES)))
def test_ring_calls_the_kernels_per_visited_block(gang, i):
    mesh_kw, causal = CASES[i]
    n = mesh_kw["sp"]
    for rank in range(WORLD):
        got = gang[rank][0][i]
        c = got["sp_coord"]
        want = c + 1 if causal else n
        assert got["fwd_calls"] == want, (rank, got["fwd_calls"])
        assert got["bwd_calls"] == want, (rank, got["bwd_calls"])
    if causal:
        mean = np.mean([gang[r][0][i]["fwd_calls"] for r in range(WORLD)])
        assert mean == (n + 1) / 2


@pytest.mark.parametrize("i", range(len(FLASH_CASES)),
                         ids=[str(m) for m, _ in FLASH_CASES])
def test_sharded_flash_matches_jax_sharded_flash(gang, i):
    mesh_kw, causal = FLASH_CASES[i]
    q, k, v, do = _inputs(10 + i)
    o, (dq, dk, dv) = _jax(mesh_kw, causal, q, k, v, do, fn="flash")
    for rank in range(WORLD):
        got = gang[rank][0][len(CASES) + i]
        np.testing.assert_allclose(got["o"], o, atol=ATOL, rtol=0)
        for name, want in (("dq", dq), ("dk", dk), ("dv", dv)):
            np.testing.assert_allclose(
                got[name], want, rtol=0,
                atol=GRAD_ATOL * float(np.abs(want).max())), name
        # the result comes back in q's placements; one kernel call each way
        assert got["placements_kept"]
        assert (got["fwd_calls"], got["bwd_calls"]) == (1, 1)


def test_merge_with_a_masked_part_keeps_the_other():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(3))
    o1, lse1 = fa._reference_attention_torch(q, k, v, True, D ** -0.5)
    # a part whose rows all saw no key: o = 0, lse = -1e30 + log(1e-20)
    masked_o, masked_lse = fa._reference_attention_torch(
        q[:, 32:], k[:, :16], v[:, :16], True, D ** -0.5)
    masked_o, masked_lse = masked_o[:, :16], masked_lse[..., :16]
    assert float(masked_o.abs().max()) == 0.0
    assert float(masked_lse.max()) < -1e29
    o, lse = merge_partials(o1[:, :16].float(), lse1[..., :16], masked_o,
                            masked_lse)
    torch.testing.assert_close(o, o1[:, :16].float(), atol=0, rtol=0)
    torch.testing.assert_close(lse, lse1[..., :16], atol=0, rtol=0)
    # both masked: zeros, no NaN
    o, lse = merge_partials(masked_o.float(), masked_lse, masked_o,
                            masked_lse)
    assert bool(torch.isfinite(o).all()) and float(o.abs().max()) == 0.0


def test_merge_of_two_key_blocks_is_attention_over_both():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(4))
    scale = D ** -0.5
    whole, lse = fa._reference_attention_torch(q, k, v, False, scale)
    o_a, l_a = fa._reference_attention_torch(q, k[:, :20], v[:, :20], False,
                                             scale)
    o_b, l_b = fa._reference_attention_torch(q, k[:, 20:], v[:, 20:], False,
                                             scale)
    o, l = merge_partials(*merge_partials(None, None, o_a, l_a), o_b, l_b)
    torch.testing.assert_close(o, whole.float(), atol=2e-6, rtol=0)
    torch.testing.assert_close(l, lse, atol=2e-6, rtol=0)


@pytest.mark.parametrize("n,causal", [(2, True), (4, True), (4, False)])
def test_plain_ring_is_whole_attention(n, causal):
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(5))
    want, _ = fa._reference_attention_torch(q, k, v, causal, D ** -0.5)
    got = ring_attention_plain(q, k, v, n, causal)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
