"""The port's Mixture-of-Experts layer against the JAX package's, on the CPU.

`ray_tpu_torch.parallel.moe` against `ray_tpu.parallel.moe` on the same
numpy inputs: the routing tensors of `top_k_gating` exactly (ties, drops
past capacity and none), `moe_layer`'s output, aux loss and gradients in
fp32, and the index form of the dispatch: no [T, E, C] tensor is made.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import mixtral as jm
from ray_tpu.parallel import moe as jmoe
from ray_tpu_torch.models import mixtral as tm
from ray_tpu_torch.parallel import moe as tmoe

T, E, K, D, F = 64, 4, 2, 32, 48
# fp32 on both sides: the same products in another order. The aux loss is
# a sum of E products of means. The gate probabilities: XLA's exp and
# torch's differ by one ulp on some fp32 inputs, so the combine
# weights agree to a few ulp where the dispatch agrees exactly.
AUX_TOL = 1e-6
PROB_RTOL = 5e-7
OUT_RTOL, OUT_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
# The least gap between the k-th and (k+1)-th probability that a routing
# compared across the two packages must keep: a closer pair could flip on
# fp32 noise, and a flip is reported as one, not hidden.
MARGIN = 1e-5


def _logits(case, seed=0):
    rng = np.random.default_rng(seed)
    if case == "tied":  # every expert equal: JAX picks experts 0 and 1
        return np.zeros((T, E), np.float32)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    if case == "drops":  # experts 0 and 1 favoured past their capacity
        logits += np.array([1.5, 1.0, 0.0, 0.0], np.float32)
    return logits


# (logits, capacity_factor): drops at 1.25 on skewed logits, none at 8.0
# (as tests/test_models.py takes it), and the all-tied gate.
CASES = {"drops": ("drops", 1.25), "no_drops": ("random", 8.0),
         "tied": ("tied", 1.25)}


def _gap(probs, k=K):
    top = np.sort(probs, axis=-1)[:, ::-1]
    return float((top[:, k - 1] - top[:, k]).min())


@pytest.mark.parametrize("case", list(CASES))
def test_top_k_gating_matches_jax(case):
    """The dispatch tensor exactly; the combine weights at the same
    places, to a few ulp."""
    kind, factor = CASES[case]
    logits = _logits(kind)
    cap = tmoe.capacity(T, E, K, factor)
    assert cap == max(1, int(factor * T * max(K, 1) / E))
    jd, jc, jaux = jmoe.top_k_gating(jnp.asarray(logits), K, cap)
    td, tc, taux = tmoe.top_k_gating(torch.from_numpy(logits), K, cap)
    assert td.shape == tc.shape == (T, E, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy() != 0, np.asarray(jd) != 0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=PROB_RTOL,
                               atol=0)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0,
                               atol=AUX_TOL)
    kept = int(td.sum())
    if case == "no_drops":
        assert kept == T * K
    else:
        assert kept < T * K  # some choices went past capacity
    if case == "tied":  # experts 0 and 1 only, slots in token order
        assert not td[:, 2:].any()
        assert int(td[:, 0].sum()) == int(td[:, 1].sum()) == cap
    else:
        probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
        assert _gap(probs) > MARGIN


def test_route_gives_first_choices_priority():
    """Every token's first choice takes a slot before any token's second:
    the first choices of expert 0 hold its slots 0.., the second choices
    follow, in token order."""
    logits = torch.full((6, 3), -5.0)
    logits[:, 0] = 0.0
    logits[:3, 1] = 1.0   # tokens 0-2: 1st choice 1, 2nd choice 0
    logits[3:, 2] = -1.0  # tokens 3-5: 1st choice 0, 2nd choice 2
    r = tmoe.route(logits, 2, capacity=4)
    assert r.expert.tolist() == [[1, 0]] * 3 + [[0, 2]] * 3
    assert r.slot[3:, 0].tolist() == [0, 1, 2]   # first choices of 0
    assert r.slot[:3, 1].tolist() == [3, 4, 5]   # then the second ones
    assert r.keep[:3, 1].tolist() == [True, False, False]


def _expert_params(seed=1):
    rng = np.random.default_rng(seed)
    scale = (2.0 / (D + F)) ** 0.5
    return {"w_gate": rng.standard_normal((E, D, F)) * scale,
            "w_up": rng.standard_normal((E, D, F)) * scale,
            "w_down": rng.standard_normal((E, F, D)) * scale}


# capacity_factor of the layer: 0.5 leaves slots for half the choices;
# 8.0 for all; the zero gate ties every expert and drops past capacity.
LAYER_CASES = {"drops": 0.5, "no_drops": 8.0, "tied": 1.25}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_jax_with_gradients(case):
    factor = LAYER_CASES[case]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((T, D)).astype(np.float32)
    gate_w = (np.zeros((D, E), np.float32) if case == "tied" else
              rng.standard_normal((D, E)).astype(np.float32) * 0.5)
    cot = rng.standard_normal((T, D)).astype(np.float32)
    experts = {k: v.astype(np.float32) for k, v in _expert_params().items()}

    def jax_obj(x, gate_w):
        out, aux = jmoe.moe_layer(x, gate_w, jm._expert_ffn,
                                  {k: jnp.asarray(v)
                                   for k, v in experts.items()},
                                  k=K, capacity_factor=factor)
        return jnp.sum(out * cot) + 0.3 * aux, (out, aux)

    (_, (jout, jaux)), (jgx, jgg) = jax.jit(jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                                jnp.asarray(gate_w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tg = torch.from_numpy(gate_w).requires_grad_(True)
    out, aux = tmoe.moe_layer(tx, tg, tm._expert_ffn,
                              {k: torch.from_numpy(v)
                               for k, v in experts.items()},
                              k=K, capacity_factor=factor)
    gx, gg = torch.autograd.grad(
        torch.sum(out * torch.from_numpy(cot)) + 0.3 * aux, (tx, tg))
    # The same choices on both sides (a flip would show here by name).
    jexp = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(gate_w)),
                         K)[1]
    r = tmoe.route(tx.detach() @ tg.detach(), K,
                   tmoe.capacity(T, E, K, factor))
    np.testing.assert_array_equal(r.expert.numpy(), np.asarray(jexp))
    assert bool(r.keep.all()) == (case == "no_drops")
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=OUT_RTOL, atol=OUT_ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=0,
                               atol=AUX_TOL)
    for got, want in ((gx, jgx), (gg, jgg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(want).max())


class _LargestTensor(TorchDispatchMode):
    """Records the most elements of any tensor an operator returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in jax.tree_util.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def test_moe_layer_dispatches_by_index_and_compiles_whole():
    """No operator of the layer, forward or backward, makes a tensor of
    T*E*C elements (the JAX layer's dispatch and combine), and the layer
    traces as one graph at static shapes."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    gate_w = torch.from_numpy(rng.standard_normal((D, E)).astype(np.float32))
    experts = {k: torch.from_numpy(v.astype(np.float32))
               for k, v in _expert_params().items()}
    layer = partial(tmoe.moe_layer, expert_fn=tm._expert_ffn,
                    expert_params=experts, k=K, capacity_factor=1.25)
    cap = tmoe.capacity(T, E, K, 1.25)
    x.requires_grad_(True)
    with _LargestTensor() as mode:
        out, aux = layer(x, gate_w)
        torch.autograd.grad(out.sum() + aux, x)
    assert mode.largest < T * E * cap
    torch._dynamo.reset()
    try:
        compiled = torch.compile(layer, backend="aot_eager", fullgraph=True,
                                 dynamic=False)
        cout, caux = compiled(x, gate_w)
    finally:
        torch._dynamo.reset()
    np.testing.assert_array_equal(cout.detach().numpy(),
                                  out.detach().numpy())
    assert float(caux.detach()) == float(aux.detach())
