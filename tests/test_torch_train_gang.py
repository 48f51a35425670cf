"""`chip_smoke.py`'s Train gang, rehearsed on the CPU: phase (p) (the worker
side of `TorchBackend` at world 1 in the script's process) and the (l-3)
part `cards_train_gang` (four spawned ranks that join by themselves), at
tiny sizes on gloo, with the card stubbed and the kernels counted as
tests/test_torch_flash_sm90.py rehearses main(). Both run
`ray_tpu_torch.parallel.train_gang_cases.train_run`, the functions a runtime
worker runs: bind, join at a host and a free port, the mesh through a
collective group, the per-position feed, the save and the restore onto the
mesh. (p) takes ~17 s alone, the part ~40 s; their size is pinned by
their launch counts and lines, not by a wall-clock bound."""

import json
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch.parallel import train_gang_cases


def _rehearse(monkeypatch, tmp_path, request, cards):
    from test_torch_flash_sm90 import rehearse_on_the_cpu

    torch._dynamo.reset()
    request.addfinalizer(torch._dynamo.reset)
    smoke = rehearse_on_the_cpu(monkeypatch, tmp_path, request)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(smoke, "bench_config", smoke.tiny_train_config)
    monkeypatch.setattr(smoke, "TRAIN_ATTN", (2, 64, 64, 4, 2, 32, True))
    monkeypatch.setattr(smoke, "GANG_CARDS", dict(
        plan={"fsdp": 2, "tp": 2}, layers=1, batch=4, seq=64))
    return smoke


def _line(lines, tag):
    found = [line for line in lines if line.startswith(tag)]
    assert found, tag
    return found[0]


def test_chip_smoke_phase_p_rehearsed_on_the_cpu(monkeypatch, capsys,
                                                 tmp_path, request):
    """`chip_smoke.py --only p`: the world-1 gang in the script's process,
    three fed steps, the save, the gang left (no process group after it),
    joined again, the state restored bit for bit and step 3 again within
    1e-4; 2L / L / L launches over the four steps; the last line's ok
    object."""
    smoke = _rehearse(monkeypatch, tmp_path, request, 1)
    assert smoke.main(["--only", "p"]) == 0
    assert not dist.is_initialized()
    lines = capsys.readouterr().out.strip().splitlines()
    gang = _line(lines, "[p] 1 rank(s) on cards [None] then [None] (cpu)")
    assert "restored bit for bit on every rank True" in gang
    assert "data positions [[0, 1]]" in gang
    _line(lines, "[p] (NVIDIA H100 80GB HBM3, 700.00 W) the gang's training "
          "path at world 1, 1 layer(s), B=2 S=64: 4 steps")
    # four steps at GANG_LAYERS = 1 layer, 2L / L / L each
    assert json.loads(lines[-2]) == {"train_gang_launches": {
        "flash_fwd": 8, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}}
    assert json.loads(lines[-1])["ok"] is True


def test_chip_smoke_part_train_gang_rehearsed_on_the_cpu(
        monkeypatch, capsys, tmp_path, request):
    """`chip_smoke.py --only l --part train_gang` with four cards (stubbed;
    gloo CPU ranks that see no card here): two gangs of spawned ranks over
    fsdp=2 x tp=2, each rank at its data position, the global batches
    assembled exactly, the restored state bit for bit on every rank, the
    restarted step within 1e-4."""
    smoke = _rehearse(monkeypatch, tmp_path, request, 4)
    assert smoke.main(["--only", "l", "--part", "train_gang"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    gang = _line(lines, "[l-3 train_gang] 4 rank(s)")
    assert "data positions [[0, 2], [0, 2], [1, 2], [1, 2]]" in gang
    assert ("mesh {'pp': 1, 'dp': 1, 'fsdp': 2, 'ep': 1, 'sp': 1, 'tp': 2}"
            in gang)
    assert "restored bit for bit on every rank True" in gang
    # two gangs of four spawned ranks at GANG_CARDS' size: three steps, the
    # third run again by the second gang
    assert "restarted step 3" in gang
    _line(lines, "[l-3] cards_train_gang:")
    assert json.loads(lines[-1])["ok"] is True


def test_local_digests_tell_states_apart():
    """The digests `cards_train_gang` compares: equal for the same bits
    (bf16 included) and the same scalars, different for one ulp, a numpy
    leaf, or a step count that is a Python int (AdamWState.count)."""
    a = {"w": torch.arange(6, dtype=torch.float32).to(torch.bfloat16),
         "s": torch.tensor(3, dtype=torch.int32), "n": np.ones(2),
         "count": 2}

    def copy():
        return {"w": a["w"].clone(), "s": a["s"].clone(),
                "n": a["n"].copy(), "count": a["count"]}

    digests = train_gang_cases.local_digests
    assert digests(a) == digests(copy())
    assert len(digests(a)) == 4
    b = copy()
    b["w"].view(torch.int16)[1] += 1
    assert digests(a) != digests(b)
    b = copy()
    b["n"][0] = 0
    assert digests(a) != digests(b)
    b = copy()
    b["count"] = 0
    assert digests(a) != digests(b)


def test_a_fresh_thread_reaches_the_bound_card(monkeypatch):
    """A CUDA card is current per thread, and the runtime runs a worker's
    calls and its train function on threads of their own: a thread that
    reaches the mesh (`get_mesh`) or the feed without naming a device uses
    the card `bind_card` bound on another thread, not card 0. The card is
    stubbed: set_device and current_device keep a current card per
    thread, as CUDA does."""
    from ray_tpu_torch._private import gang
    from ray_tpu_torch.data import dataset
    from ray_tpu_torch.train import spmd

    current = threading.local()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: setattr(
        current, "index", d.index if isinstance(d, torch.device) else d))
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: getattr(current, "index", 0))
    monkeypatch.setattr(gang, "card_id", lambda i: f"pci-{i}")
    monkeypatch.setattr(gang, "_bound", {"card": None})
    monkeypatch.setitem(spmd._state, "mesh", "the mesh")
    on_thread = train_gang_cases.on_thread

    assert on_thread(gang.bind_card, 2, node_ranks=4) == "pci-2"
    assert torch.cuda.current_device() == 0  # this thread was not bound

    def train_fn():
        before = torch.cuda.current_device()
        return before, spmd.get_mesh(), torch.cuda.current_device()

    assert on_thread(train_fn) == (0, "the mesh", 2)
    card = torch.device("cuda", 2)

    def feed():
        return (torch.cuda.current_device(),
                dataset._feed_device(None, sharding=("a placement",)),
                dataset._feed_device("cuda", None),
                torch.cuda.current_device())

    assert on_thread(feed) == (0, card, card, 2)
    assert on_thread(gang.rank_device) == card


@pytest.mark.parametrize("restore", [False, True])
def test_train_run_refuses_a_card_it_does_not_have(restore, tmp_path):
    """The default device is the card: without CUDA the worker side raises
    before it joins any gang, restoring or not."""
    from ray_tpu_torch.models import llama

    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        train_gang_cases.train_run(
            0, 1, f"file://{tmp_path}/store", 0, 1, "g",
            llama.LlamaConfig.tiny(), {}, np.zeros((1, 2, 9), np.int64), 1,
            1, str(tmp_path / "ckpt"), restore)
    assert not dist.is_initialized()
