"""The port's GPU glue on the CPU: the NVIDIA detector (its probe process
stubbed) and per-rank binding, the backend probe, the gang launcher's
failure handling, and a rehearsal of chip_smoke.py's phase (l).

Phase (l) runs here as the one-card branch does on the chip: (l-1) a
world-1 gang (gloo in this process, where the card has NCCL) through the
sharded code on a 1 x ... x 1 mesh against the unsharded step, and (l-2)
`graft_entry.dryrun_multichip(4, device="cpu")` on 4 spawned gloo ranks.
"""

import json
import multiprocessing
import operator
import socket
import time

import pytest
import torch
import torch.distributed as dist

from ray_tpu_torch._private import backend_probe
from ray_tpu_torch._private.accelerators import nvidia
from ray_tpu_torch.train import backend


def _stub_cards(monkeypatch, names, memory=85_000_000_000):
    """The probe process answers these cards, the i-th with memory + i
    bytes."""
    cards = [[n, memory + i] for i, n in enumerate(names)]
    monkeypatch.setattr(backend_probe, "_PROBE",
                        f"import json; print(json.dumps({cards!r}))")


def test_detect_gpu_reads_every_card(monkeypatch):
    _stub_cards(monkeypatch, ["NVIDIA H100 80GB HBM3"] * 2)
    info = nvidia.probe_gpu()
    assert info == nvidia.GpuInfo(2, ("NVIDIA H100 80GB HBM3",) * 2,
                                  (85_000_000_000, 85_000_000_001))
    assert info.accelerator_type == "H100 SXM"
    _stub_cards(monkeypatch, [])
    assert nvidia.probe_gpu() is None


def test_apply_gpu_detection_merges_and_keeps_what_was_set(monkeypatch):
    _stub_cards(monkeypatch, ["NVIDIA H100 PCIe"] * 4)
    given = {"CPU": 8.0}
    resources, labels = nvidia.node_advertisement(given, {}, env={})
    assert resources == {"CPU": 8.0, "GPU": 4.0, "GPU-H100-PCIe": 4.0}
    assert labels == {nvidia.ACCELERATOR_TYPE_LABEL: "H100 PCIe"}
    assert given == {"CPU": 8.0}
    resources, labels = nvidia.node_advertisement(
        {"GPU": 2.0}, {nvidia.ACCELERATOR_TYPE_LABEL: "x"}, env={})
    assert resources == {"GPU": 2.0, "GPU-H100-PCIe": 2.0}
    assert labels == {nvidia.ACCELERATOR_TYPE_LABEL: "x"}
    # a card the peak table does not know keeps its own name
    _stub_cards(monkeypatch, ["Some Other GPU"])
    resources, labels = nvidia.node_advertisement(env={})
    assert labels[nvidia.ACCELERATOR_TYPE_LABEL] == "Some Other GPU"
    assert resources == {"GPU": 1.0, "GPU-Some-Other-GPU": 1.0}
    _stub_cards(monkeypatch, [])
    assert nvidia.node_advertisement({}, {}, env={}) == ({}, {})


def test_visible_devices_env_binds_a_rank_to_its_cards():
    env = nvidia.visible_devices_env([3], {"PATH": "/bin"})
    assert env == {"PATH": "/bin", "CUDA_VISIBLE_DEVICES": "3"}
    assert nvidia.visible_devices_env([0, 2], {})["CUDA_VISIBLE_DEVICES"] \
        == "0,2"
    assert nvidia.visible_devices_env([], {})["CUDA_VISIBLE_DEVICES"] == ""


def test_a_rank_binds_within_the_cards_its_parent_was_given(monkeypatch):
    given = {"CUDA_VISIBLE_DEVICES": "4,5,6,7"}
    assert nvidia.visible_devices_env([1], given)["CUDA_VISIBLE_DEVICES"] \
        == "5"
    assert nvidia.visible_devices_env([0, 3], given)[
        "CUDA_VISIBLE_DEVICES"] == "4,7"
    uuids = {"CUDA_VISIBLE_DEVICES": "GPU-a, GPU-b"}
    assert nvidia.visible_devices_env([1], uuids)["CUDA_VISIBLE_DEVICES"] \
        == "GPU-b"
    with pytest.raises(RuntimeError, match="allotment of 4"):
        nvidia.visible_devices_env([4], given)
    # the launcher's per-rank environment, from its own process's
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "4,5,6,7")
    assert backend._rank_env(1, "cuda") == {"CUDA_VISIBLE_DEVICES": "5"}
    assert backend._rank_env(1, "cpu")["CUDA_VISIBLE_DEVICES"] == ""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert backend._rank_env(1, "cuda") == {"CUDA_VISIBLE_DEVICES": "1"}


def test_backend_probe_sees_no_card_here_and_cpu_env_hides_them(
        monkeypatch):
    assert backend_probe.cuda_device_count() == 0
    monkeypatch.setattr(backend_probe, "cuda_device_count", lambda t: 3)
    assert backend_probe.backend_alive(3) and not backend_probe.backend_alive(4)
    env = backend_probe.force_cpu_env({"CUDA_VISIBLE_DEVICES": "0,1"})
    assert env["CUDA_VISIBLE_DEVICES"] == "" and env["OMP_NUM_THREADS"] == "1"


def test_torch_config_picks_nccl_for_cuda_and_gloo_for_cpu():
    assert backend.TorchConfig().backend_for("cuda") == "nccl"
    assert backend.TorchConfig().backend_for("cpu") == "gloo"
    assert backend.TorchConfig(backend="gloo").backend_for("cuda") == "gloo"
    with pytest.raises(ValueError):
        backend.TorchConfig().backend_for("mps")


def test_launch_gang_returns_in_rank_order_and_fails_fast():
    assert backend.launch_gang(dist.get_rank, 3, "cpu", 120) == [0, 1, 2]
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        backend.launch_gang(operator.truediv, 2, "cpu", 120, args=(1, 0))
    assert not multiprocessing.active_children()


def test_the_advertised_port_is_held_until_the_join():
    """The process that advertises a gang's port serves the rendezvous on
    it from then on: nothing else can bind it before the join, and rank 0
    joining in this process takes that store."""
    from ray_tpu_torch._private import gang

    addr = gang.gang_address()
    with socket.socket() as other:
        other.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        with pytest.raises(OSError):
            other.bind(("", addr["port"]))
    method = f"tcp://{addr['hostname']}:{addr['port']}"
    try:
        assert backend.init_process_group(0, 1, method, "cpu").type == "cpu"
        assert dist.get_world_size() == 1
        assert addr["port"] not in gang._held
    finally:
        backend.destroy_process_group()


def _port_is_free(port):
    with socket.socket() as other:
        other.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            other.bind(("", port))
        except OSError:
            return False
    return True


def test_an_advertised_port_that_no_join_takes_is_released():
    """A process serves only the rendezvous it advertised last; a process
    that keeps its gang, and a join that fails, stop serving theirs."""
    from ray_tpu_torch._private import gang

    def method(addr):
        return f"tcp://{addr['hostname']}:{addr['port']}"

    first, addr = gang.gang_address(), gang.gang_address()
    assert list(gang._held) == [addr["port"]] and _port_is_free(first["port"])
    with pytest.raises(Exception, match="[Tt]imed? ?out|timeout"):
        # rank 1 never comes
        gang.init_process_group(0, 2, method(addr), "cpu", init_timeout_s=1)
    assert not dist.is_initialized()
    assert gang._held == {} and _port_is_free(addr["port"])
    addr = gang.gang_address()
    try:
        assert gang.join_gang(method(addr), 1, 0, "cpu") == "cpu"
        again = gang.gang_address()
        assert not _port_is_free(again["port"])
        assert gang.join_gang(method(again), 1, 0, "cpu") == "cpu"  # kept
        assert gang._held == {} and _port_is_free(again["port"])
    finally:
        backend.destroy_process_group()


def test_a_gang_meets_at_a_port_that_no_process_advertised():
    """A tcp address that no rank's process serves (a `coordinator_port`):
    rank 0 serves the store there and the others reach it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert backend.launch_gang(dist.get_world_size, 2, "cpu", 120,
                               init_method=f"tcp://127.0.0.1:{port}") == [2, 2]


def test_a_hung_gang_fails_its_call_within_the_timeout():
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="did not finish"):
        backend.launch_gang(time.sleep, 2, "cpu", timeout_s=10, args=(600,))
    assert time.perf_counter() - t0 < 60
    assert not multiprocessing.active_children()


def test_launch_gang_on_cuda_needs_a_card_per_rank():
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards"):
        backend.launch_gang(dist.get_rank, 2, "cuda", 30)


def test_initialize_distributed_is_idempotent_for_one_binding(tmp_path):
    from ray_tpu_torch.parallel.mesh import initialize_distributed

    method = f"file://{tmp_path}/store"
    try:
        assert initialize_distributed(method, 1, 0, "cpu").type == "cpu"
        assert initialize_distributed(method, 1, 0, "cpu").type == "cpu"
        assert dist.get_world_size() == 1
        with pytest.raises(RuntimeError, match="already in"):
            backend.init_process_group(0, 1, method, "cpu")
    finally:
        backend.destroy_process_group()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="NCCL rank needs a CUDA card"):
        backend.init_process_group(0, 1, method, "cuda")


def _rehearse_phase_l(monkeypatch, tmp_path, request):
    """chip_smoke.py loaded for a phase (l) rehearsal on a one-card machine:
    the card stubbed and the kernels counted (as
    tests/test_torch_flash_sm90.py rehearses main()), the bench
    configuration tiny."""
    from test_torch_flash_sm90 import rehearse_on_the_cpu

    smoke = rehearse_on_the_cpu(monkeypatch, tmp_path, request)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(smoke, "bench_config", smoke.tiny_train_config)
    monkeypatch.setattr(smoke, "TRAIN_ATTN", (2, 64, 64, 4, 2, 32, True))
    return smoke


def _no_launches():
    return {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_chip_smoke_phase_l_rehearsed_on_the_cpu(monkeypatch, capsys,
                                                 tmp_path, request):
    """chip_smoke.py's phase (l) on a one-card machine, at tiny sizes on the
    CPU: (l-1)'s eager checks (the world-1 sharded step equal to the
    unsharded one, 2L / L / L launches a step), then (l-2), which asks for
    the 4-rank dry run on CPU ranks and says so. The dry run itself is
    rehearsed by test_chip_smoke_phase_l2_dry_run_rehearsed_on_the_cpu,
    (l-1)'s compiled, zoo and engine checks by the tests after it."""
    from ray_tpu_torch import graft_entry

    smoke = _rehearse_phase_l(monkeypatch, tmp_path, request)
    monkeypatch.setattr(smoke, "phase_spmd_world1_compiled", _no_launches)
    monkeypatch.setattr(smoke, "phase_spmd_world1_zoo",
                        lambda seed: _no_launches())
    monkeypatch.setattr(smoke, "phase_spmd_world1_engine", lambda seed: None)
    asked = []

    def dry_run(n, device=None):
        asked.append((n, device))
        return ["[dryrun stub] all multichip checks passed"]

    monkeypatch.setattr(graft_entry, "dryrun_multichip", dry_run)
    monkeypatch.setattr(smoke, "cards_collective",
                        lambda n, launches, device=None: asked.append(
                            ("collective", n, device)))
    counts = smoke.phase_spmd()
    assert not dist.is_initialized()
    assert asked == [(4, "cpu"), ("collective", 4, "cpu")]
    lines = capsys.readouterr().out.strip().splitlines()
    for text in ("[l] 1 GPU(s) visible: (l-1), then (l-2)",
                 "[l-1] tiny fp32, world-1 mesh, 3 steps",
                 "[l-1] bench config (B=2 S=64",
                 "[l-1] world-1 mesh collective group on cpu",
                 "[l-2] this machine has 1 GPU(s); the 4-rank dry run and "
                 "the collective groups run on CPU ranks",
                 "[l-2] the CPU-rank dry run took",
                 "[l-2] the collective groups on 4 gloo CPU ranks took",
                 "[l] launches on the SPMD paths"):
        assert any(line.startswith(text) for line in lines), text
    assert any("identity eagerly True, compiled (aot_eager, fullgraph) True"
               in line for line in lines)
    layers = smoke.tiny_train_config().n_layers
    # (l-1)'s sharded steps: 3 of the tiny config and 3 of the bench
    # config (tiny here), 2L / L / L each; the unsharded steps they are
    # held to do not count.
    assert counts["spmd"] == {"flash_fwd": 6 * 2 * layers,
                              "flash_bwd_dq": 6 * layers,
                              "flash_bwd_dkv": 6 * layers}


def test_chip_smoke_phase_l2_dry_run_rehearsed_on_the_cpu(monkeypatch, capsys,
                                                          tmp_path, request):
    """(l-2): `graft_entry.dryrun_multichip(4, device="cpu")` on 4 spawned
    gloo ranks, as phase (l) runs it on a one-card machine: every check of
    the dry run (the sharded step, the ring against the gathered sequence,
    the compiled sharded step against the eager one, the pipeline, the MoE
    dispatch, a Mixtral step over ep, the multi-slice mesh, tp=2 paged
    decode) passes and says so."""
    smoke = _rehearse_phase_l(monkeypatch, tmp_path, request)
    # The collective groups' part is rehearsed on its own below.
    monkeypatch.setattr(smoke, "cards_collective",
                        lambda n, launches, device=None: None)
    smoke.phase_spmd_cpu_ranks(1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("[l-2] this machine has 1 GPU(s); the 4-rank "
                               "dry run and the collective groups run on CPU "
                               "ranks") for line in lines)
    dry = [line for line in lines if line.startswith("[dryrun")]
    assert len(dry) == 10 and all(
        line.startswith("[dryrun cpu-ranks: 4 gloo CPU ranks, no GPU]")
        for line in dry)
    assert "ring over sp=2" in "".join(dry)
    assert "compiled sharded step (aot_eager) OK" in "".join(dry)
    assert "Mixtral step (dp=2 x ep=2) OK" in "".join(dry)
    assert "tp=2 paged decode OK" in dry[-2]
    assert dry[-1].endswith("all multichip checks passed")


def test_chip_smoke_phase_l1_compiled_rehearsed_on_the_cpu(
        monkeypatch, capsys, tmp_path, request):
    """(l-1)'s compiled sharded steps (aot_eager here) against the compiled
    unsharded ones, the tiny config and the bench widths cut to 1 layer,
    with 2L / L / L launches a step on their own count; the zoo and engine
    checks are rehearsed by the next test, the (l-2) dry run by the one
    above."""
    smoke = _rehearse_phase_l(monkeypatch, tmp_path, request)
    # The bench widths (the tiny config here) at the tiny config's depth:
    # the cut config is then the tiny one, whose programs torch.compile
    # finds in its cache.
    monkeypatch.setattr(smoke, "SPMD_COMPILED_LAYERS",
                        smoke.tiny_train_config().n_layers)
    monkeypatch.setattr(smoke, "phase_spmd_cpu_ranks", lambda n: None)
    monkeypatch.setattr(smoke, "phase_spmd_world1_zoo",
                        lambda seed: _no_launches())
    monkeypatch.setattr(smoke, "phase_spmd_world1_engine", lambda seed: None)
    counts = smoke.phase_spmd()
    assert not dist.is_initialized()
    lines = capsys.readouterr().out.strip().splitlines()
    for text in ("[l-1] compiled (aot_eager) tiny fp32, world-1 mesh",
                 "[l-1] compiled (aot_eager) bench widths cut to 2 layer(s)",
                 "[l-1] the compiled sharded checks",
                 "[l-1] collective report of the compiled sharded step"):
        assert any(line.startswith(text) for line in lines), text
    report = json.loads(next(
        line for line in lines if line.startswith("[l-1] collective report")
    ).split("both programs): ")[1])
    # one world-1 rank: the global norm's all-reduce and the loss's
    assert report["all-reduce"]["count"] >= 1
    assert report["total"]["count"] == sum(
        report[k]["count"] for k in report if k != "total")
    layers = smoke.tiny_train_config().n_layers
    # 3 steps of the tiny config and 3 at the bench widths cut to
    # SPMD_COMPILED_LAYERS (the tiny config cut so here), 2L / L / L each.
    cut = smoke.SPMD_COMPILED_LAYERS
    assert counts["spmd_compiled"] == {
        "flash_fwd": 3 * 2 * (layers + cut),
        "flash_bwd_dq": 3 * (layers + cut),
        "flash_bwd_dkv": 3 * (layers + cut)}


def test_chip_smoke_phase_l1_zoo_and_engine_rehearsed_on_the_cpu(
        monkeypatch, capsys, tmp_path, request):
    """(l-1)'s tiny Mixtral (compiled, aot_eager here), ViT and T5 sharded
    steps against their unsharded ones, Mixtral's launches on their own
    count, and the dense engine with mesh= at tp=1 giving the engine's
    tokens without it."""
    smoke = _rehearse_phase_l(monkeypatch, tmp_path, request)
    monkeypatch.setattr(smoke, "phase_spmd_cpu_ranks", lambda n: None)
    monkeypatch.setattr(smoke, "phase_spmd_world1_compiled", _no_launches)
    counts = smoke.phase_spmd()
    assert not dist.is_initialized()
    lines = capsys.readouterr().out.strip().splitlines()
    for text in ("[l-1] tiny Mixtral fp32 compiled (aot_eager), world-1 mesh",
                 "[l-1] tiny ViT fp32 eager, world-1 mesh",
                 "[l-1] tiny T5 fp32 eager, world-1 mesh",
                 "[l-1] dense engine, tiny fp32, mesh= at tp=1"):
        assert any(line.startswith(text) for line in lines), text
    assert any("identical True" in line for line in lines
               if line.startswith("[l-1] dense engine"))
    # the tiny Mixtral's 3 steps, its 2 layers under "dots"
    assert counts["zoo_mesh"] == {"flash_fwd": 3 * 2 * 2,
                                  "flash_bwd_dq": 3 * 2,
                                  "flash_bwd_dkv": 3 * 2}


def test_chip_smoke_only_l_part_runs_one_four_card_part_on_the_cpu(
        monkeypatch, capsys, tmp_path, request):
    """`chip_smoke.py --only l --part pipeline` with four cards (stubbed;
    gloo CPU ranks here): the build, then that (l-3) part alone (the pp=4
    pipeline's output and gradients against the stages in sequence), its
    lines and the last line's ok object; --part without --only l is
    refused."""
    smoke = _rehearse_phase_l(monkeypatch, tmp_path, request)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(smoke, "SPMD_PIPE", dict(m=4, mb=(2, 8),
                                                 rel_tol=1e-4))
    assert smoke.main(["--only", "l", "--part", "pipeline"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("[l-3] pipeline pp=4 of SwiGLU stages")
               and "4 microbatches of (2, 8) tokens" in line
               for line in lines)
    assert any(line.startswith("[l-3] cards_pipeline:") for line in lines)
    assert not any(line.startswith(("[l-1]", "[dryrun")) for line in lines)
    assert json.loads(lines[-1])["ok"] is True
    with pytest.raises(SystemExit):
        smoke.main(["--part", "pipeline"])


def test_chip_smoke_only_l_part_collective_rehearsed_on_the_cpu(
        monkeypatch, capsys, tmp_path, request):
    """`chip_smoke.py --only l --part collective` with four cards (stubbed;
    gloo CPU ranks here, so no bus bandwidth is timed): the mesh groups'
    collectives eagerly and compiled exact against numpy on every rank, the
    typed errors and the host path, and the last line's ok object."""
    smoke = _rehearse_phase_l(monkeypatch, tmp_path, request)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert smoke.main(["--only", "l", "--part", "collective"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    for text in ("[l-3] collective groups (4 gloo CPU ranks, no GPU): mesh "
                 "collectives eager and compiled over ['dp4', 'tp_of_2x2', "
                 "'2x2'], exact against numpy on every rank: True",
                 "[l-3] collective groups: typed errors",
                 "[l-3] collective groups: the host path",
                 "[l-3] cards_collective:", "[phases] seconds by phase"):
        assert any(line.startswith(text) for line in lines), text
    assert not any("False" in line for line in lines
                   if line.startswith("[l-3] collective groups"))
    assert json.loads(lines[-1])["ok"] is True
