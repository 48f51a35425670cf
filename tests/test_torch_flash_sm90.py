"""What the CPU can hold of the port's Hopper (sm_90a) flash kernels.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
Here: how they are built (flags, the build key over every source and
header), which design each (kernel, dtype, head size) takes, the register
budget their warpgroups share, the parser of ptxas's report, and a
rehearsal of `chip_smoke.py`'s `main()` at tiny sizes with the kernels
routed to counting wrappers of their plain versions.
"""

import dataclasses
import importlib.util
import json
import re
import sys
import time
from pathlib import Path

import pytest
import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as fa

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "ray_tpu_torch" / "ops" / "csrc"

# (kernel, dtype, head size) -> design, as the C sources dispatch.
DESIGNS = {
    **{("flash_fwd", torch.float32, d): "fma" for d in (32, 64, 128)},
    ("flash_fwd", torch.bfloat16, 32): "wmma",
    ("flash_fwd", torch.bfloat16, 64): "wgmma",
    ("flash_fwd", torch.bfloat16, 128): "wgmma",
    **{("flash_bwd_dq", torch.float32, d): "fma" for d in (32, 64, 128)},
    ("flash_bwd_dq", torch.bfloat16, 32): "wmma",
    ("flash_bwd_dq", torch.bfloat16, 64): "wgmma",
    ("flash_bwd_dq", torch.bfloat16, 128): "wgmma",
    **{("flash_bwd_dkv", torch.float32, d): "fma" for d in (32, 64, 128)},
    ("flash_bwd_dkv", torch.bfloat16, 32): "wmma",
    ("flash_bwd_dkv", torch.bfloat16, 64): "wgmma",
    ("flash_bwd_dkv", torch.bfloat16, 128): "wgmma",
}


@pytest.mark.parametrize("kernel,dtype,d", [
    (k, t, d) for k in fa.KERNELS for t in fa.KERNEL_DTYPES
    for d in fa.KERNEL_HEAD_DIMS])
def test_kernel_variant_for_every_dtype_and_head_size(kernel, dtype, d):
    assert fa.kernel_variant(kernel, dtype, d) == DESIGNS[(kernel, dtype, d)]


def test_kernel_variant_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="no kernel 'flash_bwd'"):
        fa.kernel_variant("flash_bwd", torch.bfloat16, 128)
    with pytest.raises(ValueError, match="head size 48"):
        fa.kernel_variant("flash_fwd", torch.bfloat16, 48)
    with pytest.raises(ValueError, match="float16"):
        fa.kernel_variant("flash_fwd", torch.float16, 64)
    # The library queries validate before they build anything.
    with pytest.raises(ValueError, match="no kernel"):
        fa.built_variant("nope", torch.bfloat16, 128)
    assert fa.sm90_smem_bytes("flash_fwd", torch.bfloat16, 32) == 0


def test_sources_name_every_design_they_dispatch_to():
    """Each library exports a `<kernel>_variant` for the table above, and
    the sm90 kernels live where the wrappers' designs say."""
    fwd = (CSRC / "flash_fwd.cu").read_text()
    bwd = (CSRC / "flash_bwd.cu").read_text()
    for src, kernel in ((fwd, "flash_fwd"), (bwd, "flash_bwd_dq"),
                        (bwd, "flash_bwd_dkv")):
        assert f'extern "C" const char* {kernel}_variant(' in src
        assert fa.KERNELS[kernel] == ("flash_fwd" if src is fwd
                                      else "flash_bwd")
    assert "flash_fwd_sm90_kernel" in fwd and '#include "flash_sm90.cuh"' in fwd
    assert "flash_bwd_dq_sm90_kernel" in bwd
    assert "flash_bwd_dkv_sm90_kernel" in bwd
    assert '#include "flash_sm90.cuh"' in bwd


def _sm90_kernel(kernel):
    """The constants of `<kernel>_sm90_kernel`'s namespace (the one its
    __launch_bounds__ names) and the kernel's body, read from its source."""
    src = (CSRC / f"{fa.KERNELS[kernel]}.cu").read_text()
    m = re.search(r"__launch_bounds__\((\w+)::THREADS, 1\)\s*\n"
                  rf"{kernel}_sm90_kernel\(", src)
    assert m, kernel
    ns = m.group(1)
    block = re.search(rf"namespace {ns} {{(.*?)}}  // namespace {ns}", src,
                      re.S).group(1)
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", block)}
    return consts, src[m.end():src.index("cudaError_t launch", m.end())]


@pytest.mark.parametrize("kernel", list(fa.KERNELS))
def test_sm90_register_budget_fits_the_block(kernel):
    """setmaxnreg can only move registers inside the block's own
    allocation: the producer warpgroup's and the consumers' new counts must
    add up to no more than what __launch_bounds__(THREADS, 1) gave the block
    at launch, or the consumers' increase waits forever."""
    consts, body = _sm90_kernel(kernel)
    threads = consts["THREADS"]
    dec = [int(x) for x in re.findall(r"regs_dec<(\d+)>", body)]
    inc = [int(x) for x in re.findall(r"regs_inc<(\d+)>", body)]
    assert len(dec) == len(inc) == 1
    per_thread = (65536 // threads) // 8 * 8  # ptxas rounds to 8
    for n in dec + inc:
        assert 24 <= n <= 256 and n % 8 == 0
    assert dec[0] * 128 + inc[0] * (threads - 128) <= per_thread * threads


@pytest.mark.parametrize("d", [64, 128])
def test_sm90_dq_tiles_fit_shared_memory_and_registers(d):
    """The dQ kernel's tiles, read from its source: two consumer warpgroups
    of 64 query rows; Q, dO and the (K, V) ring fit the 227 KB a block may
    take; and what a consumer thread holds at once fits its setmaxnreg
    budget with room for addressing. A 64 x N fp32 accumulator of a
    warpgroup is N / 2 registers a thread, its bf16 A fragments N / 4."""
    consts, body = _sm90_kernel("flash_bwd_dq")
    qrows, krows, stages = consts["QROWS"], consts["KROWS"], consts["STAGES"]
    assert qrows == 2 * 64 and consts["THREADS"] == 3 * 128
    assert krows % 16 == 0 and stages >= 2
    smem = (2 * qrows + 2 * stages * krows) * d * 2 + (1 + 2 * stages) * 8
    assert smem + 1024 <= 232_448  # + 1024 to align the base
    held = d // 2 + krows // 2 + krows // 2 + krows // 4  # dQ, S, dP, dS
    inc = int(re.search(r"regs_inc<(\d+)>", body).group(1))
    assert held + 64 <= inc


def test_sm90_header_changes_the_build_key_of_both_libraries(
        tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("flash_fwd.cu", "flash_bwd.cu", "flash_common.cuh",
                 "flash_sm90.cuh"):
        (src / name).write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", src)
    before = {n: _build.library_path(n) for n in ("flash_fwd", "flash_bwd")}
    (src / "flash_sm90.cuh").write_text("// two\n")
    after = {n: _build.library_path(n) for n in ("flash_fwd", "flash_bwd")}
    assert all(before[n] != after[n] for n in before)
    assert len(set(after.values())) == 2


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_every_nvcc_flag_precedes_the_source(tmp_path, name):
    cmd = _build.nvcc_command("nvcc", name, tmp_path / "x.so")
    assert cmd[-1].endswith(f"csrc/{name}.cu")
    assert cmd[:1 + len(_build.NVCC_FLAGS)] == ["nvcc", *_build.NVCC_FLAGS]
    arch = [f for f in cmd if f.startswith("arch=")]
    assert arch == ["arch=compute_90a,code=sm_90a"]
    assert "-lcuda" not in cmd  # the tensor-map encoder comes via cudart
    assert (CSRC / f"{name}.cu").exists()


def _load_chip_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rehearsal", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setitem(sys.modules, "chip_smoke_rehearsal", mod)
    return mod


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8f4ed862_12_flash_fwd_cu_b294bfd016flash_fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_PfiiiiNS_7StridesEfi' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8f4ed862_12_flash_fwd_cu_b294bfd016flash_fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_PfiiiiNS_7StridesEfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8f4ed862_12_flash_fwd_cu_b294bfd021flash_fwd_sm90_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiiilllfi' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8f4ed862_12_flash_fwd_cu_b294bfd021flash_fwd_sm90_kernelILi128EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiiiilllfi
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__8f4ed862_12_flash_fwd_cu_b294bfd016flash_fwd_kernelI13__nv_bfloat16Li32EEEvPKT_S4_S4_PS2_PfiiiiNS_7StridesEfi' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__8f4ed862_12_flash_fwd_cu_b294bfd016flash_fwd_kernelI13__nv_bfloat16Li32EEEvPKT_S4_S4_PS2_PfiiiiNS_7StridesEfi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 84 registers, used 1 barriers
"""


def test_ptxas_report_reads_each_kernel(monkeypatch):
    smoke = _load_chip_smoke(monkeypatch)
    assert smoke.ptxas_report(PTXAS_LOG) == [
        ("flash_fwd_kernel", "fp32", 128, 96, 0, 0),
        ("flash_fwd_sm90_kernel", "bf16", 128, 168, 12, 16),
        ("flash_fwd_kernel", "bf16", 32, 84, 0, 0),
    ]


def _counting(fn):
    def wrapper(*args, **kwargs):
        wrapper.launches += 1
        return fn(*args, **kwargs)
    wrapper.launches = 0
    return wrapper


def _plain_from_delta(q, k, v, do, lse, delta, causal, scale):
    """The plain backward from delta instead of o: any o' with
    rowsum(dO * o') = delta gives the same gradients."""
    dd = (do.float() * do.float()).sum(-1, keepdim=True)
    o = do.float() * delta.transpose(1, 2)[..., None] / dd
    return fa._flash_bwd_reference_torch(q, k, v, o, lse, do, causal, scale)


def test_chip_smoke_main_rehearsed_on_the_cpu(monkeypatch, capsys, tmp_path,
                                             request):
    """chip_smoke.main() end to end at tiny sizes: stubbed torch.cuda, the
    build replaced by a canned ptxas log, the kernels routed to counting
    wrappers of their plain versions. Every phase runs; the kernels line has
    the three entries with every field; the launch counts are the main
    paths'; the last line is the ok object."""
    from ray_tpu_torch.models import llama

    # One intra-op thread: the tensors are tiny, and where test workers
    # share the cores, a thread pool of every core in each of them makes
    # the run tens of times slower.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    t0 = time.perf_counter()
    smoke = _load_chip_smoke(monkeypatch)
    # The card, stubbed.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                        torch.backends.cuda.matmul.allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                        torch.backends.cudnn.allow_tf32)
    import ray_tpu_torch
    monkeypatch.setattr(ray_tpu_torch, "device_info", lambda: {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1})
    monkeypatch.setattr(smoke, "nvidia_smi_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(smoke, "DEVICE", "cpu")

    def host_ms(fn, iters=1, warmup=0):
        start = time.perf_counter()
        fn()
        return (time.perf_counter() - start) * 1e3

    monkeypatch.setattr(smoke, "cuda_ms", host_ms)

    def profile_steps(step, state, data, n):
        for _ in range(n):
            state, _ = step(state, data)
        return state, [("flash_fwd_sm90_kernel<128>", 1.0, 2.0)]

    monkeypatch.setattr(smoke, "profile_steps", profile_steps)
    # The build: nothing compiled, a canned log.
    built = {n: _build.Built(n, tmp_path / f"lib{n}.so", 0.0, PTXAS_LOG
                             .replace("12 bytes spill stores", "0 bytes spill "
                                      "stores").replace("16 bytes spill "
                                                        "loads", "0 bytes "
                                                        "spill loads"))
             for n in ("flash_fwd", "flash_bwd")}
    monkeypatch.setattr(_build, "build", lambda *names: {n: built[n]
                                                         for n in names})
    monkeypatch.setattr(fa, "built_variant", fa.kernel_variant)
    monkeypatch.setattr(fa, "sm90_smem_bytes", lambda k, t, d: 164920)
    # The kernels: counting wrappers of the plain versions.
    fwd = _counting(fa._reference_attention_torch)
    dq = _counting(lambda *a: _plain_from_delta(*a)[0])
    dkv = _counting(lambda *a: _plain_from_delta(*a)[1:])

    def flash_bwd(q, k, v, o, lse, do, causal, scale):
        dq.launches += 1
        dkv.launches += 1
        return fa._flash_bwd_reference_torch(q, k, v, o, lse, do, causal,
                                             scale)

    monkeypatch.setattr(fa, "flash_fwd_cuda", fwd)
    monkeypatch.setattr(fa, "flash_bwd_dq_cuda", dq)
    monkeypatch.setattr(fa, "flash_bwd_dkv_cuda", dkv)
    monkeypatch.setattr(fa, "_flash_fwd", fwd)
    monkeypatch.setattr(fa, "_flash_bwd", flash_bwd)
    # Tiny sizes.
    tiny = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=256),
                               n_layers=2, max_seq_len=256)
    monkeypatch.setattr(llama.LlamaConfig, "llama3_8b",
                        staticmethod(lambda: tiny))
    monkeypatch.setattr(smoke, "bench_config", lambda: dataclasses.replace(
        tiny, loss_chunk_size=32))
    monkeypatch.setattr(smoke, "MAIN_LENGTHS", (40, 70))
    monkeypatch.setattr(smoke, "TRAIN_ATTN", (2, 64, 64, 4, 2, 32, True))
    monkeypatch.setattr(smoke, "SERVE_ATTN", (1, 64, 64, 4, 2, 32, True))
    monkeypatch.setattr(smoke, "BWD_SHAPES", [(1, 17, 40, 2, 1, 32, True),
                                              (1, 40, 17, 2, 2, 64, True)])
    monkeypatch.setattr(smoke, "BWD_VIEW", (1, 20, 20, 2, 1, 64, True))
    monkeypatch.setattr(smoke, "flash_cases", lambda lengths: [
        (1, s, s, 4, 2, 32, torch.bfloat16, True, False) for s in lengths]
        + [(1, 30, 10, 2, 1, 64, torch.float32, True, True)])
    monkeypatch.setattr(smoke, "ROUND_TRIP", (1, 24, 24, 4, 2, 32, True))

    def engine(cfg, params, seed):
        from ray_tpu_torch.inference import GenerationConfig, InferenceEngine
        eng = InferenceEngine(params, cfg, max_batch=2, max_len=128,
                              device="cpu")
        out = eng.generate([[1, 2, 3], [4, 5, 6, 7, 8]],
                           GenerationConfig(max_new_tokens=3))
        assert [len(o) for o in out] == [3, 3]

    monkeypatch.setattr(smoke, "phase_engine", engine)

    assert smoke.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    for tag in ("[a]", "[b]", "[c]", "[f]", "[g]", "[d]", "[d+e]", "[h]"):
        assert any(line.startswith(tag) for line in lines), tag
    assert any("flash_fwd_sm90_kernel bf16 D=128: 168 registers, spill "
               "stores 0 B, loads 0 B, dynamic shared memory 164920 B" in line
               for line in lines)
    assert lines[-3] == "NVIDIA H100 80GB HBM3, 700.00 W"
    kernels = json.loads(lines[-2])["kernels"]
    assert [k["name"] for k in kernels] == ["flash_fwd", "flash_bwd_dq",
                                            "flash_bwd_dkv"]
    fields = {"name", "route", "source", "replaces", "launches",
              "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms"}
    for k in kernels:
        assert fields <= set(k), k["name"]
        assert k["route"] == "cuda" and (ROOT / k["source"]).exists()
        assert k["bound_by"] in ("bytes", "operations")
    layers = tiny.n_layers
    # Serving: forward at each length (one launch a layer), then the engine;
    # training: 13 steps (warm-up, 10 timed, 2 profiled) of 2L / L / L.
    by_path = {k["name"]: k["launches_by_path"] for k in kernels}
    assert by_path["flash_fwd"]["train"] == 13 * 2 * layers
    assert by_path["flash_bwd_dq"] == {"serve": 0, "train": 13 * layers}
    assert by_path["flash_bwd_dkv"] == {"serve": 0, "train": 13 * layers}
    assert by_path["flash_fwd"]["serve"] >= 2 * layers
    assert [k["design"] for k in kernels] == ["wgmma", "wgmma", "wgmma"]
    assert "library_ms" in kernels[0]["train_shape"]
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert time.perf_counter() - t0 < 60
