"""The port's environment module (utils/environment.py) and `diagnose`.

- `estimate_training_memory_gb`, `check_config_fits`, `recommend_preset`
  and `ConfigManager.optimize_for_hardware` equal JAX's when both are
  given the same device memory and count (get_device_info patched on
  both sides): the same formulas over the same presets.
- `device_peak_flops` by card name (NVIDIA's dense bf16 figures);
  `parse_topology_matrix` over an `nvidia-smi topo -m` table.
- `diagnose` on a machine without a card exits 1 (its probe, a
  subprocess, finds no CUDA device), having touched no CUDA itself.
- `connectivity_probe` over a one-rank gloo group: visibility and a
  timed all-reduce, exported as the diagnose_* gauges.
"""

import dataclasses

import pytest
import torch
import torch.distributed as dist

from luminaai_tpu import config as jconfig
from luminaai_tpu.utils import environment as jenv
from luminaai_tpu_torch import cli
from luminaai_tpu_torch import config as tconfig
from luminaai_tpu_torch.monitoring.telemetry import MetricsRegistry
from luminaai_tpu_torch.utils import environment as tenv

FLEETS = [(80.0, 1), (80.0, 8), (16.0, 64), (95.0, 256)]
PRESETS = ["debug", "debug_200m", "b7", "b14", "b100"]


@pytest.fixture(params=FLEETS, ids=lambda f: f"{f[0]:g}GBx{f[1]}")
def fleet(request, monkeypatch):
    mem, n = request.param
    info = {"platform": "gpu", "device_count": n, "local_device_count": n,
            "device_kind": "card", "process_index": 0, "process_count": 1,
            "memory_per_device_gb": mem}
    for mod in (jenv, tenv):
        monkeypatch.setattr(mod, "get_device_info", lambda: dict(info))
    return n


def _pair(name):
    return jconfig.ConfigPresets.get(name), tconfig.ConfigPresets.get(name)


def test_memory_fit_and_recommendation_equal_jax(fleet):
    assert tenv.recommend_preset() == jenv.recommend_preset()
    assert tenv.recommend_preset(n_devices=2) == jenv.recommend_preset(
        n_devices=2)
    for name in PRESETS:
        jc, tc = _pair(name)
        assert tenv.estimate_training_memory_gb(tc) == (
            jenv.estimate_training_memory_gb(jc)), name
        got, want = tenv.check_config_fits(tc), jenv.check_config_fits(jc)
        assert got == want, name


def test_optimize_for_hardware_equals_jax(fleet):
    fields = ("expert_parallel_size", "data_parallel_size",
              "tensor_parallel_size", "fsdp_parallel_size")
    for name in PRESETS:
        jc, tc = _pair(name)
        jc = dataclasses.replace(jc, fsdp_parallel_size=1,
                                 expert_parallel_size=1)
        tc = dataclasses.replace(tc, fsdp_parallel_size=1,
                                 expert_parallel_size=1)
        want = jconfig.ConfigManager.optimize_for_hardware(jc)
        got = tconfig.ConfigManager.optimize_for_hardware(tc)
        assert [getattr(got, f) for f in fields] == [
            getattr(want, f) for f in fields], name


def test_peak_flops_and_topology():
    assert tenv.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tenv.device_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert tenv.device_peak_flops("NVIDIA A100-SXM4-80GB") == 312e12
    assert tenv.device_peak_flops("Some New Card") == 989e12
    table = ("\tGPU0\tGPU1\tGPU2\tCPU Affinity\tNUMA Affinity\tGPU NUMA ID\n"
             "GPU0\t X \tNV18\tSYS\t0-47\t0\t\tN/A\n"
             "GPU1\tNV18\t X \tNV12\t0-47\t0\t\tN/A\n"
             "GPU2\tSYS\tNV12\t X \t48-95\t1\t\tN/A\n\nLegend:\n  X = Self\n")
    topo = tenv.parse_topology_matrix(table)
    assert topo["gpus"] == ["GPU0", "GPU1", "GPU2"]
    assert topo["links"] == {"GPU0-GPU1": "NV18", "GPU0-GPU2": "SYS",
                             "GPU1-GPU2": "NV12"}
    assert (topo["nvlink_pairs"], topo["nvlinks"]) == (2, 30)


def test_diagnose_without_a_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert cli.main(["diagnose", "--probe-timeout", "120"]) == 1
    out = capsys.readouterr().out
    assert "status: error" in out and "no CUDA device" in out
    assert "[accelerator] skipped" in out


def test_connectivity_probe_on_one_gloo_rank(tmp_path):
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        reg = MetricsRegistry()
        out = tenv.connectivity_probe(payload_mb=0.5, iters=2, registry=reg)
    finally:
        dist.destroy_process_group()
    vis = out["visibility"]
    assert vis["visibility_ok"] and vis["global_device_count"] == 1
    assert vis["platform"] == "cpu"
    rec = out["allreduce"]["ici"]
    assert rec["size"] == 1 and rec["mean_seconds"] > 0
    text = reg.render_prometheus()
    assert 'diagnose_allreduce_seconds{axis="ici"}' in text
    assert "diagnose_device_visibility_ok 1" in text
