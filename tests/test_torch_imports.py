"""The port stands alone: no JAX, no luminaai_tpu, no quiet CPU fallback.

- Every Python file of luminaai_tpu_torch/ and chip_smoke.py is scanned
  (AST) for imports of jax, flax, orbax or the luminaai_tpu package
  (luminaai_tpu_torch itself is allowed); so are the port's bench scripts
  (bench_torch.py, bench_ops_torch.py, bench_common_torch.py), and
  neither they nor the package nor chip_smoke.py import the JAX
  package's harness (bench.py, bench_ops.py, bench_common.py).
- Importing every module of the port in a fresh interpreter leaves jax
  and luminaai_tpu out of sys.modules.
- Entry points called without a device mean the card: where CUDA is
  absent they raise instead of running on the CPU.
- chip_smoke.py fails, printing no result, where it cannot run: without a
  card, and in a directory that holds nothing else of the repo.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "luminaai_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "luminaai_tpu")


def _port_files():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py")
        if p.name != "__main__.py"
    )


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _imported(path) -> list:
    """Every absolute module name a file imports (import, from-import,
    importlib.import_module / __import__ of a constant)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
            node.func, "attr", getattr(node.func, "id", "")
        ) in ("import_module", "__import__"):
            names += [a.value for a in node.args
                      if isinstance(a, ast.Constant)
                      and isinstance(a.value, str)]
    return names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_luminaai_tpu_imports(path):
    bad = [n for n in _imported(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# The port's bench harness at the repo root: held to the package's rule,
# and, with the package and chip_smoke.py, importing nothing of the JAX
# package's harness.
BENCH_SCRIPTS = ("bench_torch.py", "bench_ops_torch.py",
                 "bench_common_torch.py")
JAX_HARNESS = ("bench", "bench_ops", "bench_common")


@pytest.mark.parametrize(
    "path", [ROOT / s for s in BENCH_SCRIPTS] + _port_files(),
    ids=lambda p: p.name)
def test_no_jax_or_jax_harness_imports(path):
    bad = [n for n in _imported(path)
           if _forbidden(n) or n.split(".")[0] in JAX_HARNESS]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_bench_scripts_loads_no_jax():
    mods = [s.removesuffix(".py") for s in BENCH_SCRIPTS]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + JAX_HARNESS!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


# The training runtime's modules (utils, monitoring, native, data,
# checkpoint, scaler); the checks above and below cover every module the
# package holds, these included.
RUNTIME_MODULES = (
    "luminaai_tpu_torch.utils.retry",
    "luminaai_tpu_torch.monitoring.telemetry",
    "luminaai_tpu_torch.monitoring.events",
    "luminaai_tpu_torch.monitoring.goodput",
    "luminaai_tpu_torch.monitoring.watchdog",
    "luminaai_tpu_torch.monitoring.logger",
    "luminaai_tpu_torch.native",
    "luminaai_tpu_torch.data.bpe",
    "luminaai_tpu_torch.data.dataset",
    "luminaai_tpu_torch.training.checkpoint",
    "luminaai_tpu_torch.training.scaler",
)


def test_runtime_modules_are_scanned():
    assert set(RUNTIME_MODULES) <= set(_modules())
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for m in RUNTIME_MODULES:
        path = m.replace(".", "/")
        assert f"{path}.py" in files or f"{path}/__init__.py" in files, m
    # The native sources are the port's own copies.
    for src in ("dataloader.cpp", "bpe.cpp"):
        assert (PACKAGE / "native" / src).is_file()


# The adaptive-training slice: the orchestrator and what it drives.
ADAPTIVE_MODULES = (
    "luminaai_tpu_torch.training.orchestrator",
    "luminaai_tpu_torch.training.evolution",
    "luminaai_tpu_torch.training.scaler",
    "luminaai_tpu_torch.training.trainer",
    "luminaai_tpu_torch.data.dataset",
)


@pytest.mark.parametrize("module", ADAPTIVE_MODULES)
def test_adaptive_modules_are_scanned(module):
    assert module in _modules()
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert module.replace(".", "/") + ".py" in files


# The model and optimizer configurations slice: mixture of depths, the
# remat policies, the moment forms, gather/einsum dispatch, scanned trees
# and untied heads.
CONFIG_SLICE_MODULES = (
    "luminaai_tpu_torch.models.mod",
    "luminaai_tpu_torch.models.transformer",
    "luminaai_tpu_torch.models.moe",
    "luminaai_tpu_torch.models.layers",
    "luminaai_tpu_torch.ops.flash_attention",
    "luminaai_tpu_torch.training.optimizer",
    "luminaai_tpu_torch.training.checkpoint",
    "luminaai_tpu_torch.parallel.train_step",
    "luminaai_tpu_torch.convert",
    "luminaai_tpu_torch.config",
)


@pytest.mark.parametrize("module", CONFIG_SLICE_MODULES)
def test_config_slice_modules_are_scanned(module):
    assert module in _modules()
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert module.replace(".", "/") + ".py" in files


# The post-training slice: adapters, chat, data blending, security.
POSTTRAIN_MODULES = (
    "luminaai_tpu_torch.training.adapters",
    "luminaai_tpu_torch.inference.chat",
    "luminaai_tpu_torch.inference.generate",
    "luminaai_tpu_torch.data.multi_source",
    "luminaai_tpu_torch.data.processing",
    "luminaai_tpu_torch.security",
    "luminaai_tpu_torch.security.auth",
    "luminaai_tpu_torch.security.input_validator",
    "luminaai_tpu_torch.security.rate_limiter",
)


@pytest.mark.parametrize("module", POSTTRAIN_MODULES)
def test_posttrain_modules_are_scanned(module):
    assert module in _modules()
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    path = module.replace(".", "/")
    assert f"{path}.py" in files or f"{path}/__init__.py" in files


# The serving plane: the radix prefix cache, the server and its chat
# page, the SLO engine, time-series ring, span tracer and `top`.
SERVING_MODULES = (
    "luminaai_tpu_torch.inference.prefix_cache",
    "luminaai_tpu_torch.inference.kv_pool",
    "luminaai_tpu_torch.serving.server",
    "luminaai_tpu_torch.serving.webui",
    "luminaai_tpu_torch.monitoring.slo",
    "luminaai_tpu_torch.monitoring.timeseries",
    "luminaai_tpu_torch.monitoring.tracing",
    "luminaai_tpu_torch.monitoring.top",
)


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_modules_are_scanned(module):
    assert module in _modules()
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert module.replace(".", "/") + ".py" in files


# The fleet: the replica router, page sharing, and the pool, cache,
# decoder, server, config, top and CLI hooks they ride on.
FLEET_MODULES = (
    "luminaai_tpu_torch.serving.router",
    "luminaai_tpu_torch.serving.page_share",
    "luminaai_tpu_torch.inference.kv_pool",
    "luminaai_tpu_torch.inference.prefix_cache",
    "luminaai_tpu_torch.inference.generate",
    "luminaai_tpu_torch.serving.server",
    "luminaai_tpu_torch.monitoring.top",
    "luminaai_tpu_torch.config",
    "luminaai_tpu_torch.cli",
)


@pytest.mark.parametrize("module", FLEET_MODULES)
def test_fleet_modules_are_scanned(module):
    assert module in _modules()
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert module.replace(".", "/") + ".py" in files


# Quantized serving: the int8 ops and trees, and the model, cache, pool,
# decoder, loader, server and CLI pieces that carry int8 weights and KV.
QUANT_MODULES = (
    "luminaai_tpu_torch.ops.quantized",
    "luminaai_tpu_torch.training.quantization",
    "luminaai_tpu_torch.ops.ragged_paged_attention",
    "luminaai_tpu_torch.models.layers",
    "luminaai_tpu_torch.models.moe",
    "luminaai_tpu_torch.models.transformer",
    "luminaai_tpu_torch.convert",
    "luminaai_tpu_torch.inference.chat",
)


@pytest.mark.parametrize("module", QUANT_MODULES)
def test_quantized_serving_modules_are_scanned(module):
    assert module in _modules()
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert module.replace(".", "/") + ".py" in files


# Multi-GPU training: the mesh, sharding, gradient reduction, expert
# dispatch, ring attention and pipeline modules, and the step, optimizer
# (host offload), trainer, orchestrator, checkpoint, watchdog and CLI
# pieces that run them.
MESH_MODULES = (
    "luminaai_tpu_torch.parallel.mesh",
    "luminaai_tpu_torch.parallel.sharding",
    "luminaai_tpu_torch.parallel.grad_reduce",
    "luminaai_tpu_torch.parallel.expert_dispatch",
    "luminaai_tpu_torch.ops.ring_attention",
    "luminaai_tpu_torch.parallel.pipeline",
    "luminaai_tpu_torch.parallel.train_step",
    "luminaai_tpu_torch.training.optimizer",
    "luminaai_tpu_torch.training.trainer",
    "luminaai_tpu_torch.training.orchestrator",
    "luminaai_tpu_torch.training.checkpoint",
    "luminaai_tpu_torch.monitoring.watchdog",
    "luminaai_tpu_torch.cli",
)


@pytest.mark.parametrize("module", MESH_MODULES)
def test_mesh_modules_are_scanned(module):
    assert module in _modules()
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert module.replace(".", "/") + ".py" in files


# The A5 leftovers: soft prompts, profiling windows and attribution, the
# environment and diagnostics, the reports, the OASST acquisition, and the
# model, trainer, kernel and CLI pieces that carry them.
A7_MODULES = (
    "luminaai_tpu_torch.utils.environment",
    "luminaai_tpu_torch.utils.profiling",
    "luminaai_tpu_torch.utils.reporting",
    "luminaai_tpu_torch.monitoring.attribution",
    "luminaai_tpu_torch.data.acquisition",
    "luminaai_tpu_torch.ops._flops",
    "luminaai_tpu_torch.training.adapters",
    "luminaai_tpu_torch.training.trainer",
    "luminaai_tpu_torch.models.transformer",
    "luminaai_tpu_torch.cli",
)


@pytest.mark.parametrize("module", A7_MODULES)
def test_a7_modules_are_scanned(module):
    assert module in _modules()
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert module.replace(".", "/") + ".py" in files


# The last JAX modules (A8): the rolling cache's layers and engine, the
# fault injectors, the static-analysis gate.
A8_MODULES = (
    "luminaai_tpu_torch.models.layers",
    "luminaai_tpu_torch.models.transformer",
    "luminaai_tpu_torch.inference.generate",
    "luminaai_tpu_torch.testing",
    "luminaai_tpu_torch.testing.faults",
    "luminaai_tpu_torch.analysis",
    "luminaai_tpu_torch.analysis.astlint",
    "luminaai_tpu_torch.analysis.trace_audit",
    "luminaai_tpu_torch.cli",
)


@pytest.mark.parametrize("module", A8_MODULES)
def test_a8_modules_are_scanned(module):
    assert module in _modules()
    files = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    path = module.replace(".", "/")
    assert f"{path}.py" in files or f"{path}/__init__.py" in files


# The port's name for a JAX module where torch has no counterpart of
# what the JAX one works on (a jaxpr).
RENAMED = {"analysis/jaxpr_audit.py": "analysis/trace_audit.py"}


def test_every_jax_module_has_its_counterpart():
    jax_pkg = ROOT / "luminaai_tpu"
    missing = []
    for p in sorted(jax_pkg.rglob("*.py")):
        rel = p.relative_to(jax_pkg).as_posix()
        if not (PACKAGE / RENAMED.get(rel, rel)).is_file():
            missing.append(rel)
    assert missing == []


def test_the_mesh_entry_points_refuse_what_is_left_for_a6b():
    """Since A6b, pipeline stages and the optimizer's host offload build
    where a train step is built; what JAX cannot pipeline (a layer stack
    of more than one homogeneous segment) still raises there."""
    from luminaai_tpu_torch.config import Config
    from luminaai_tpu_torch.parallel.train_step import check_trainable

    for kw in (dict(pipeline_parallel_size=2, num_layers=2),
               dict(host_offload_optimizer=True)):
        check_trainable(Config(**kw))
    with pytest.raises(ValueError, match="homogeneous segment"):
        check_trainable(Config(pipeline_parallel_size=2, num_layers=8,
                               use_moe=True, moe_pattern="sandwich"))


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(no_cuda):
    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import Config, resolve_device
    from luminaai_tpu_torch.inference.chat import build_engine
    from luminaai_tpu_torch.models.transformer import LuminaTransformer

    cfg = Config(vocab_size=384, hidden_size=64, num_layers=1, num_heads=2,
                 num_kv_heads=1, seq_length=64, intermediate_size=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LuminaTransformer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--preset", "debug", "--dense", "--seed", "0",
                  "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--preset", "debug", "--dense", "--synthetic",
                  "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["resume", "--preset", "debug", "--dense", "--data",
                  "missing.jsonl", "--packed", "--steps", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("argv", [
    ["finetune", "--checkpoint", "missing", "--data", "x.jsonl", "--out",
     "ft"],
    ["evaluate", "--checkpoint", "missing", "--data", "x.jsonl"],
    ["chat", "--checkpoint", "missing", "--prompt", "hi"],
], ids=["finetune", "evaluate", "chat"])
def test_posttrain_entry_points_default_to_the_card(no_cuda, argv):
    """Without --device the post-training commands mean the card: they
    raise before reading anything where CUDA is absent."""
    from luminaai_tpu_torch import cli

    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_cli_refuses_moe_presets(tmp_path):
    """What the CLI refuses, as JAX's config does: the 'a2a' MoE dispatch
    without an expert axis (from a flag or a config file). With --ep 2
    the flags build a config (training it needs two ranks: see
    tests/test_torch_mesh_trainer.py)."""
    import json

    from luminaai_tpu.config import Config as JConfig
    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.config import ConfigPresets

    with pytest.raises(AssertionError, match="expert mesh axis"):
        JConfig(use_moe=True, moe_dispatch="a2a")
    run = ["--synthetic", "--steps", "1", "--no-adaptive", "--device",
           "cpu", "--output-dir", str(tmp_path / "run")]
    with pytest.raises(ValueError, match="expert mesh axis"):
        cli.main(["train", "--preset", "debug", "--moe-dispatch", "a2a",
                  *run])
    path = tmp_path / "a2a.json"
    d = ConfigPresets.get("debug").to_dict()
    path.write_text(json.dumps(dict(d, moe_dispatch="a2a")))
    with pytest.raises(ValueError, match="expert mesh axis"):
        cli.main(["train", "--config", str(path), *run])
    args = cli._parser().parse_args(["train", "--preset", "debug",
                                     "--moe-dispatch", "a2a", "--ep", "2"])
    cfg = cli._train_config(args)
    assert (cfg.moe_dispatch, cfg.expert_parallel_size) == ("a2a", 2)


def test_cli_serves_moe_presets(monkeypatch):
    """`serve --preset debug --device cpu` builds the preset's MoE engine
    (sort dispatch by default, gmm on request); --dense drops the experts."""
    from luminaai_tpu_torch import cli
    from luminaai_tpu_torch.serving import server

    built = []
    monkeypatch.setattr(server.ChatServer, "serve_forever",
                        lambda self, host, port: built.append(self.engine))
    for extra, dispatch, moe in (([], "sort", True),
                                 (["--moe-dispatch", "gmm"], "gmm", True),
                                 (["--dense"], "sort", False)):
        assert cli.main(["serve", "--preset", "debug", "--seed", "0",
                         "--device", "cpu", "--port", "0", *extra]) == 0
        model = built[-1].model
        assert model.config.moe_dispatch == dispatch
        assert [hasattr(b, "moe") for b in model.layers] == [moe] * 2


def test_card_tensor_without_kernel_shape_raises_not_falls_back(no_cuda):
    """On a card tensor the decode dispatch launches the kernel or raises;
    a decode shape the kernel does not take is refused up front. (A CPU
    stand-in claiming to be CUDA exercises the gate without a card.)"""
    from luminaai_tpu_torch.ops import ragged_paged_attention as rpa

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    q = torch.zeros(2, 1, 2, 48).as_subclass(FakeCuda)
    kv = torch.zeros(2, 32, 1, 48)
    meta = rpa.LaneMeta(lengths=torch.tensor([3, 5], dtype=torch.int32),
                        page_size=8)
    with pytest.raises(ValueError, match="not eligible"):
        rpa.paged_attention(q, kv, kv, meta)
    before = rpa.ragged_paged_attention.launches
    with pytest.raises(ValueError):
        rpa.ragged_paged_attention(q, kv, kv, meta)
    assert rpa.ragged_paged_attention.launches == before


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120, env=env,
    )


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == "", proc.stdout
    assert "not beside this script" in proc.stderr


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    proc = _run_chip_smoke(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == "", proc.stdout
    assert "no CUDA device" in proc.stderr
