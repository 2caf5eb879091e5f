"""The port stands alone: no JAX, no luminaai_tpu, no quiet CPU fallback.

- Every Python file of luminaai_tpu_torch/ and chip_smoke.py is scanned
  (AST) for imports of jax, flax, orbax or the luminaai_tpu package
  (luminaai_tpu_torch itself is allowed).
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


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_luminaai_tpu_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
            node.func, "attr", getattr(node.func, "id", "")
        ) in ("import_module", "__import__"):
            bad += [a.value for a in node.args
                    if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


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


def test_cli_refuses_moe_presets():
    """What the CLI still refuses: MoE dispatch modes the port has not
    ported (the JAX flag's choices are accepted and refused where the
    model is built)."""
    from luminaai_tpu_torch import cli

    for mode in ("gather", "einsum"):
        with pytest.raises(NotImplementedError, match="not ported"):
            cli.main(["serve", "--preset", "debug", "--seed", "0",
                      "--moe-dispatch", mode, "--device", "cpu",
                      "--port", "0"])


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
