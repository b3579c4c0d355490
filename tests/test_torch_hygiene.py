"""Import hygiene of the PyTorch port, and its refusal to run on the CPU
unless asked.

The port imports neither JAX nor the JAX package ``repro`` (it keeps its own
copies), and no library attention or ``torch.compile`` stands in for its
kernels.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED_ROOTS = ("jax", "jaxlib", "repro")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imports(tree)
           if mod.split(".")[0] in BANNED_ROOTS]
    assert not bad, f"{path}: imports {bad}"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_attention_or_compile(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        name = (node.attr if isinstance(node, ast.Attribute)
                else node.id if isinstance(node, ast.Name) else None)
        if name == "scaled_dot_product_attention":
            bad.append((node.lineno, name))
        if (isinstance(node, ast.Attribute) and node.attr == "compile"
                and isinstance(node.value, ast.Name)
                and node.value.id == "torch"):
            bad.append((node.lineno, "torch.compile"))
    assert not bad, f"{path}: {bad}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"kernels/ops.py", "kernels/mlstm_scan.py", "kernels/mamba_scan.py",
            "models/lm.py", "models/moe.py", "launch/serve.py",
            "serve/admission.py", "convert.py", "optim/adamw.py",
            "optim/schedules.py", "data/pipeline.py", "core/state.py",
            "core/lifecycle.py", "core/control.py", "core/storage.py",
            "ckpt/shards.py", "ckpt/commit.py", "ckpt/restore.py",
            "launch/steps.py", "launch/train.py"} <= names
    assert (ROOT / "chip_smoke.py").exists()


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")


def test_entry_points_refuse_the_cpu_by_default(no_cuda):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeConfig, generate
    from repro_torch.models import init_cache, init_model, smoke
    from repro_torch.serve import KernelDecode

    cfg = smoke(get_config("llama3.2-1b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(smoke(get_config("xlstm-125m")), 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(smoke(get_config("jamba-v0.1-52b")), 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KernelDecode(slots=2)
    from repro_torch.launch import xlstm_probe
    with pytest.raises(RuntimeError, match="no CUDA device"):
        xlstm_probe.main([])
    model = init_model(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(cfg, model, np.zeros((1, 4), np.int32),
                 ServeConfig(max_new_tokens=2, max_len=8))
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
