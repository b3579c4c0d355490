"""Import hygiene of the PyTorch port, and its refusal to run on the CPU
unless asked.

The port imports neither JAX nor the JAX package ``repro`` (it keeps its own
copies), nor ``torch.testing`` (the fake process group that the sharding
tests build their large meshes on is test-only), and no library attention
or ``torch.compile`` stands in for its kernels.
"""
import ast
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED_ROOTS = ("jax", "jaxlib", "repro")
BANNED_MODULES = ("torch.testing",)


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
           if mod.split(".")[0] in BANNED_ROOTS
           or any(mod == m or mod.startswith(m + ".")
                  for m in BANNED_MODULES)]
    # ``torch.testing`` reached as an attribute of an imported ``torch``
    bad += [(node.lineno, "torch.testing") for node in ast.walk(tree)
            if isinstance(node, ast.Attribute) and node.attr == "testing"
            and isinstance(node.value, ast.Name) and node.value.id == "torch"]
    assert not bad, f"{path}: imports {bad}"


def test_the_scan_catches_torch_testing(tmp_path):
    """The check above on sources that reach torch.testing each way."""
    for src in ("import torch.testing\n",
                "from torch.testing._internal import common_utils\n",
                "import torch\ntorch.testing.assert_close(1, 1)\n"):
        path = tmp_path / "m.py"
        path.write_text(src)
        with pytest.raises(AssertionError, match="torch.testing"):
            test_no_jax_or_repro_imports(path)


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
            "launch/steps.py", "launch/train.py", "launch/sharding.py",
            "configs/kimi_k2_1t_a32b.py", "core/sim.py", "core/stores.py",
            "core/protocols/__init__.py", "core/protocols/registry.py",
            "core/protocols/transport.py", "core/protocols/context.py",
            "core/protocols/base.py", "core/protocols/cornus.py",
            "core/protocols/twopc.py", "core/protocols/coordinator_log.py",
            "core/protocols/cornus_opt1.py", "core/protocols/paxos_commit.py",
            "txn/__init__.py", "txn/threaded.py", "serve/slo.py",
            "serve/session.py", "serve/publisher.py",
            "serve/engine.py", "optim/compress.py", "launch/mesh.py",
            "launch/dryrun.py", "launch/roofline.py", "core/history.py",
            "core/chaos.py", "core/protocol.py", "core/variants.py",
            "txn/store.py", "txn/workload.py", "txn/executor.py"} <= names
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
    from repro_torch.serve import EngineConfig, KernelDecode, ServeEngine

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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(EngineConfig(decode="kernel"))
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


def test_the_dry_run_runs_on_meta_and_allocates_nothing():
    """The dry run is the one entry point that does not refuse the CPU (the
    check above): it places and runs nothing on a device.  Every tensor its
    cost pass makes, for each step kind, is on ``meta`` but for small host
    tensors on the CPU: the 0-d scalars of the optimizer's bias corrections
    and the constants that ``torch.tensor(data, device="meta")`` stages on
    the host (the rope frequencies).  None is on CUDA."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import ShapeConfig, smoke

    class Devices(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.off_meta = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.off_meta += [(str(func), t.device.type,
                               t.numel() * t.element_size())
                              for t in tree_leaves(out)
                              if isinstance(t, torch.Tensor)
                              and t.device.type != "meta"]
            return out

    cfg = smoke(get_config("jamba-v0.1-52b"))
    seen = Devices()
    with seen:
        for kind in ("train", "prefill", "decode"):
            dryrun.cost_pass(cfg, ShapeConfig(kind, 16, 2, kind),
                             steps.TrainSettings())
    assert {dev for _, dev, _ in seen.off_meta} <= {"cpu"}, seen.off_meta
    assert sum(n for _, _, n in seen.off_meta) < 4096, seen.off_meta
    assert not torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# The commit core's twins and the lifecycle twin's kill -9 child
# ---------------------------------------------------------------------------
# Twins of the reference's commit-core suites: they import the port's
# ``core`` / ``txn`` (standard library only), never torch.
CORE_TWINS = ("test_torch_gc_safety.py", "test_torch_lifecycle.py",
              "test_torch_store_api.py", "test_torch_replicated_store.py")
CORE_PACKAGES = ("repro_torch.core", "repro_torch.txn")


@pytest.mark.parametrize("name", CORE_TWINS)
def test_commit_core_twins_import_no_torch(name):
    path = ROOT / "tests" / name
    mods = [mod for _, mod in _imports(ast.parse(path.read_text()))]
    assert not [m for m in mods if m.split(".")[0] == "torch"], mods
    port = [m for m in mods if m.split(".")[0] == "repro_torch"]
    assert port and all(any(m == p or m.startswith(p + ".")
                            for p in CORE_PACKAGES) for m in port), port


def test_the_kill_child_imports_the_port_core_only():
    """The kill -9 writer's child script imports the standard library and
    ``repro_torch.core`` alone, and those imports load neither torch,
    numpy, JAX nor the JAX package."""
    import subprocess
    import sys

    from test_torch_lifecycle import _KILL_SCRIPT
    script = _KILL_SCRIPT.format(src=str(ROOT / "src"), root="/nonexistent",
                                 mode="log")
    mods = {mod for _, mod in _imports(ast.parse(script))}
    assert {m for m in mods if m.split(".")[0] not in ("os", "sys",
                                                       "threading")} \
        == {"repro_torch.core", "repro_torch.core.storage"}
    header = script[:script.index("root = ")]
    probe = header + textwrap.dedent("""\
        print(sorted({m.split(".")[0] for m in sys.modules}
                     & {"torch", "numpy", "jax", "jaxlib", "repro"}))
    """)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
