"""Find the benchmark's parts by name.

Each configuration, traffic mix, limit, per-layer metric, work count,
reference layer, reference model and port adapter is one file under
``perfbench/``; nothing lists them.  A later change adds a part by adding
its file.  ``root`` defaults to this folder; tests point it elsewhere.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

_modules: Dict[str, ModuleType] = {}


def benchmark(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def workload(name: str, repo: Path = REPO) -> dict:
    for w in benchmark(repo)["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def data(kind: str, name: str, root: Path = HERE) -> dict:
    """``<root>/<kind>/<name>.json``: a configuration, traffic mix or limit."""
    path = root / kind / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                       f"{name!r}: {path} is missing")
    out = json.loads(path.read_text())
    out.setdefault("name", name)
    return out


def module(kind: str, name: str, root: Path = HERE) -> ModuleType:
    """The Python file ``<root>/<kind>/<name>.py``, loaded once."""
    path = (root / kind / f"{name}.py").resolve()
    key = str(path)
    mod = _modules.get(key)
    if mod is None:
        if not path.exists():
            raise KeyError(f"no {kind} module {name!r}: {path} is missing")
        ident = "perfbench_" + re.sub(r"\W", "_", f"{kind}_{name}")
        spec = importlib.util.spec_from_file_location(ident, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[ident] = mod        # dataclasses look their module up
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return mod
