"""Every part of a cell is a file found by name: BENCHMARK.json's entries
each have theirs, and a configuration, traffic mix or per-layer metric
added as a file is picked up with no other file edited."""
import json
import re
import shutil

import pytest

from perfbench import harness, registry
from perfbench.tests import tiny

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_entry_has_its_files():
    for c in BENCH["configs"]:
        cfg = registry.data("configs", c["name"])
        assert (registry.REPO / c["file"]).resolve() == \
            (registry.HERE / "configs" / f"{c['name']}.json").resolve()
        assert set(c["reduced"]) == set(cfg["reduced"])
        registry.module("models", cfg["model_type"])
        registry.module("adapters", cfg["model_type"])
    for w in BENCH["workloads"]:
        tr = registry.data("traffic", w["traffic"])
        registry.module("drivers", tr["driver"])
        assert registry.data("limits", w["name"])["compare"]
    for m in BENCH["per_layer"]:
        assert callable(registry.module("metrics", m["name"]).read)


def test_names_units_and_keys():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and all(0 < m["bound"] <= 0.25
                                    for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def copy_tree(tmp_path):
    repo = tmp_path / "repo"
    shutil.copytree(registry.HERE, repo / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (repo / "BENCHMARK.json").write_text(json.dumps(BENCH))
    return repo


def test_added_files_are_found_by_name(tmp_path):
    repo = copy_tree(tmp_path)
    root = repo / "perfbench"
    cfg = tiny.config("minicpm-decode")
    cfg["name"] = "minicpm-tiny"
    (root / "configs" / "minicpm-tiny.json").write_text(json.dumps(cfg))
    tr = tiny.traffic("minicpm-decode")
    (root / "traffic" / "tiny-mix.json").write_text(json.dumps(tr))
    (root / "limits" / "tiny-cell.json").write_text(
        json.dumps({"compare": {"max_gap": 1.0}}))
    (root / "metrics" / "waves_served.py").write_text(
        "def read(run):\n    return float(len(run.waves))\n")
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [dict(
        BENCH["configs"][1], name="minicpm-tiny",
        file="perfbench/configs/minicpm-tiny.json")]
    bench["workloads"] = BENCH["workloads"] + [dict(
        name="tiny-cell", config="minicpm-tiny", traffic="tiny-mix",
        chips=1, why="a cell added as files")]
    bench["per_layer"] = BENCH["per_layer"] + [dict(
        name="waves_served", unit="waves", better="higher",
        source="program_counter", layer="serving loop",
        moves="output_tokens_per_s", workloads=["tiny-cell"])]
    (repo / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run_cell("tiny-cell", 5, 0.5, True, device="cpu",
                           repo=repo, root=root, log=lambda s: None)
    assert out["metrics"]["waves_served"]["value"] == out["waves"] >= 1
    assert out["correct"] is True


def test_a_missing_part_is_named():
    with pytest.raises(KeyError, match="no-such-mix"):
        registry.data("traffic", "no-such-mix")
