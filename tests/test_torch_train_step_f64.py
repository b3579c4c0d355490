"""The training step of both packages in float64, on the CPU.

``tests/test_torch_train_step.py`` holds one fp32 step of the port against
the JAX package; on the xLSTM smoke config (and for Jamba's parameters and
second moment after a step with lr > 0) fp32 rounding alone moves the leaves
beyond the 2e-5 tolerance, so those parts are reported there instead of
held.  Here a step with lr > 0 runs with every fp32 cast of both packages
widened to float64 (``widen_fp32_casts``, in a separate process, since it
patches both packages), and every part is held at 2e-5 of each leaf's
largest value.  For these two configs that is the parity check.

The int8-compressed step of both packages' ``make_train_step`` is held the
same way (``--compress``), at step index 1 on the llama, Jamba, gemma2 and
xLSTM smoke configs: in fp32 a gradient's rounding can move a code across
a ``.5`` boundary, and Adam turns such a flip into a move of about lr.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
REL = 2e-5


def float64_report(*args):
    """The last line of ``test_torch_train_step.py --float64 *args``, run
    in its own process."""
    res = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "test_torch_train_step.py"),
         "--float64", *args], cwd=ROOT, capture_output=True, text=True,
        timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": os.pathsep.join(
                 [str(ROOT / "src"), str(ROOT),
                  os.environ.get("PYTHONPATH", "")])})
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"float64 {' '.join(args)}: {json.dumps(report)}")
    assert report.pop("dtype") == "float64"
    return report


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_train_step_matches_jax_in_float64(arch):
    report = float64_report(arch)
    assert max(report.values()) <= REL, report


@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-v0.1-52b",
                                  "gemma2-2b", "xlstm-125m"])
def test_compressed_train_step_matches_jax_in_float64(arch):
    report = float64_report(arch, "--compress")
    assert sorted(report) == ["loss@1", "opt/m@1", "opt/v@1", "params@1"]
    assert max(report.values()) <= REL, report
