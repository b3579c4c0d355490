"""Roofline of the dry run over one NVIDIA H100 (the counterpart of
``benchmarks/roofline.py``): read the ``launch.dryrun`` records, derive the
three terms per (arch x shape x mesh), name the bottleneck.

  compute_s    = FLOPs/device      / 989e12 (bf16 dense)
  memory_s     = HBM bytes/device  / 3.35e12 B/s
  collective_s = wire bytes/device / 450e9 B/s (NVLink, one direction)

The figures are NVIDIA's H100 SXM data sheet (dense, 700 W), the ones
``chip_smoke.py`` bounds its kernels with.  The peak is bf16's: every
dry-run record is the cost of a step on bf16 parameters and
activations (``launch.dryrun.cost_pass``).  roofline_fraction = compute_s /
max(all three): the fraction of peak the cell can reach if the dominant
term is perfectly pipelined.  The MODEL/counted-FLOPs ratio flags remat and
redundant compute.

    PYTHONPATH=src python -m repro_torch.launch.roofline [dryrun_dir]
"""
from __future__ import annotations

import glob
import json
import os
import sys
from dataclasses import dataclass
from typing import List, Optional

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
DEFAULT_DIR = "artifacts/dryrun_torch"


@dataclass
class Cell:
    arch: str
    shape: str
    mesh: str
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    model_ratio: float = 0.0
    skipped: str = ""
    error: str = ""
    raw: Optional[dict] = None

    @property
    def bottleneck(self) -> str:
        if self.skipped or self.error:
            return "-"
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        m = max(self.compute_s, self.memory_s, self.collective_s)
        return self.compute_s / m if m > 0 else 0.0


def cell(rec: dict) -> Cell:
    """The three terms of one dry-run record."""
    c = Cell(rec["arch"], rec["shape"], rec["mesh"],
             skipped=rec.get("skipped", ""), error=rec.get("error", ""),
             raw=rec)
    if not c.skipped and not c.error:
        n = rec["n_devices"]
        c.compute_s = rec["flops_per_device"] / PEAK_FLOPS
        c.memory_s = rec["hbm_bytes_per_device"] / HBM_BW
        c.collective_s = rec["collective_bytes_per_device"] / NVLINK_BW
        c.model_ratio = rec["model_flops_total"] / n / max(
            rec["flops_per_device"], 1e-9)
    return c


def load_cells(dryrun_dir: str = DEFAULT_DIR) -> List[Cell]:
    cells = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            cells.append(cell(json.load(f)))
    return cells


def rows(dryrun_dir: str = DEFAULT_DIR):
    out = []
    for c in load_cells(dryrun_dir):
        tag = f"roofline/{c.arch}/{c.shape}/{c.mesh}"
        if c.skipped:
            out.append((tag, 0.0, f"SKIP:{c.skipped[:60]}"))
        elif c.error:
            out.append((tag, 0.0, f"ERROR:{c.error[:60]}"))
        else:
            out.append((
                tag, c.roofline_fraction,
                f"bottleneck={c.bottleneck} compute={c.compute_s:.3f}s "
                f"mem={c.memory_s:.3f}s coll={c.collective_s:.3f}s "
                f"model/counted={c.model_ratio:.2f}"))
    return out


def table(dryrun_dir: str = DEFAULT_DIR, mesh: str = "single") -> str:
    lines = [f"| arch | shape | compute s | memory s | collective s | "
             f"bottleneck | roofline frac | model/counted |",
             "|---|---|---|---|---|---|---|---|"]
    for c in load_cells(dryrun_dir):
        if c.mesh != mesh:
            continue
        if c.skipped or c.error:
            verdict = "skipped" if c.skipped else "error"
            lines.append(f"| {c.arch} | {c.shape} | — | — | — | {verdict} "
                         f"| — | — |")
            continue
        lines.append(
            f"| {c.arch} | {c.shape} | {c.compute_s:.4f} | {c.memory_s:.4f} "
            f"| {c.collective_s:.4f} | {c.bottleneck} "
            f"| {c.roofline_fraction:.3f} | {c.model_ratio:.2f} |")
    return "\n".join(lines)


if __name__ == "__main__":
    print(table(*sys.argv[1:2]))
