"""The port's roofline reader (``repro_torch.launch.roofline``) over the
H100's peaks, on records that the port's dry run writes, on the CPU."""
import json

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.launch import dryrun, roofline  # noqa: E402


def test_h100_constants():
    assert roofline.PEAK_FLOPS == 989e12    # bf16 dense: the records' dtype
    assert roofline.HBM_BW == 3.35e12
    assert roofline.NVLINK_BW == 450e9
    assert roofline.DEFAULT_DIR == "artifacts/dryrun_torch"


def record(arch="a", shape="s", mesh="single", flops=989e12, hbm=0.0,
           coll=0.0, n=256, model=None):
    return {"arch": arch, "shape": shape, "mesh": mesh, "profile": "default",
            "n_devices": n, "flops_per_device": flops,
            "hbm_bytes_per_device": hbm, "collective_bytes_per_device": coll,
            "model_flops_total": flops * n if model is None else model}


PEAK = 989e12


@pytest.mark.parametrize("case", [
    # (FLOPs over the peak, HBM bytes over 3.35e12, wire bytes over 450e9,
    #  model FLOPs over the counted: the three terms in seconds; the
    #  bottleneck, the roofline fraction, the model/counted ratio)
    ((2, 1, 0, 1), "compute", 1.0, 1.0),
    ((1, 2, 4, 0.5), "collective", 0.25, 0.5),
    ((1, 3, 0, 1), "memory", 1 / 3, 1.0),
])
def test_terms_bottleneck_and_fraction(case):
    (f, m, w, ratio), bottleneck, fraction, model_ratio = case
    c = roofline.cell(record(flops=f * PEAK, hbm=m * 3.35e12, coll=w * 450e9,
                             model=f * PEAK * 256 * ratio))
    assert (c.compute_s, c.memory_s, c.collective_s) == \
        pytest.approx((f, m, w), rel=1e-15)
    assert c.bottleneck == bottleneck
    assert c.roofline_fraction == pytest.approx(fraction)
    assert c.model_ratio == pytest.approx(model_ratio)


def test_skipped_and_failed_cells():
    skip = roofline.cell({"arch": "a", "shape": "long_500k", "mesh": "single",
                          "skipped": "why"})
    err = roofline.cell({"arch": "a", "shape": "s", "mesh": "single",
                         "error": "boom"})
    for c in (skip, err):
        assert c.bottleneck == "-" and c.roofline_fraction == 0.0


@pytest.fixture
def records(tmp_path):
    """The port's dry run of llama3.2-1b at decode_32k (both layouts) and
    long_500k (skipped), written to tmp_path; a hand-made failed record
    beside them."""
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                        "--mesh", "single", "--out", str(tmp_path)]) == 0
    assert not dist.is_initialized()    # the dry run leaves no group
    (tmp_path / "x__train_4k__single.json").write_text(json.dumps(
        {"arch": "x", "shape": "train_4k", "mesh": "single",
         "error": "RuntimeError()"}))
    return tmp_path


def test_table_and_rows_on_the_dry_runs_records(records):
    cells = roofline.load_cells(str(records))
    assert len(cells) == 4
    dec = next(c for c in cells if c.shape == "decode_32k"
               and c.mesh == "single")
    rec = json.loads((records / "llama3.2-1b__decode_32k__single.json")
                     .read_text())
    assert dec.compute_s == rec["flops_per_device"] / 989e12
    assert dec.memory_s == rec["hbm_bytes_per_device"] / 3.35e12
    assert dec.collective_s == rec["collective_bytes_per_device"] / 450e9
    assert dec.bottleneck == "collective"
    table = roofline.table(str(records)).splitlines()
    assert table[0].startswith("| arch | shape | compute s")
    assert len(table) == 2 + 3          # the single-layout cells
    assert any("| skipped |" in line for line in table)
    assert any("| error |" in line for line in table)
    assert any(line.startswith("| llama3.2-1b | decode_32k |")
               and "| collective |" in line for line in table)
    assert len(roofline.table(str(records), mesh="multi").splitlines()) == 3
    rows = dict((t, d) for t, _, d in roofline.rows(str(records)))
    assert rows["roofline/llama3.2-1b/long_500k/single"].startswith("SKIP:")
    assert rows["roofline/x/train_4k/single"].startswith("ERROR:")
    assert "bottleneck=collective" in \
        rows["roofline/llama3.2-1b/decode_32k/multi"]
