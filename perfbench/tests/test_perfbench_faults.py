"""The check fails what it must, at a small size on the CPU: a run drives
everything but the look for a card, with the served path broken
underneath (``perfbench/faults.py``), and ``correct`` comes out false
under the cell's own limits; and the float8 control reads far above the
sound program."""
import pytest
import torch

from perfbench import check, harness, registry
from perfbench.faults import FAULTS
from perfbench.tests import tiny

# MiniCPM's logits scale with the root of its width (its tied table is
# drawn at a fixed std): at 576 they spread as the published width's do
# within a factor of two, so the cell's own limit applies.  Jamba's tiny
# stand-in routes each token to both of two experts, so that no near tie
# of the router decides its sound readings.
SIZES = {"jamba-prefill": dict(num_experts=2, num_experts_per_tok=2),
         "minicpm-decode": dict(hidden_size=576, num_attention_heads=9,
                                num_key_value_heads=9, intermediate_size=256)}


def run(cell, seed, patch=None, control=False):
    return harness.run_cell(
        cell, seed, 1.0, False, device="cpu",
        config=tiny.config(cell, **SIZES[cell]), traffic=tiny.traffic(cell),
        patch=patch, control=control, log=lambda s: None)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_sound_runs_are_correct(cell):
    out = run(cell, 2 ** 31 + 11)
    assert out["correct"] is True, out["compared"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_fault_is_not_correct(cell, fault):
    torch.manual_seed(0)
    out = run(cell, 2 ** 31 + 12, patch=FAULTS[fault])
    assert out["correct"] is False, out["compared"]


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_the_control_reads_far_above_the_program(cell):
    """The float8 reference in the program's place: each number the cell
    compares reads at least three times the sound program's."""
    limits = registry.data("limits", cell)
    out = run(cell, 2 ** 31 + 13, control=True)
    got = out["readings"]
    for name in limits["compare"]:
        assert got["control"][name] >= 3 * got["program"][name], got
    ok, _ = check.judged(got["control"], {"compare": {
        n: 2 * got["program"][n] for n in limits["compare"]}})
    assert not ok
