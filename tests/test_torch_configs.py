"""The port's config registry, parameter counts and input-shape cells
against the JAX package's, on the CPU.

``param_count`` and ``active_param_count`` are copied with the reference's
miscounts (xlstm-125m's mLSTM term, Jamba's mamba term): the port's counts
equal the reference's for all ten configs, not the specs' element counts.
"""
import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import all_configs as jall_configs  # noqa: E402
from repro.models import config as jmc  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.configs import all_configs  # noqa: E402

ARCHS = sorted(jall_configs())


def test_all_configs_has_the_references_keys():
    assert sorted(all_configs()) == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_counts_equal_the_references(arch):
    cfg, jcfg = all_configs()[arch], jall_configs()[arch]
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.active_param_count() <= cfg.param_count()
    assert (cfg.active_param_count() < cfg.param_count()) == \
        (cfg.moe_period > 0 and cfg.experts_per_token < cfg.n_experts)


def test_shape_cells_equal_the_references():
    assert len(models.ALL_SHAPES) == len(jmc.ALL_SHAPES) == 4
    for got, want in zip(models.ALL_SHAPES, jmc.ALL_SHAPES):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (models.TRAIN_4K, models.PREFILL_32K, models.DECODE_32K,
            models.LONG_500K) == models.ALL_SHAPES
    with pytest.raises(dataclasses.FrozenInstanceError):
        models.TRAIN_4K.seq_len = 1


def test_every_kind_has_a_mixer_and_an_unknown_kind_is_a_keyerror():
    """Nothing is left to refuse as not ported: the port's mixer registry
    is the reference's, and an unknown kind raises the reference's
    ``KeyError``."""
    from repro.models import blocks as jblocks
    from repro_torch.models import blocks
    assert sorted(blocks.MIXERS) == sorted(jblocks.MIXERS)
    kinds = {k for cfg in all_configs().values() for k in cfg.full_pattern}
    assert kinds <= set(blocks.MIXERS)
    assert not hasattr(blocks, "not_ported")
    assert not hasattr(blocks, "_NOT_PORTED")
    with pytest.raises(KeyError):
        blocks.mixer("mrope")
    with pytest.raises(KeyError):
        jblocks.MIXERS["mrope"]
