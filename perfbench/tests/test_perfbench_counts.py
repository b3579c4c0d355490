"""The work counts of perfbench/counts: the kernels' bounds at the shapes
of the port's kernel table, and the prefill's FLOPs against
FlopCounterMode's count of the port's own prefill on the CPU."""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import registry
from perfbench.tests import tiny


def count(name):
    return registry.module("counts", name)


@pytest.mark.parametrize("hd,hkv,want", [(64, 8, 0.00313), (128, 8, 0.00626)])
def test_flash_attention_bound(hd, hkv, want):
    ms, by, _, _ = count("flash_attention").bound(4, 32, hkv, 256, 256, hd)
    assert round(ms, 5) == want and by == "bytes"


@pytest.mark.parametrize("hd,want", [(64, 0.00067), (128, 0.00135)])
def test_flash_decode_bound(hd, want):
    ms, by, _, _ = count("flash_decode").bound(4, 32, 8, 512, hd, 272)
    assert round(ms, 5) == want and by == "bytes"


@pytest.mark.parametrize("S,want,by", [(256, 0.03210, "special-function"),
                                       (1, 0.00153, "bytes")])
def test_mamba_scan_bound(S, want, by):
    ms, got_by, _, _ = count("mamba_scan").bound(4, S, 8192, 16)
    assert round(ms, 5) == want and got_by == by


def test_causal_pairs_match_the_loop():
    fa = count("flash_attention")
    for q_offset, Sq, Skv, kv_len in ((0, 7, 7, None), (3, 5, 9, 6),
                                      (0, 9, 9, 4)):
        _, _, _, flops = fa.bound(1, 1, 1, Sq, Skv, 1, q_offset=q_offset,
                                  kv_len=kv_len)
        valid = Skv if kv_len is None else min(Skv, kv_len)
        pairs = sum(min(valid, q + q_offset + 1) for q in range(Sq))
        assert flops == 4.0 * pairs


def plan_of(cfg):
    return registry.module("models", cfg["model_type"]).plan(cfg)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_prefill_flops_equal_the_ports(cell):
    from repro_torch.models.lm import LM
    cfg = tiny.config(cell)
    plan = plan_of(cfg)
    adapter = registry.module("adapters", cfg["model_type"])
    model = LM(adapter.port_config(cfg), dtype=torch.float32, device="cpu")
    B, S = 2, 24
    tokens = torch.randint(0, cfg["vocab_size"], (B, S))
    with FlopCounterMode(display=False) as fc:
        model.prefill({"tokens": tokens}, S + 4)
    assert fc.get_total_flops() == count("prefill").executed_plain(plan, B, S)


def test_model_flops_count_only_the_picked_experts():
    cfg = tiny.config("jamba-prefill")
    plan = plan_of(cfg)
    dense, routed, moe = count("prefill").products(plan)
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    assert moe == [3 * d * f] * 4
    assert routed == 4 * 3 * d * f * cfg["num_experts_per_tok"]
    flops = count("prefill").model_flops(plan, 1, 1)
    # one attention layer in a period of eight, one (query, key) pair
    assert flops == 2.0 * (dense + routed) + \
        4.0 * (d // cfg["num_attention_heads"]) * \
        cfg["num_attention_heads"] + 2.0 * d * cfg["vocab_size"]


def test_decode_bytes_at_the_published_sizes():
    """Jamba's two periods at batch 8 read every expert (16 <= 8 x 2):
    the 51.6 GB of weights of the port's decode floor, and MiniCPM reads
    5.45 GB of weights and 368,640 bytes a cached position."""
    jamba = plan_of(registry.data("configs", "jamba-v0.1-52b-16L"))
    _, nbytes, _ = count("decode").step(jamba, 8, 0)
    assert math.isclose(nbytes, 51.6e9, rel_tol=0.01)
    mini = plan_of(registry.data("configs", "minicpm-2b"))
    _, b0, _ = count("decode").step(mini, 64, 0)
    _, b1, _ = count("decode").step(mini, 64, 1)
    assert math.isclose(b0, 5.45e9, rel_tol=0.01)
    assert b1 - b0 == 64 * 368_640
