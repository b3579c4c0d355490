"""Small stand-ins of the cells' configurations and traffic, for the CPU:
the published files with their widths, depths and lengths cut down."""
from __future__ import annotations

from perfbench import registry

JAMBA = dict(hidden_size=64, intermediate_size=96,
             num_attention_heads=4, num_key_value_heads=2,
             num_hidden_layers=8, vocab_size=300, mamba_dt_rank=4,
             mamba_d_state=8)
MINICPM = dict(hidden_size=64, intermediate_size=96,
               num_attention_heads=4, num_key_value_heads=4,
               num_hidden_layers=3, vocab_size=300)
CELLS = {"jamba-prefill": ("jamba-v0.1-52b-16L", "long-prompt-b8", JAMBA),
         "minicpm-decode": ("minicpm-2b", "conversation-b64", MINICPM)}


def config(cell: str, **over) -> dict:
    name, _, small = CELLS[cell]
    cfg = registry.data("configs", name)
    cfg.update(small, **over)
    return cfg


def traffic(cell: str) -> dict:
    tr = registry.data("traffic", CELLS[cell][1])
    tr.update(batch=2, levels=2,
              prompt={"min": 24, "max": 48, "multiple": 8},
              new_tokens={"min": 4, "max": 6, "multiple": 1})
    return tr
