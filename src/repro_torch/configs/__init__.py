"""Arch registry: importing this package registers the ported architectures
(and their smoke reductions) into ``ARCHS`` / ``SMOKES``.

The counterpart of ``repro/configs/__init__.py``. The dense decoders whose
blocks are ported (``attn`` blocks only) are registered; the other seven
architectures need blocks that are not ported yet (MoE, SSD, RG-LRU,
local attention, enc-dec, the vision frontend), and ``get_arch`` says so
for them rather than pretend they are unknown.

``--arch <id>`` ids use the assignment's spelling (dots/dashes); module
names use underscores.
"""

from repro_torch.configs.base import (ARCHS, SHAPES, SMOKES, ModelConfig,
                                      ShapeConfig)

# importing registers
from repro_torch.configs import llama3_2_3b      # noqa: F401
from repro_torch.configs import qwen1_5_4b       # noqa: F401
from repro_torch.configs import qwen3_8b         # noqa: F401

#: the reference's other architectures, registered once their blocks are
#: ported (ROADMAP.md, queue 1).
NOT_YET_PORTED = ("recurrentgemma-9b", "phi-3-vision-4.2b", "grok-1-314b",
                  "granite-moe-1b-a400m", "nemotron-4-340b", "mamba2-1.3b",
                  "seamless-m4t-medium")


def get_arch(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch (its blocks "
            f"wait in ROADMAP.md, queue 1); ported: {sorted(table)}")
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]


__all__ = ["ARCHS", "SMOKES", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_arch"]
