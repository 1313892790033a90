"""Arch registry: importing this package registers the ported architectures
(and their smoke reductions) into ``ARCHS`` / ``SMOKES``.

The counterpart of ``repro/configs/__init__.py``. The architectures whose
blocks are ported (``attn``, ``local`` and ``moe`` blocks, and the vision
frontend) are registered; the other three need blocks that are not ported
yet (SSD, RG-LRU, enc-dec), and ``get_arch`` says so for them rather than
pretend they are unknown.

``--arch <id>`` ids use the assignment's spelling (dots/dashes); module
names use underscores.
"""

from repro_torch.configs.base import (ARCHS, SHAPES, SMOKES, ModelConfig,
                                      ShapeConfig)

# importing registers
from repro_torch.configs import phi_3_vision_4_2b      # noqa: F401
from repro_torch.configs import grok_1_314b            # noqa: F401
from repro_torch.configs import granite_moe_1b_a400m   # noqa: F401
from repro_torch.configs import qwen3_8b               # noqa: F401
from repro_torch.configs import nemotron_4_340b        # noqa: F401
from repro_torch.configs import llama3_2_3b            # noqa: F401
from repro_torch.configs import qwen1_5_4b             # noqa: F401

#: the reference's other architectures, registered once their blocks are
#: ported (ROADMAP.md, queue 1).
NOT_YET_PORTED = ("recurrentgemma-9b", "mamba2-1.3b", "seamless-m4t-medium")


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
