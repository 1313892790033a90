"""Arch registry: importing this package registers all 10 assigned
architectures (and their smoke reductions) into ``ARCHS`` / ``SMOKES``.

The counterpart of ``repro/configs/__init__.py``: all ten of the
reference's architectures, each ``CONFIG`` and ``SMOKE`` field for field the
reference's.

``--arch <id>`` ids use the assignment's spelling (dots/dashes); module
names use underscores.
"""

from repro_torch.configs.base import (ARCHS, SHAPES, SMOKES, ModelConfig,
                                      ShapeConfig)

# importing registers
from repro_torch.configs import recurrentgemma_9b      # noqa: F401
from repro_torch.configs import phi_3_vision_4_2b      # noqa: F401
from repro_torch.configs import grok_1_314b            # noqa: F401
from repro_torch.configs import granite_moe_1b_a400m   # noqa: F401
from repro_torch.configs import qwen3_8b               # noqa: F401
from repro_torch.configs import nemotron_4_340b        # noqa: F401
from repro_torch.configs import llama3_2_3b            # noqa: F401
from repro_torch.configs import qwen1_5_4b             # noqa: F401
from repro_torch.configs import mamba2_1_3b            # noqa: F401
from repro_torch.configs import seamless_m4t_medium    # noqa: F401


def get_arch(name: str, smoke: bool = False) -> ModelConfig:
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]


__all__ = ["ARCHS", "SMOKES", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_arch"]
