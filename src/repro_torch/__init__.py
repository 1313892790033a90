"""PyTorch and CUDA port of ``repro`` for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors it module
for module (``repro/core/pcoa.py`` → ``repro_torch/core/pcoa.py``) and
imports nothing of it. Each Pallas kernel of the reference becomes a CUDA
kernel written for Hopper (``sm_90a``) under ``csrc/``, built on first use
(``kernels/_build.py``).

Every entry point runs on the card unless the caller passes
``device="cpu"`` (or, for a ``Workspace`` session, an ``ExecConfig`` with
``device="cpu"``), and raises when there is no card and the CPU was not
asked for. On the CPU each kernel wrapper runs its plain PyTorch version.

The reference is fp32 throughout, so TF32 is switched off here for
matrix products and convolutions. Its bf16 products (the LM stack)
accumulate in fp32, so cuBLAS's reduced-precision bf16 reduction is
switched off too.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

from repro_torch.api import ExecConfig  # noqa: E402
from repro_torch.core import (DistanceMatrix, DistanceMatrixError,  # noqa: E402
                              mantel, pcoa, random_distance_matrix)
from repro_torch.dist import (pairwise_condensed,  # noqa: E402
                              pairwise_distances)
from repro_torch.api.workspace import Workspace  # noqa: E402

__all__ = ["DistanceMatrix", "DistanceMatrixError", "ExecConfig", "Workspace",
           "mantel", "pairwise_condensed", "pairwise_distances", "pcoa",
           "random_distance_matrix"]
