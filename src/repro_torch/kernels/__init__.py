"""Hand-written Hopper kernels for the memory-bound hot spots.

Each kernel keeps the reference's three-file layout
(``repro/kernels/__init__.py``):

* ``<name>.py``      — the launch of the CUDA kernel in ``csrc/<name>.cu``
                       (built for ``sm_90a`` by ``_build`` and bound with
                       ctypes), with its launch count;
* ``<name>_ops.py``  — the public wrapper: checks device, dtype, shape and
                       contiguity, owns the geometry, and dispatches — the
                       kernel on a CUDA tensor, the plain version on a CPU
                       tensor, no fallback from one to the other;
* ``<name>_ref.py``  — the plain PyTorch version of the same function.

Kernels ported so far. The main path (validate → matrix-free PCoA →
Mantel):

* ``symhollow``      — fused symmetric+hollow validation (paper Algorithm 7).
* ``center_matvec``  — fused center-matvec for matrix-free PCoA.
* ``permute_reduce`` — B permuted condensed multiply-reduces per tile, the
                       Mantel permutation hot loop; row-stationary on the
                       card (a row of x held, ys streamed once per
                       permutation).
* ``inverse_orders`` — the inverse and 16-bit orders of a tile that the
                       row-stationary kernels read, refusing any order row
                       that is not a permutation: a thread-block cluster a
                       row, each block a slice of its inverse in shared
                       memory (no Pallas counterpart; launch, plain version
                       and dispatch in one module).

The feature-table path (feature table → condensed distances → PCoA →
Mantel) and the materialized solves:

* ``pairwise``       — one row panel of pairwise distances for the five
                       metrics of ``repro_torch.dist``.
* ``center``         — two-pass Gower centering (paper Algorithm 2): pass 1
                       row sums, a fixed-order finish, pass 2.
* ``condensed_matvec`` — the centred-Gram product over a production's
                       condensed distances, D read straight from the
                       condensed vector, one launch a product (no Pallas
                       counterpart: the reference gathers row strips with
                       jnp ops).

The statistics battery runs on the kernels above; beside it, the
materialized Mantel baseline (paper Algorithm 5 over square operands):

* ``mantel_corr``    — B permuted square multiply-reduces per launch, the
                       permutation's row and column gather fused in,
                       row-stationary like ``permute_reduce``.

The LM serving and training paths (``repro_torch.models``,
``repro_torch.runtime``):

* ``rmsnorm``        — fused RMSNorm with the '1 + w' scale and fp32
                       statistics: every block, final and q/k norm of a
                       dense decoder; and its backward (``rmsnorm_bwd``,
                       one cooperative launch that sums dw in a fixed
                       order after a grid-wide barrier), which
                       ``rmsnorm_ops.RMSNormFunction`` runs under autograd
                       (no Pallas counterpart: the reference differentiates
                       its jnp norm).

This package imports nothing at import time, so no module here needs
``nvcc`` or a card to be imported.
"""
