"""PERMANOVA (Anderson 2001) on the hoisted-permutation engine.

The counterpart of ``repro/stats/permanova.py``. Pseudo-F for a one-way
design over a distance matrix, with the paper §4.2 split:

* **hoisted** (computed once): the centred Gower matrix
  ``G = −½ J D∘D J`` (``core.centering.center_distance_matrix``: on the
  card the ``center`` kernel pair), its trace ``SS_total`` (permutation
  invariant, McArdle & Anderson 2001), the one-hot design ``Z`` and the
  group sizes.
* **per permutation**: permuting the labels permutes the rows of Z, and
  ``SS_among = Σ_g ((Z_p − 1 wᵀ)ᵀ G Z_p)_gg / n_g``, w the groups' shares
  n_g / n: ``Σ_g (Z_pᵀ G Z_p)_gg / n_g − 1ᵀ G 1 / n``, the among-group sum
  of squares about the grand centroid (see ``_forms``).

The reference's engine vmaps ``per_perm`` over a tile, and XLA turns the
B products ``G @ Z_p`` into one. The port writes that vmap out as
``per_batch``: the tile's B permuted designs side by side as one (n, B·g)
matrix and one product a tile, ``torch.matmul(G, Z_cat)`` (a plain large
product, which the reference also leaves to XLA) or one ``op.matvec(Z_cat)``
for the operator form.

``permanova_ref`` mirrors scikit-bio's eager multi-pass evaluation
(condensed d², boolean group masks, one pass per group per permutation).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.centering import center_distance_matrix
from repro_torch.core.distance_matrix import DistanceMatrix
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.stats import engine
from repro_torch.stats.engine import PermutationTestResult


def _design(grouping: torch.Tensor, num_groups: int,
            dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The one-hot (n, g) design and the (g,) group sizes."""
    z = torch.nn.functional.one_hot(grouping.long(), num_groups).to(dtype)
    return z, torch.sum(z, dim=0)


def _permuted_designs(z: torch.Tensor, orders: torch.Tensor) -> torch.Tensor:
    """The B permuted designs ``Z[o_b]`` of a tile side by side: (n, B·g),
    columns ``b·g .. b·g + g − 1`` for permutation b."""
    perms, n = orders.shape
    return z[orders.long()].permute(1, 0, 2).reshape(n, perms * z.shape[1])


def _forms(inv: dict, z: torch.Tensor, product: torch.Tensor,
           num_groups: int) -> torch.Tensor:
    """The (B, g) forms ``diag((Z_p − 1 wᵀ)ᵀ G Z_p)`` of B designs side by
    side in ``z`` (n, B·g), ``product = G z``, w the groups' shares.

    Centring the weights is a no-op for an exactly centred G (``1ᵀG = 0``).
    The G of fp32 arithmetic carries its centring's rounding in its row and
    grand means, an error ``a1ᵀ + 1aᵀ + c11ᵀ``, which the centred weights
    cancel: summed over the groups it adds nothing. Where the groups barely
    differ SS_among is about (g − 1) / (n − 1) of SS_total, and with the
    plain design that rounding alone moves F by up to 2e-4 of itself
    (n = 16384, 4 groups, the ``center`` pair on an H100)."""
    n = z.shape[0]
    centred = z.reshape(n, -1, num_groups) - inv["shares"]
    return torch.sum(centred * product.reshape(n, -1, num_groups), dim=0)


def _pseudo_f(inv: dict, s: torch.Tensor, n: int,
              num_groups: int) -> torch.Tensor:
    """F from the (..., g) quadratic forms ``diag(Z_pᵀ G Z_p)``."""
    ss_among = torch.sum(s / inv["sizes"], dim=-1)
    ss_within = inv["ss_total"] - ss_among
    return (ss_among / (num_groups - 1)) / (ss_within / (n - num_groups))


@dataclasses.dataclass
class PermanovaStatistic:
    """Pseudo-F with the permutation-invariant pieces hoisted.

    ``pre`` optionally carries the hoist ``{"g": <centred Gower matrix>}``
    so tests on one matrix share the centering pass."""

    dm: torch.Tensor          # (n, n) validated distance matrix
    grouping: torch.Tensor    # (n,) int group codes in [0, num_groups)
    n: int
    num_groups: int
    pre: Optional[dict] = None

    def hoist(self) -> dict:
        g = self.pre["g"] if self.pre is not None else \
            center_distance_matrix(self.dm)
        z, sizes = _design(self.grouping.to(g.device), self.num_groups,
                           g.dtype)
        return {"g": g, "z": z, "sizes": sizes, "shares": sizes / self.n,
                "ss_total": torch.trace(g)}

    def per_perm(self, inv: dict, order: torch.Tensor) -> torch.Tensor:
        z = inv["z"][order.long()]                   # O(n·g) label gather
        s = _forms(inv, z, inv["g"] @ z, self.num_groups)[0]
        return _pseudo_f(inv, s, self.n, self.num_groups)

    def per_batch(self, inv: dict, orders: torch.Tensor) -> torch.Tensor:
        return engine.fixed_products(lambda o: self._batch(inv, o), orders)

    def _batch(self, inv: dict, orders: torch.Tensor) -> torch.Tensor:
        zc = _permuted_designs(inv["z"], orders)
        s = _forms(inv, zc, torch.matmul(inv["g"], zc), self.num_groups)
        return _pseudo_f(inv, s, self.n, self.num_groups)


@dataclasses.dataclass
class PermanovaOperatorStatistic:
    """Pseudo-F with the Gower centering held as an OPERATOR, not a matrix.

    The quadratic forms touch G only through products with the skinny
    permuted design, and ``SS_total = tr(G)`` comes from the operator's
    hoisted means. ``op`` is a ``core.operators.CenteredGramOperator`` (on
    the card, one ``center_matvec`` launch a tile of up to 128 columns) or a
    ``CondensedCenteredGramOperator`` over a production's condensed
    distances, where the square Gower matrix never exists."""

    op: object                # centred-Gram operator (G as an operator)
    grouping: torch.Tensor    # (n,) int group codes in [0, num_groups)
    n: int
    num_groups: int

    def hoist(self) -> dict:
        z, sizes = _design(self.grouping.to(self.op.row_means.device),
                           self.num_groups, self.op.dtype)
        return {"z": z, "sizes": sizes, "shares": sizes / self.n,
                "ss_total": self.op.trace()}

    def per_perm(self, inv: dict, order: torch.Tensor) -> torch.Tensor:
        z = inv["z"][order.long()]
        s = _forms(inv, z, self.op.matvec(z), self.num_groups)[0]
        return _pseudo_f(inv, s, self.n, self.num_groups)

    def per_batch(self, inv: dict, orders: torch.Tensor) -> torch.Tensor:
        return engine.fixed_products(lambda o: self._batch(inv, o), orders)

    def _batch(self, inv: dict, orders: torch.Tensor) -> torch.Tensor:
        zc = _permuted_designs(inv["z"], orders)
        s = _forms(inv, zc, self.op.matvec(zc), self.num_groups)
        return _pseudo_f(inv, s, self.n, self.num_groups)


def permanova(dm: DistanceMatrix, grouping, permutations: int = 999,
              key: Union[int, torch.Generator, None] = None,
              batch_size: int = engine.WORKSPACE_BATCH,
              orders: Optional[torch.Tensor] = None,
              device: DeviceLike = None) -> PermutationTestResult:
    """Hoisted+fused PERMANOVA with the materialized G on ``device``
    (``None``: the card); one-sided (greater), like scikit-bio. ``key`` and
    ``orders`` as in ``engine.permutation_test``. A thin wrapper over a
    one-shot ``api.Workspace``: a study running several tests should hold
    its own Workspace so the centering hoist is shared."""
    from repro_torch.api.config import ExecConfig
    from repro_torch.api.workspace import Workspace
    # validate=False: trust the DistanceMatrix as constructed
    return Workspace(dm, config=ExecConfig(device=device),
                     validate=False).permanova(grouping, permutations, key,
                                               batch_size=batch_size,
                                               orders=orders)


# --------------------------------------------------------------------------
# Oracle — scikit-bio's evaluation order, deliberately eager and multi-pass
# --------------------------------------------------------------------------
def permanova_ref(dm: DistanceMatrix, grouping, permutations: int = 999,
                  key: Union[int, torch.Generator, None] = None,
                  orders: Optional[torch.Tensor] = None
                  ) -> PermutationTestResult:
    """Per permutation: rebuild the pair masks and walk the condensed d²
    vector once per group, each step an eager full-vector pass."""
    codes, num_groups = engine.encode_grouping(grouping)
    n = len(dm)
    if codes.size != n:
        raise ValueError("grouping length does not match distance matrix")
    codes = torch.from_numpy(codes).to(dm.device)
    d2 = dm.condensed_form() ** 2
    iu = torch.triu_indices(n, n, 1, device=dm.device)
    sizes = torch.bincount(codes.long(), minlength=num_groups).tolist()
    ss_total = float(torch.sum(d2)) / n
    dof_among = num_groups - 1
    dof_within = n - num_groups

    def f_stat(order):
        g_p = codes[order.long()]
        gi, gj = g_p[iu[0]], g_p[iu[1]]
        same = gi == gj
        ss_within = 0.0
        for g in range(num_groups):                  # one pass per group
            mask = same & (gi == g)
            ss_within += float(torch.sum(torch.where(mask, d2, 0.0))) / sizes[g]
        ss_among = ss_total - ss_within
        return (ss_among / dof_among) / (ss_within / dof_within)

    observed = f_stat(torch.arange(n, device=dm.device))
    if orders is None:
        orders = engine.permutation_orders(key, permutations, n, dm.device)
    permuted = torch.tensor([f_stat(orders[p]) for p in range(permutations)],
                            dtype=torch.float32, device=dm.device)
    return engine.finish(torch.tensor(observed, dtype=torch.float32),
                         permuted, permutations, "greater", n)
