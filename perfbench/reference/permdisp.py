"""PERMDISP (Anderson 2006) with centroids, as the port computes it, plain
PyTorch.

The samples are ordinated by the fsvd PCoA of the study's square
(``reference/fsvd.py``: the same centred Gram operator, range finder and
sketch, the sketch drawn with the port's documented default seed, 42,
since the test passes none), k = ``args["dimensions"]`` coordinates a
sample, each axis scaled by the square root of its eigenvalue clamped at 0.
A sample's dispersion is its Euclidean distance to its group's centroid in
that space, and the statistic is the one-way ANOVA F of the dispersions
across the groups,

    F = (sum_g n_g (v_g - v)^2 / (g - 1)) / (sum_i (v_i - v_g(i))^2 / (n - g)).

Readings (``groups.judge_test``): ``permdisp_gap``, the widest gap of a
study's F as a share of the reference's F or of 1, whichever is larger,
and ``permdisp_p_outside``.

The reference solves and sums in fp64. The control is the fsvd solve with
TF32 products, the coordinates rounded to TF32, the rest in fp32.
"""

import torch

from perfbench.reference import fsvd, groups
from perfbench.reference.precision import round_tf32

#: the port's documented default seed of the fsvd sketch
SKETCH_SEED = 42


def coordinates(gram: fsvd.Gram, key: int, k: int) -> torch.Tensor:
    """(n, k) principal coordinates of the fsvd solve with the sketch of
    ``key``, in the operator's dtype."""
    n = gram.n
    p = min(k + fsvd.OVERSAMPLE, n)
    q, _ = torch.linalg.qr(gram.matvec(fsvd.omega(key, n, p, gram.e.device)))
    for _ in range(fsvd.POWER_ITERS):
        q, _ = torch.linalg.qr(gram.matvec(q))
    t = q.T @ gram.matvec(q)
    evals, vecs = torch.linalg.eigh(0.5 * (t + t.T))
    top = torch.argsort(evals, descending=True)[:k]
    return (q @ vecs[:, top]) * torch.sqrt(torch.clamp_min(evals[top], 0.0))


class Permdisp:
    def __init__(self, d: torch.Tensor, codes: torch.Tensor, num: int,
                 precision: str, args: dict):
        x = coordinates(fsvd.Gram(d, precision), SKETCH_SEED,
                        int(args["dimensions"]))
        self.x = round_tf32(x) if precision == "tf32" else x
        self.codes, self.groups, self.n = codes, num, codes.numel()

    def f(self, permuted: torch.Tensor) -> torch.Tensor:
        """(B,) F of the (B, n) labels."""
        z = groups.one_hot(permuted, self.groups, self.x.dtype)  # (B, n, g)
        sizes = torch.sum(z, dim=1)                              # (B, g)
        centroids = (z.transpose(1, 2) @ self.x) / sizes[..., None]
        v = torch.linalg.vector_norm(self.x - z @ centroids, dim=-1)
        means = (z.transpose(1, 2) @ v[..., None])[..., 0] / sizes
        grand = torch.mean(v, dim=1, keepdim=True)
        ss_between = torch.sum(sizes * (means - grand) ** 2, dim=1)
        ss_within = torch.sum((v - (z @ means[..., None])[..., 0]) ** 2,
                              dim=1)
        return (ss_between / (self.groups - 1)) / \
            (ss_within / (self.n - self.groups))

    def null(self, orders: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            self.f(self.codes[orders[b:b + groups.ORDERS_A_PRODUCT].long()])
            for b in range(0, orders.shape[0], groups.ORDERS_A_PRODUCT)
        ]).double().cpu()

    def observed(self) -> float:
        return float(self.null(groups.identity(self.n, self.x.device))[0])


def judge(name, inputs, args, studies, rng, limits, control=False) -> dict:
    return groups.judge_test(Permdisp, name, inputs, args, studies, rng,
                             limits, control, "permdisp", relative=True)
