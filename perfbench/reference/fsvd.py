"""The PCoA eigen-solve of a square distance matrix, plain PyTorch.

The centred Gram matrix F = J E J of E = -D*D/2 is applied as
F @ X = E @ X - r (1'X) - 1 (r'X) + g 1 (1'X), with r the row means of E
and g their mean. The solve is the randomized range finder of the source
(Halko et al. 2011, as ``skbio.stats.ordination.pcoa(method='fsvd')`` runs
it and the port documents it): Y = F Omega, QR, two power iterations, the
projection T = Q'FQ, its exact eigh, the top k. Omega is the port's
documented draw: ``torch.randn((n, k + 10))`` in fp32 on a CPU generator
seeded with the key. The proportion explained clamps negative eigenvalues
to 0 over the total inertia tr(F) = -n g (D is hollow).

``precision="fp64"`` is the reference. ``"tf32"`` is the control: E and
each block are rounded to TF32 before each product, which runs in fp32.
"""

import torch

from perfbench.reference.precision import round_tf32

OVERSAMPLE = 10
POWER_ITERS = 2


class Gram:
    """The centred Gram operator of a square D in one precision."""

    def __init__(self, d: torch.Tensor, precision: str = "fp64"):
        self.precision = precision
        dtype = torch.float64 if precision == "fp64" else torch.float32
        e = d.to(dtype, copy=True)
        e.mul_(e).mul_(-0.5)
        self.r = e.mean(dim=1)
        self.g = self.r.mean()
        self.e = round_tf32(e) if precision == "tf32" else e
        self.n = d.shape[0]
        self.dtype = dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        ex = self.e @ (round_tf32(x) if self.precision == "tf32" else x)
        ones_x = x.sum(dim=0, keepdim=True)
        return (ex - self.r[:, None] * ones_x - (self.r @ x)[None, :]
                + self.g * ones_x)

    def total(self) -> torch.Tensor:
        return -self.n * self.g


def omega(key: int, n: int, p: int, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(int(key))
    return torch.randn((n, p), generator=gen,
                       dtype=torch.float32).to(device)


def solve(gram: Gram, key: int, k: int) -> dict:
    """``{"eigenvalues", "proportion_explained"}`` of the top ``k``."""
    n = gram.n
    k = min(k, n)
    p = min(k + OVERSAMPLE, n)
    q, _ = torch.linalg.qr(gram.matvec(omega(key, n, p, gram.e.device)))
    for _ in range(POWER_ITERS):
        q, _ = torch.linalg.qr(gram.matvec(q))
    t = q.T @ gram.matvec(q)
    t = 0.5 * (t + t.T)
    evals = torch.linalg.eigvalsh(t)
    evals = torch.sort(evals, descending=True).values[:k]
    total = gram.total()
    pos = torch.clamp_min(evals, 0.0)
    prop = pos / total if float(total) > 0 else torch.zeros_like(pos)
    return {"eigenvalues": evals, "proportion_explained": prop}


def gaps(program: dict, reference: dict) -> dict:
    """The widest eigenvalue gap as a share of the largest reference
    eigenvalue, and the widest gap of the proportion explained."""
    ev_p = torch.as_tensor(program["eigenvalues"]).double().cpu()
    ev_r = reference["eigenvalues"].double().cpu()
    pr_p = torch.as_tensor(program["proportion_explained"]).double().cpu()
    pr_r = reference["proportion_explained"].double().cpu()
    if ev_p.shape != ev_r.shape or pr_p.shape != pr_r.shape:
        return {"eig_gap": float("inf"), "prop_gap": float("inf")}
    scale = max(float(ev_r.abs().max()), 1e-30)
    return {"eig_gap": float((ev_p - ev_r).abs().max()) / scale,
            "prop_gap": float((pr_p - pr_r).abs().max())}


def judge_studies(gram_ref: Gram, gram_low, name: str, args: dict,
                  studies, control: bool) -> dict:
    """The worst gaps over every study: the program's outputs (or, for the
    control, the solve on ``gram_low``) against the reference solve."""
    worst = {"eig_gap": 0.0, "prop_gap": 0.0}
    k = int(args["dimensions"])
    for study in studies:
        out = study.outputs.get(name)
        if out is None:
            continue
        ref = solve(gram_ref, study.key, k)
        got = solve(gram_low, study.key, k) if control else out
        for reading, value in gaps(got, ref).items():
            worst[reading] = max(worst[reading], value)
    return worst
