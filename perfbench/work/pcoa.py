"""Least work of the fsvd PCoA of an (n, n) fp32 square.

The square is read once. The randomized range finder of the source
(``skbio.stats.ordination.pcoa(method='fsvd')``, Halko et al. 2011) needs
the row means of E = -D*D/2 (2 n^2 operations) and 2 + POWER_ITERS products
of the centred Gram matrix with an (n, p) block, p = min(k + 10, n), each
2 n^2 p operations; the QR steps and the p x p eigensolve are left out.
"""

OVERSAMPLE = 10
POWER_ITERS = 2


def count(inputs, args) -> dict:
    n = int(inputs[args["matrix"]].shape[0])
    p = min(int(args["dimensions"]) + OVERSAMPLE, n)
    products = 2 + POWER_ITERS
    return {"ops": 2 * n * n + products * 2 * n * n * p,
            "bytes": 4 * n * n, "precision": "fp32"}
