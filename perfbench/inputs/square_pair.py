"""Two square fp32 distance matrices, ``x`` and ``y``, made on the device.

A frozen copy of ``repro_torch.core.random_distance_matrix``'s arithmetic:
the Euclidean distances of ``n`` points of ``dim`` standard normal
coordinates, made exactly symmetric and hollow. The points of ``y`` are
drawn from a generator of their own, independent of ``x``'s, so the
observed Mantel r lies inside its null. Points are drawn on the device from
a ``torch.Generator`` seeded from the run's seed, in one call each.
"""

import torch


def distances(points: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(points * points, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (points @ points.T)
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    d = 0.5 * (d + d.T)
    d.fill_diagonal_(0.0)
    return d.contiguous()


def make(config: dict, plan, device: torch.device) -> dict:
    n, dim = int(config["n"]), int(config["dim"])
    out = {}
    for name in ("x", "y"):
        gen = torch.Generator(device=device).manual_seed(plan.input_seed(name))
        points = torch.randn((n, dim), generator=gen, device=device,
                             dtype=torch.float32)
        out[name] = distances(points)
    return out
