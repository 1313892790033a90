"""A frozen copy of the port's documented permutation draw.

``repro_torch.stats.engine.permutation_orders``: the orders of a key are the
stable argsort of (K, n) words drawn uniformly from [0, 2^32) by
``torch.randint`` on a CPU ``torch.Generator`` seeded with the key.
"""

import torch


def permutation_orders(key: int, permutations: int, n: int,
                       device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(int(key))
    words = torch.randint(0, 2**32, (permutations, n), dtype=torch.int64,
                          generator=gen)
    return torch.argsort(words.to(device), dim=-1, stable=True)
