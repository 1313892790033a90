"""The table of ``rarefied_counts`` and the body site behind each of its
rows.

``table`` is bit for bit what ``inputs/rarefied_counts.py`` makes from the
same seed: that maker runs as it is. ``sites`` holds the site each sample
was drawn from, that maker's ``site_of`` codes, as a host int64 array: the
form in which a metadata column reaches a session. The codes are drawn
again from a generator seeded as that maker seeds its own, by the same
calls in the same order up to the draw of the samples' sites, so they are
the codes behind the table. Every site holds ``n // sites`` or one more
samples.
"""

import numpy as np
import torch

from perfbench.inputs import rarefied_counts


def make(config: dict, plan, device: torch.device) -> dict:
    out = rarefied_counts.make(config, plan, device)
    n, d, sites = int(config["n"]), int(config["d"]), int(config["sites"])
    gen = torch.Generator(device=device).manual_seed(plan.input_seed("table"))
    torch.randn((1 + sites, d), generator=gen, device=device)
    torch.rand((sites, d), generator=gen, device=device)
    torch.randint(0, sites, (d,), generator=gen, device=device)
    site_of = torch.randperm(n, generator=gen, device=device) % sites
    out["sites"] = site_of.cpu().numpy().astype(np.int64)
    return out
