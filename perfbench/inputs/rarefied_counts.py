"""One fp32 table of OTU counts, ``n`` samples by ``d`` OTUs, rarefied to an
even depth, made on the device.

Each sample comes from one of ``sites`` body sites, the same number of
samples from each (up to one) for every seed. A site's community is a pool
of OTUs: those whose home it is (each OTU has one, drawn uniformly) and
each other OTU with probability ``pool_share``, weighted by a
log-normal abundance the OTU has everywhere (spread ``spread_otu``) times
one it has at that site (``spread_site``). A sample's profile is its site's
times a log-normal factor of its own (``spread_sample``), and its row holds
``depth`` reads drawn from that profile with replacement, as QIIME 2
``core-metrics`` rarefies a table to one sampling depth before beta
diversity. All draws come from one ``torch.Generator`` on the device,
seeded from the run's seed, in a few large calls.
"""

import torch


def make(config: dict, plan, device: torch.device) -> dict:
    n, d, sites = int(config["n"]), int(config["d"]), int(config["sites"])
    gen = torch.Generator(device=device).manual_seed(plan.input_seed("table"))
    z = torch.randn((1 + sites, d), generator=gen, device=device)
    site_log = config["spread_otu"] * z[:1] + config["spread_site"] * z[1:]
    pools = torch.rand((sites, d), generator=gen, device=device) \
        < config["pool_share"]
    home = torch.randint(0, sites, (d,), generator=gen, device=device)
    pools[home, torch.arange(d, device=device)] = True
    site_of = torch.randperm(n, generator=gen, device=device) % sites
    log_q = site_log[site_of]
    log_q += config["spread_sample"] * torch.randn(
        (n, d), generator=gen, device=device)
    log_q -= log_q.max(dim=1, keepdim=True).values
    q = torch.where(pools[site_of], torch.exp(log_q), 0.0)
    del log_q
    reads = torch.multinomial(q, int(config["depth"]), replacement=True,
                              generator=gen)
    del q
    table = torch.zeros((n, d), dtype=torch.float32, device=device)
    table.scatter_add_(1, reads, torch.ones(reads.shape, device=device))
    return {"table": table}
