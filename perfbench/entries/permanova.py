"""``Workspace.permanova`` of the study's session by the study's grouping,
its orders drawn by the port from the study's key. A square-backed session
runs the materialized Gower form (the ``center`` kernel pair, then one
product ``G @ Z`` a tile), a feature-backed one the operator form over the
condensed storage (on the card ``condensed_matvec`` launches, a slab of
128 columns each).

On the card the outputs also count the call's kernel launches by name,
read from the port's launch counters, and say whether the session holds
an n x n square (its ``"square"`` hoist).
"""

from perfbench.reference.groups import grouping


def call(inputs, args, key, device, state):
    from repro_torch.kernels import _build
    ws = state["workspace"]
    before = dict(_build.launches)
    result = ws.permanova(grouping(inputs, args, ws.n),
                          args["permutations"], key=key)
    launches = ({name: count - before[name] for name, count in
                 _build.launches.items() if count != before[name]}
                if device.type == "cuda" else None)
    return {"statistic": result.statistic, "p_value": result.p_value,
            "launches": launches, "square": "square" in ws.cache}


def summary(outputs):
    """What every study but the window's last keeps."""
    return {"statistic": outputs["statistic"],
            "p_value": outputs["p_value"]}
