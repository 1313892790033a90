"""``Workspace.anosim`` of the study's session by the study's grouping,
its orders drawn by the port from the study's key: the session's condensed
ranks, then one ``permute_reduce`` pair a tile."""

from perfbench.reference.groups import grouping


def call(inputs, args, key, device, state):
    ws = state["workspace"]
    result = ws.anosim(grouping(inputs, args, ws.n), args["permutations"],
                       key=key)
    return {"statistic": result.statistic, "p_value": result.p_value}


def summary(outputs):
    """What every study but the window's last keeps."""
    return {"statistic": outputs["statistic"],
            "p_value": outputs["p_value"]}
