"""``Workspace.permdisp`` of the study's session by the study's grouping:
the session's fsvd ordination (its sketch the port's default), then the
dispersions about the group centroids, its orders drawn by the port from
the study's key."""

from perfbench.reference.groups import grouping


def call(inputs, args, key, device, state):
    ws = state["workspace"]
    result = ws.permdisp(grouping(inputs, args, ws.n), args["permutations"],
                         key=key, dimensions=args["dimensions"],
                         method=args["method"])
    return {"statistic": result.statistic, "p_value": result.p_value}


def summary(outputs):
    """What every study but the window's last keeps."""
    return {"statistic": outputs["statistic"],
            "p_value": outputs["p_value"]}
