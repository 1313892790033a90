"""A fresh ``Workspace.from_features`` session and its ``condensed()``
distances: the production, panel by panel.

The session stays in the study's state for the calls after this one. On the
card the outputs count the kernel launches the call made, read from the
port's launch counters: a production that ran launches its panels.
"""


def call(inputs, args, key, device, state):
    from repro_torch.api.config import ExecConfig
    from repro_torch.api.workspace import Workspace
    from repro_torch.kernels import _build
    before = sum(_build.launches.values())
    ws = Workspace.from_features(inputs[args["table"]], args["metric"],
                                 config=ExecConfig(device=device))
    condensed = ws.condensed()
    state["workspace"] = ws
    launches = (sum(_build.launches.values()) - before
                if device.type == "cuda" else None)
    return {"condensed": condensed, "launches": launches}


def summary(outputs):
    """What every study but the window's last keeps: the launch count."""
    return {"condensed": None, "launches": outputs["launches"]}
