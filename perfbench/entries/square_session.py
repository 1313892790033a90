"""A fresh square-backed ``Workspace`` over one input square, admitted
with validation (on the card one ``symhollow`` launch). The session stays
in the study's state for the tests after this one; it holds no hoist yet.
"""


def call(inputs, args, key, device, state):
    from repro_torch.api.config import ExecConfig
    from repro_torch.api.workspace import Workspace
    ws = Workspace(inputs[args["matrix"]], config=ExecConfig(device=device))
    state["workspace"] = ws
    return {"n": ws.n}
