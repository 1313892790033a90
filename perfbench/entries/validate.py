"""Admission: ``repro_torch.core.DistanceMatrix`` over each named square.

Each construction runs the port's fused symmetric-and-hollow check. The
validated matrices stay in the study's state for the calls after this one;
the outputs are the verdicts.
"""


def call(inputs, args, key, device, state):
    from repro_torch.core import DistanceMatrix, DistanceMatrixError
    verdicts = {}
    for name in args["matrices"]:
        try:
            state[name] = DistanceMatrix(inputs[name], device=device)
            verdicts[name] = True
        except DistanceMatrixError:
            verdicts[name] = False
    return verdicts
