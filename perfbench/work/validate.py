"""Least work of validating each named square: every entry read once and
each pair (i, j), i < j, compared with (j, i) once, the diagonal against 0."""


def count(inputs, args) -> dict:
    ops = bytes_ = 0
    for name in args["matrices"]:
        n = int(inputs[name].shape[0])
        ops += n * (n - 1) // 2 + n
        bytes_ += 4 * n * n
    return {"ops": ops, "bytes": bytes_, "precision": "fp32"}
