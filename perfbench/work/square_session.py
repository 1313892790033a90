"""Least work of admitting a square to a session: validation, every entry
of the (n, n) fp32 square read once (``work/validate.py``)."""

from perfbench.work import validate


def count(inputs, args) -> dict:
    return validate.count(inputs, {"matrices": [args["matrix"]]})
