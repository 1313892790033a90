"""``repro_torch.core.mantel`` of two validated squares, its permutation
orders drawn by the port from the study's key."""


def call(inputs, args, key, device, state):
    from repro_torch.core import mantel
    statistic, p_value, _ = mantel(
        state[args["x"]], state[args["y"]],
        permutations=args["permutations"], key=key,
        alternative=args["alternative"], device=device)
    return {"statistic": statistic, "p_value": p_value}
