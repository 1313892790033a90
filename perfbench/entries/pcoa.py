"""``repro_torch.core.pcoa`` of a validated square, its sketch drawn from
the study's key."""


def call(inputs, args, key, device, state):
    from repro_torch.core import pcoa
    result = pcoa(state[args["matrix"]], dimensions=args["dimensions"],
                  method=args["method"], key=key, device=device)
    return {"eigenvalues": result.eigenvalues,
            "proportion_explained": result.proportion_explained}
