"""``Workspace.pcoa`` of the study's session: the matrix-free solve over
the operator the production built, its sketch drawn from the study's key."""


def call(inputs, args, key, device, state):
    result = state["workspace"].pcoa(args["dimensions"],
                                     method=args["method"], key=key)
    return {"eigenvalues": result.eigenvalues,
            "proportion_explained": result.proportion_explained}
