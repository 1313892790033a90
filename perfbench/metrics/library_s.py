"""Host seconds the port's first ``library()`` call took in this process
(digest, build if one was needed, ``dlopen``, binding), as the port counts
them in ``repro_torch.kernels._build.load_seconds``, read once the window
has closed; None where the port keeps no such count or loaded nothing."""

import sys


def read(run):
    build = sys.modules.get("repro_torch.kernels._build")
    return getattr(build, "load_seconds", None) or None
