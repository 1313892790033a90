"""repro_torch.checkpoint: the crash-safe serve journal.

The counterpart of ``repro/checkpoint``'s ``journal`` module; the
reference's ``CheckpointManager`` (whole-pytree snapshots) is not ported
yet.
"""

from repro_torch.checkpoint.journal import Journal, replay

__all__ = ["Journal", "replay"]
