"""repro_torch.checkpoint: whole-state snapshots for training
(``CheckpointManager``) and the crash-safe serve journal.

The counterpart of ``repro/checkpoint``'s ``manager`` and ``journal``
modules.
"""

from repro_torch.checkpoint.journal import Journal, replay
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "Journal", "replay"]
