"""Result types of the port (the session API is not ported yet)."""

from repro_torch.api.results import OrdinationResult

__all__ = ["OrdinationResult"]
