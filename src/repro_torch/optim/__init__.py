"""repro_torch.optim: AdamW with a warmup + cosine schedule and global-norm
clipping. The reference's ``optim/compression.py`` (``compressed_psum``
over a pod axis) waits for the LM on a mesh (ROADMAP.md, item 13)."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     init_opt_state, lr_schedule)

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "lr_schedule"]
