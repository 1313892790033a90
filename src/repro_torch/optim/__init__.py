"""repro_torch.optim: AdamW with a warmup + cosine schedule and global-norm
clipping, and the reference's gradient compression with error feedback
(``optim.compression``: ``compressed_psum`` over a mesh axis)."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     init_opt_state, lr_schedule)
from repro_torch.optim.compression import (compressed_psum,
                                           dequantize_int8,
                                           init_error_state, quantize_int8)

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "lr_schedule",
           "quantize_int8", "dequantize_int8", "init_error_state",
           "compressed_psum"]
