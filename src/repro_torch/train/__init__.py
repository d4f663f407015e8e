"""Training loop, checkpointing, compression, fault tolerance."""
from .train_step import TrainState, init_train_state, make_train_step  # noqa: F401
from .checkpoint import (save_checkpoint, restore_checkpoint,  # noqa: F401
                         latest_checkpoint, step_of)
from .compression import (compress_grads, init_error_feedback,  # noqa: F401
                          compressed_psum, quantize_tensor,
                          dequantize_tensor)
