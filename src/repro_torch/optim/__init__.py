"""AdamW with f32 master weights, the cosine schedule and global-norm
clipping, on trees of tensors."""
from .adamw import AdamW, AdamWState  # noqa: F401
