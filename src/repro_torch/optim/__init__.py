from .adamw import (
    AdamWState,
    apply_updates,
    clip_by_global_norm,
    compress_int8,
    cosine_schedule,
    decompress_int8,
    global_norm,
    init_state,
)
