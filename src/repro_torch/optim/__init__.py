"""Optimizer substrate: AdamW, LR schedules (cosine + minicpm's WSD),
and int8 gradient compression with error feedback."""
from .adamw import (AdamWConfig, AdamWState, adamw_init,  # noqa: F401
                    adamw_update, clip_by_global_norm, global_norm,
                    make_optimizer)
from .compression import (compress_int8, compressed_allreduce_update,  # noqa
                          decompress_int8, init_error)
from .schedules import constant, cosine_schedule, wsd_schedule  # noqa: F401
