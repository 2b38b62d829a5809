"""AdamW with the reference's update, schedules and clipping."""

from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    clip_by_global_norm, constant_schedule, cosine_schedule,
                    global_norm, linear_schedule)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule",
           "global_norm", "linear_schedule"]
