from .video import (fps_block_schedule, fps_block_src_max, fps_resample_indices,
                    unique_frame_schedule)

__all__ = ["fps_block_schedule", "fps_block_src_max", "fps_resample_indices",
           "unique_frame_schedule"]
