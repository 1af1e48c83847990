from .video import fps_resample_indices, unique_frame_schedule

__all__ = ["fps_resample_indices", "unique_frame_schedule"]
