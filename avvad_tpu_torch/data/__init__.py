from .batching import Batch, bucket_length, pad_batch

__all__ = ["Batch", "bucket_length", "pad_batch"]
