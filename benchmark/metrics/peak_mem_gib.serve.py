"""Peak device memory of the serving window, GiB
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``)."""
from benchmark.harness.readers import peak_gib as read  # noqa: F401
