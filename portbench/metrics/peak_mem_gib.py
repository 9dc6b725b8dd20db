"""peak_mem_gib (GiB, the allocator's counter): ``torch.cuda.max_memory_allocated()``
over the window, after ``reset_peak_memory_stats()`` at its start."""


def read(rec):
    return rec["window_peak_bytes"] / 2**30
