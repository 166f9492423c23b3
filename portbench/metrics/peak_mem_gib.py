"""Device memory: ``torch.cuda.max_memory_allocated()`` after the window, in GiB."""


def read(rec, metric):
    return rec.peak_mem_bytes / 2 ** 30 if rec.peak_mem_bytes else None
