"""The program's device memory peak over set-up and window:
``torch.cuda.max_memory_allocated`` (the caching allocator's count of
live tensor bytes), reset when the benchmark's own inputs are made and
read when the window closes, before the reference runs."""
KIND, UNIT, SOURCE, BETTER = "end_to_end", "GiB", "device_trace", "lower"


def read(r):
    b = r.timing.peak_bytes
    return b / 2 ** 30 if b > 0 else None
