"""``peak_mem_mb``: peak device memory allocated during the window beyond
what was allocated at its start (the input pool), in 1e6 bytes."""


def read(rec):
    b = rec.get("peak_window_bytes")
    return None if b is None else b / 1e6
