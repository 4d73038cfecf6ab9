"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GB
(1e9 bytes); nothing on a run without a card."""


def read(rec):
    return rec["peak_bytes"] / 1e9 if rec["peak_bytes"] > 0 else None
