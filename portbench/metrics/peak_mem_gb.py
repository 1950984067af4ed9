"""``torch.cuda.max_memory_allocated()`` over the window (reset after the
warm-up), in GB of 1e9 bytes: weights, activations and what PASTA keeps
on the card."""


def read(run):
    return run.peak_window_bytes / 1e9 if run.peak_window_bytes else None
