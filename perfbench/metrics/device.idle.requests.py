"""The card's idle share over a request cell's traced window: one less
the union of the device operations' intervals (torch.profiler) over
the window's length."""


def read(run):
    return run.idle_share("requests")
