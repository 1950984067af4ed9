"""1 - the union of the device operations' intervals over the length of
the profiled sub-window, in percent."""


def read(run):
    p = run.profile
    if not p or not p["window_us"] or not p["device"]:
        return None
    return 100.0 * (1.0 - p["busy_us"] / p["window_us"])
