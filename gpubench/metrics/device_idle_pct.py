"""The device's idle share of the profiled sub-window: 1 - busy / window,
busy being the union of the device's operations in the profiler's trace."""


def read(rec):
    p = rec.get("profile")
    if p is None or p["busy_s"] <= 0 or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
