"""The engine's rounds in the profiled sub-window, each counted as one pass
over every edge and state row at the cell's width (`gpubench.roofline`),
at the card's least time for a pass, over the device's busy time there
(every device operation, so a renamed or replaced kernel still counts)."""
from gpubench.roofline import pass_bound_s, peaks_for


def read(rec):
    p = rec.get("profile")
    if p is None or p["busy_s"] <= 0 or not rec.get("profile_rounds"):
        return None
    import torch

    peaks = peaks_for(torch.cuda.get_device_name())
    bound = rec["profile_rounds"] * pass_bound_s(rec["m"], rec["n"], rec["d"], peaks)
    return 100.0 * bound / p["busy_s"]
