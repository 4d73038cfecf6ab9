"""The 95th percentile, over every ticket resolved in the window, of its
latency from submission to resolution (host clock; linear interpolation
between order statistics)."""
import numpy as np


def read(rec):
    lat = rec.get("latencies")
    return float(np.percentile(lat, 95)) if lat is not None and len(lat) else None
