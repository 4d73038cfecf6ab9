"""``query_p95_s`` read as a per-layer metric, for a cell whose device is
idle more than half of the traced window: there the host paces the tail."""
from gpubench.harness import load_module

read = load_module("metrics", "query_p95_s").read
