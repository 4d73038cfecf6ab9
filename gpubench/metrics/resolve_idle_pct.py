"""Share of the profiled sub-window in which the device sat idle while the
host resolved tickets: the program's ``resolve`` spans (the column read
out, put back in id order, the tuner, the cache put), in %. A part of
``device_idle_pct``."""
from gpubench.spans import idle_pct


def read(rec):
    return idle_pct(rec, ("resolve",))
