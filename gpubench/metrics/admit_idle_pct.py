"""Share of the profiled sub-window in which the device sat idle while the
host admitted tickets: the program's ``query_build`` (an algorithm instance
built over every edge), ``query_check`` (its edge arrays compared with the
family's), ``install`` and ``swap_in`` (the column to the device, its
depth-1 out-closure marked dirty) spans, in %. A part of
``device_idle_pct``."""
from gpubench.spans import idle_pct


def read(rec):
    return idle_pct(rec, ("query_build", "query_check", "install", "swap_in"))
