"""Share of the profiled sub-window in which the device sat idle while a
``solve`` call prepared its operands: the program's ``relabel`` (the order
applied to edges and vectors), ``pack``, ``pack_tiles`` (the flat-BSR
tiles built and staged) and ``pack_operands`` spans, in %. A part of
``device_idle_pct``."""
from gpubench.spans import idle_pct


def read(rec):
    return idle_pct(rec, ("relabel", "pack", "pack_tiles", "pack_operands"))
