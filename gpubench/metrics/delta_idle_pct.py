"""Share of the profiled sub-window in which the device sat idle while the
host applied a graph delta: the program's ``delta_apply`` span and the
spans that open inside it in a serve mix, ``delta_graph`` (the graph,
cache and order moved), ``family_rebuild``, the new session's
``relabel``, ``pack``, ``pack_tiles`` and ``pack_operands``, and ``carry``
(one in-flight column re-made, re-installed and carried warm), in %. In a
serve mix the order and the packing open only at set-up and inside a
rebuild. A part of ``device_idle_pct``; None where the trace names none
of the program's spans, or none of these (a program without the delta
path's own spans)."""
from gpubench.spans import PREFIX, idle_pct

NAMES = ("delta_apply", "delta_graph", "family_rebuild", "carry",
         "relabel", "pack", "pack_tiles", "pack_operands")
# the spans only a program with the delta path's own spans opens
OWN = ("delta_graph", "family_rebuild", "carry")


def read(rec):
    p = rec.get("profile")
    if p is None or not any(name == PREFIX + n for name, _ in p["idle_gaps"] for n in OWN):
        return None
    return idle_pct(rec, NAMES)
