"""Queries answered in the window over the window's seconds (host clock):
a ticket counts when it resolves, a ``solve`` call's columns when it
returns; a query that did not converge is not an answer."""


def read(rec):
    return rec["completed"] / rec["window_s"] if rec["window_s"] > 0 else None
