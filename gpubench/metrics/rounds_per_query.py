"""Mean engine rounds a query consumed: ``Ticket.rounds`` of the tickets
resolved in the window, or ``RunResult.col_rounds`` of the columns that
``solve`` returned in it."""


def read(rec):
    r = rec.get("rounds")
    return float(r.mean()) if r is not None and len(r) else None
