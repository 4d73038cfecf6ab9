"""Host seconds of ``gograph_order`` on the cell's graph at set-up."""


def read(rec):
    return rec.get("order_s")
