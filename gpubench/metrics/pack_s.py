"""Mean length of the program's ``pack`` spans (the graph packed into the
kernel's tiles, once a ``solve`` call) that began in the window, in s."""


def read(rec):
    spans = rec.get("pack_s")
    return sum(spans) / len(spans) if spans else None
