"""Mean length of the program's ``batch`` spans (one bounded-round family
batch of `AsyncBlockSession.run_batch`, ending in its readout) that began
in the window, in ms."""


def read(rec):
    spans = rec.get("batch_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
