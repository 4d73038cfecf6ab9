"""Mean seconds of one ``GraphServer.apply_delta`` in a mix whose graph
changes (host clock, each apply closed by a device sync: the graph
mutated, each family re-packed and its in-flight columns carried over);
None where no delta was applied."""


def read(rec):
    spans = rec.get("delta_s")
    return sum(spans) / len(spans) if spans else None
