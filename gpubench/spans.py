"""The device's idle time under the program's own spans.

While a `repro_torch.obs.trace.Tracer` is on, each of the program's spans
holds a profiler range named ``repro_torch.<span>``, so
`profiling.reduce_events` gives an idle instant of the device to the
innermost program span the host was in. A reader of such a share sums the
idle seconds under its span names over the profiled sub-window.
"""

PREFIX = "repro_torch."


def idle_pct(rec, names) -> float | None:
    """100 x the idle seconds under the spans ``names`` / the profiled
    window; None without a profile, or where the trace names no program
    span at all (tracing off, or the spans renamed): missing, not 0."""
    p = rec.get("profile")
    if p is None or p["window_s"] <= 0:
        return None
    gaps = {name: s for name, s in p["idle_gaps"]}
    if not any(name.startswith(PREFIX) for name in gaps):
        return None
    return 100.0 * sum(gaps.get(PREFIX + n, 0.0) for n in names) / p["window_s"]
