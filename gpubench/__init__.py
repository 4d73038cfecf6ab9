"""The benchmark of ``repro_torch`` on one card: see README.md."""
