"""Per-layer metric readers: `<base>.py` reads the metric `<base>` or
`<base>.<kind>` from a traced window (`pimbench.trace.Traced`) with
`read(traced, kind)`, and returns None where it finds nothing to read."""
