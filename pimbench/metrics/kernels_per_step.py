"""kernels_per_step.<kind>: device kernels a step of the program (the
benchmark's own launches left out), from the traced window.  The host
dispatches each one, so the count is the dispatch load; it repeats
exactly from run to run."""


def read(t, kind):
    if t.steps <= 0:
        return None
    n = sum(1 for e in t.program_events() if e.cat == "kernel")
    return n / t.steps if n else None
