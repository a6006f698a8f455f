"""Traffic drivers: `setup(cell, seed, device)` builds and warms up one
cell and returns an object with `step(i)` (one step of the window, queued,
no host sync), `trace_steps`, `scene_build_s`, `end_to_end(window)` and
`check(control)` (the numbers compared, each (name, value, limit))."""
