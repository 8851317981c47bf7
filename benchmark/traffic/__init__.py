"""Traffic drivers: one module per kind of traffic, each a class `Driver`
that a cell's file names, constructed as `Driver(cell, ckpt_dir, seed,
device)`:

- `setup()` builds the port's objects (engine or transcriber);
- `warm()` runs every shape the cell's traffic meets, outside the window;
- `run(seconds, tracer)` drives the window, calling `tracer.before(i)` and
  `tracer.after(i)` around its unit i of work (a call, a feed) where a
  tracer is given, and returns the summary: `attempted`, `failed`,
  `window_s`, `end_to_end` (metric -> value) and what the cell's per-layer
  readers read;
- `works(units=None)` gives the roofline pieces of the window's work, or of
  the units `units`;
- `jobs(rng)` gives the sample the reference checks (`reference/prompts.py`);
- `reset(seed)` forgets the window's records (control runs);
- `close()` frees the port's state before the reference runs.
"""
