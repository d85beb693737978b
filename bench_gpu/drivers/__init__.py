"""Drivers: one module a kind of traffic, named by a traffic file's
``driver`` and loaded by path from the cell's root
(``harness/manifest.py``). ``run(cell, seed, seconds, device, tracer, t0,
hooks)`` sets the program up from the seed, runs the measured window,
checks the window's outputs against the plain reference and returns an
``Outcome`` (``harness/setup.py``); ``TINY`` holds the overrides that cut
the driver's cells to a size a CPU test runs in seconds."""
