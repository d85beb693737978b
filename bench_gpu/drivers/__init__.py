"""Drivers: one module a kind of traffic, named by a traffic file's
``driver``. ``run(cell, seed, seconds, device, tracer, t0, hooks)`` sets
the program up from the seed, runs the measured window, checks the
window's outputs against the plain reference and returns an ``Outcome``
(``harness/setup.py``)."""
