"""Operation and byte counts as functions of shape, and the card's peaks.

``k1``, ``k2``, ``k3``, ``kc``: one launch of each kernel of the program's
main paths, each file with ``NAME`` (the kernel's symbol in the device
trace), ``PROGRAM`` (its wrapper: a module under ``css_tpu_torch.ops`` and
the function whose ``launches`` count it; ``harness/setup.py``'s
``Launches`` reads every file that declares one), ``shape(config, geo)``
and ``bound_seconds``; ``<config>``: one forward of that configuration's
model. Inputs are counted as read once and outputs as written once.

``shape(config, geo)`` gives the shape of one launch on the separation
path (``bound_seconds``'s keywords), or None where the configuration
gives the kernel none. ``geo`` is the window's geometry as the separation
driver reads it off the program's separator: ``batch`` (windows a
separator batch), ``win`` and ``hop`` (samples), ``frames`` (model frames
a window), ``windows`` and ``batches`` (a session's), ``samples`` (a
session's), ``channels``, ``streams`` (speakers) and ``elem`` (bytes a
value of the configuration's dtype).
"""
