"""Operation and byte counts as functions of shape, and the card's peaks.

``k1``, ``k2``, ``k3``: one launch of each kernel of the program's main
paths; ``<config>``: one forward of that configuration's model. Inputs
are counted as read once and outputs as written once.
"""
