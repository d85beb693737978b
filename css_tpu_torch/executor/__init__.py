"""Chunked continuous-separation executor: separator, stitcher, beamformer."""
