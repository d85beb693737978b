"""Audio I/O."""
