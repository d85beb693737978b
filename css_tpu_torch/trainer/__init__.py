"""Checkpoint reading (saving waits for the trainer slice)."""
