"""Atomic, async training checkpoints in the reference's format."""
