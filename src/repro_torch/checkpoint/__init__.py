"""Checkpoints of the training path."""
