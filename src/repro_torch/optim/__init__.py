"""Optimizers of the training path (AdamW)."""
