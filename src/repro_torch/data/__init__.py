"""The training path's data pipeline."""
