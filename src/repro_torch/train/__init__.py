"""The train step and the fault-tolerant loop."""
