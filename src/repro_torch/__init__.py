"""repro_torch — the serving system of `repro` in PyTorch, for one NVIDIA H100.

The layout mirrors the JAX package module for module (core/, models/,
kernels/<name>/, serving/, serving/backends/, obs/, launch/, configs/), so
each module's counterpart sits at the same path. The control plane (planner,
timeline, chunk store, cost model, flight recorder) is a verbatim copy of
the JAX-free modules; the array work runs in PyTorch, and every kernel on
the serving decode path and the model's prefill is CUDA C++ written for
sm_90a (kernels/csrc/*.cu), with its plain PyTorch version beside it.

This package imports torch and numpy only — never jax.
"""
