"""The JAX package's example drivers (examples/*.py at the repository root),
run by the port:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_routed
    PYTHONPATH=src python -m repro_torch.examples.agentic_fanout
    PYTHONPATH=src python -m repro_torch.examples.plan_execute
    PYTHONPATH=src python -m repro_torch.examples.train_mla_100m [--full]

Each keeps its original's scenario, sizes, printed quantities and asserts,
draws its arrays from explicit torch.Generators on --device (cuda by
default, where the kernels run; cpu takes their plain versions), and
exposes run(...) -> dict, the numbers it prints, beside main(argv).
"""

import argparse

import torch


def parser(prog: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=f"repro_torch.examples.{prog}")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the arrays live; cuda needs a card")
    return ap


def device_of(prog: str, name: str) -> torch.device:
    """--device as a torch.device; cuda without a card exits, naming the
    flag that runs on the CPU (there is no silent CPU run)."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"repro_torch.examples.{prog}: no CUDA device; "
                         f"pass --device cpu to run on the CPU")
    return torch.device(name)
