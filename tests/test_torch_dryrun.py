"""The port's dry-run machinery (launch/dryrun.py, distributed/
step_costs.py) on fake process groups, the counterpart of
tests/progs/dist_dryrun_prog.py: build_step -> analyse -> roofline_terms
for the train, prefill and decode kinds on a (2, 2) ("data", "model")
mesh and a (2, 2, 2) ("pod", "data", "model") one, each cell's step run on
meta tensors. Every cell counts FLOPs and bytes > 0 and has a dominant
term; the pod axis lowers the per-device FLOPs of the same global problem;
the collectives counted by the step-cost mode are CommDebugMode's.

The cells run at the full widths with the depth cut (to 2 layers; the
Mamba2 decode in full): the machinery, not the depth, is under test, and
each layer adds the same ops. It runs in a subprocess (a process has one
default process group) with a timeout: python <this file> --prog.
"""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

# (arch, shape, mesh, kind, layers)
CELLS = [("mamba2-370m", "decode_32k", "2x2", "decode", 0),
         ("deepseek-v2-lite", "prefill_32k", "2x2", "prefill", 2),
         ("deepseek-v2-lite", "train_4k", "2x2", "train", 2),
         ("deepseek-v2-lite", "train_4k", "2x2x2", "train", 2)]


def _prog():
    import math

    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh
    for arch, shape, mesh_s, kind, layers in CELLS:
        dims = tuple(int(x) for x in mesh_s.split("x"))
        names = ("data", "model") if len(dims) == 2 else ("pod", "data",
                                                          "model")
        with D.fake_group(math.prod(dims)):
            mesh = make_mesh(dims, names)
            step, meta = D.build_step(arch, shape, mesh, n_layers=layers)
            rec = D.analyse(step, mesh, meta)
            rec["roofline"] = D.roofline_terms(rec)
            comm = CommDebugMode()
            with comm:
                step.micro()
            rec["comm_debug"] = {str(k).rpartition(".")[2]: v for k, v in
                                 comm.get_comm_counts().items() if v}
        print("CELL " + json.dumps(rec, default=str), flush=True)


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, __file__, "--prog"],
                         capture_output=True, text=True, timeout=240,
                         env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    recs = [json.loads(line[5:]) for line in res.stdout.splitlines()
            if line.startswith("CELL ")]
    assert len(recs) == len(CELLS)
    return recs


@pytest.mark.parametrize("i", range(len(CELLS)),
                         ids=[f"{a}-{s}-{m}" for a, s, m, _, _ in CELLS])
def test_cell_counts_and_roofline(records, i):
    rec = records[i]
    arch, shape, mesh, kind, layers = CELLS[i]
    assert rec["kind"] == kind and rec["depth_cut"] == bool(layers)
    assert rec["flops"] > 0 and rec["traffic_bytes"] > 0
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["peak_temp_bytes"] > 0
    assert mem["hbm_bytes"] == 80 * 2**30
    terms = rec["roofline"]
    assert terms["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert terms["rates"] == {"peak_bf16_flops": 989e12,
                              "hbm_Bps": 3.35e12,
                              "collective_fabric": "h100_nvlink4",
                              "collective_Bps": 125e9}
    assert rec["ops"].startswith("PLAIN")


@pytest.mark.parametrize("i", range(len(CELLS)),
                         ids=[f"{a}-{s}-{m}" for a, s, m, _, _ in CELLS])
def test_collectives_are_comm_debug_modes(records, i):
    """The step-cost mode's collective counts (a microbatch's, times
    n_micro for a train step) are CommDebugMode's over one microbatch."""
    rec = records[i]
    n = rec.get("n_micro", 1)
    micro = {k: v for k, v in rec["collectives"]["counts"].items()
             if k != "all_reduce" or rec["kind"] != "train"}
    comm = {k: v * n for k, v in rec["comm_debug"].items()
            if k != "all_reduce" or rec["kind"] != "train"}
    assert micro == comm
    if rec["kind"] == "train":        # the update's all-reduces come once
        assert rec["collectives"]["counts"]["all_reduce"] >= \
            rec["comm_debug"]["all_reduce"] * n


def test_the_pod_axis_lowers_per_device_flops(records):
    one, two = records[2], records[3]
    assert two["mesh"] == {"pod": 2, "data": 2, "model": 2}
    assert two["flops"] < one["flops"]


if __name__ == "__main__" and "--prog" in sys.argv:
    _prog()
