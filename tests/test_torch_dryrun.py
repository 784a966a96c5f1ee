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

PRODUCTION holds one cell for each fault the production meshes showed, on
the (16, 16) and (2, 16, 16) fake groups, in a second subprocess (python
<this file> --prog production): GQA heads that do not divide the 16-wide
model axis in the head projections (qwen3-32b train_4k, whisper-large-v3
prefill_32k), a microbatch of 16 rows on the 32-wide (pod x data) axis
(nemotron-4-340b train_4k), the Mamba2 recurrence over a state whose heads
do not divide that axis (zamba2-7b long_500k, in full) and a hybrid
shallower than one group (zamba2-7b prefill_32k at 2 layers). Each is ok,
counts bytes and FLOPs > 0 and has a dominant term. Two DeepSeek-V2-Lite
records of the first prog are pinned to the values they had before these
repairs.
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


# (arch, shape, multi_pod, layers): the production meshes' faults
PRODUCTION = [("qwen3-32b", "train_4k", False, 2),
              ("whisper-large-v3", "prefill_32k", False, 2),
              ("nemotron-4-340b", "train_4k", True, 2),
              ("zamba2-7b", "long_500k", True, 0),
              ("zamba2-7b", "prefill_32k", False, 2)]


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


def _prog_production():
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    for arch, shape, multi_pod, layers in PRODUCTION:
        with D.fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            step, meta = D.build_step(arch, shape, mesh, n_layers=layers)
            rec = D.analyse(step, mesh, meta)
            rec["roofline"] = D.roofline_terms(rec)
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


COMM_DEBUG_KINDS = {"shard_dim_alltoall": "all_to_all_single"}


@pytest.mark.parametrize("i", range(len(CELLS)),
                         ids=[f"{a}-{s}-{m}" for a, s, m, _, _ in CELLS])
def test_collectives_are_comm_debug_modes(records, i):
    """The step-cost mode's collective counts (a microbatch's, times
    n_micro for a train step) are CommDebugMode's over one microbatch.
    CommDebugMode names DTensor's Shard(i) -> Shard(j) collective by its
    op (shard_dim_alltoall), step_costs by the all-to-all it issues on the
    card."""
    rec = records[i]
    n = rec.get("n_micro", 1)
    micro = {k: v for k, v in rec["collectives"]["counts"].items()
             if k != "all_reduce" or rec["kind"] != "train"}
    comm = {COMM_DEBUG_KINDS.get(k, k): v * n
            for k, v in rec["comm_debug"].items()
            if k != "all_reduce" or rec["kind"] != "train"}
    assert micro == comm
    if rec["kind"] == "train":        # the update's all-reduces come once
        assert rec["collectives"]["counts"]["all_reduce"] >= \
            rec["comm_debug"]["all_reduce"] * n


def test_the_pod_axis_lowers_per_device_flops(records):
    one, two = records[2], records[3]
    assert two["mesh"] == {"pod": 2, "data": 2, "model": 2}
    assert two["flops"] < one["flops"]


# The DeepSeek-V2-Lite prefill record of the first prog as it was before
# the repairs of the sharded path (uneven heads, the short microbatch, the
# SSM decode, the zero-group hybrid), which its MLA (heads that divide)
# does not take. The same under torch 2.13 and 2.11 (a train record's
# FLOPs and collectives differ between the two). Since the dry run's mesh
# takes the cards' device type, one of its all-gathers is the all-to-all
# the cards issue for the same redistribute (chip_smoke.py 5e (f5)): 65 536
# fewer traffic bytes and 32 768 fewer wire bytes.
PINNED = {
    1: {"argument_bytes": 445459456, "peak_temp_bytes": 1672165851140,
        "flops": 691046413500416.0, "traffic_bytes": 14073302502350.0,
        "counts": {"all_gather_into_tensor": 33.0, "all_reduce": 4.0,
                   "all_to_all_single": 1.0, "reduce_scatter_tensor": 3.0},
        "wire_bytes": 12918183944.0},
}


@pytest.mark.parametrize("i", sorted(PINNED))
def test_deepseek_records_are_unchanged(records, i):
    rec, want = records[i], PINNED[i]
    got = {"argument_bytes": rec["memory"]["argument_bytes"],
           "peak_temp_bytes": rec["memory"]["peak_temp_bytes"],
           "flops": rec["flops"], "traffic_bytes": rec["traffic_bytes"],
           "counts": rec["collectives"]["counts"],
           "wire_bytes": rec["collectives"]["wire_bytes"]}
    assert got == want


@pytest.fixture(scope="module")
def production():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, __file__, "--prog", "production"],
                         capture_output=True, text=True, timeout=240,
                         env=env)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    recs = [json.loads(line[5:]) for line in res.stdout.splitlines()
            if line.startswith("CELL ")]
    assert len(recs) == len(PRODUCTION)
    return recs


@pytest.mark.parametrize("i", range(len(PRODUCTION)), ids=[
    f"{a}-{s}-{'2x16x16' if mp else '16x16'}-L{n or 'full'}"
    for a, s, mp, n in PRODUCTION])
def test_production_mesh_cell(production, i):
    rec = production[i]
    arch, shape, multi_pod, layers = PRODUCTION[i]
    assert rec["shape"] == shape and rec["depth_cut"] == bool(layers)
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["run_mesh"] == ({"data": 32, "model": 16} if multi_pod
                               else {"data": 16, "model": 16})
    assert rec["flops"] > 0 and rec["traffic_bytes"] > 0
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["peak_temp_bytes"] > 0
    assert isinstance(mem["fits"], bool)
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")


def test_the_zero_group_hybrid_cell_runs_no_group(production):
    rec = production[-1]
    assert rec["arch"] == "zamba2_7b" and rec["n_layers"] == 2
    # zamba2-7b's groups are of 6 layers: 2 layers run none of them
    from repro_torch.configs import get_config
    assert get_config("zamba2-7b").hybrid_group > rec["n_layers"]


if __name__ == "__main__" and "--prog" in sys.argv:
    if sys.argv[-1] == "production":
        _prog_production()
    else:
        _prog()
