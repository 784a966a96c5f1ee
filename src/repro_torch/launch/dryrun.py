"""Production-mesh dry run, the counterpart of repro.launch.dryrun: for an
(arch x shape x mesh) cell, the full config's step (train, prefill or
decode) is built on the production mesh, (16, 16) ("data", "model") or
(2, 16, 16) ("pod", "data", "model"), and run once on meta tensors over a
fake process group of the mesh's size: every parameter, optimizer state
and input a DTensor on its placements (distributed.sharding), the
activations under the sequence-parallel policy (distributed.policy),
nothing allocated and nothing computed. It records per device: the bytes
of its shards of the arguments (parameters, optimizer state, inputs), the
peak temporary bytes (MemTracker, its meta-device peak), the step's costs
(distributed.step_costs: FLOPs, traffic bytes, collectives by kind, wire
bytes) and the three roofline terms on an H100.

The meta device stands where the reference has jax.eval_shape: under
FakeTensorMode DTensor's own host bookkeeping (the index arithmetic of a
strided shard) would turn fake and stop. Meta tensors cannot enter a
ctypes kernel either, so the dry run computes with the model's PLAIN ops
(models/model.py), and says so in its record.

Usage:
    python -m repro_torch.launch.dryrun --arch deepseek-v2-236b \\
        --shape train_4k
    # every cell on both meshes (66), each in a subprocess of its own with
    # a timeout, 3 at a time, then the records as a table, a row a cell
    # (without --force: the records already under --out, as a table)
    python -m repro_torch.launch.dryrun --all --both-meshes [--force]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import (ALIASES, SHAPES, ShapeSpec, all_cells,
                                 get_config)
from repro_torch.core.constants import FABRICS
from repro_torch.distributed import policy as POL
from repro_torch.distributed import step_costs
from repro_torch.distributed.sharding import (distribute, param_shardings,
                                              shard_params)
from repro_torch.launch import input_specs as IS
from repro_torch.launch.mesh import flatten_dp, make_production_mesh
from repro_torch.models import model as MD
from repro_torch.models.module import trainable
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     decay_mask)
from repro_torch.train.step import (TrainConfig, _microbatches, _pinner,
                                    accumulate, loss_and_grads)

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun_torch"

# One NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): bf16
# tensor-core FLOP/s, HBM bytes/s and bytes. Collectives are priced at the
# link peak of the h100_nvlink4 fabric row (core/constants.py).
H100_PEAK_BF16 = 989e12
H100_HBM_BW = 3.35e12
H100_HBM_BYTES = 80 * 2**30
COLLECTIVE_FABRIC = "h100_nvlink4"

# main, for more than one cell: each in a subprocess of its own (one fake
# group each), this many at once, each within this many seconds
CELL_JOBS = 3
CELL_TIMEOUT_S = 1500

# per-arch grad-accumulation microbatches for train_4k (the reference's)
N_MICRO = {
    "nemotron_4_340b": 16,
    "deepseek_v2_236b": 4,
    "qwen3_moe_235b": 4,
    "qwen1_5_32b": 2,
    "qwen2_5_32b": 2,
    "qwen3_32b": 2,
}

OPT = AdamWConfig()
OPT_BF16 = dataclasses.replace(OPT, state_dtype=torch.bfloat16)


def _arch_cfg(arch: str, shape_name: str) -> MD.ModelConfig:
    cfg = get_config(arch)
    if shape_name == "long_500k" and cfg.attn_type == "mla":
        # DSA-style selection at the V3.2/GLM-5.1 budget (paper §5.4)
        cfg = dataclasses.replace(cfg, selection_k=2048)
    return cfg


def _opt_cfg(arch: str) -> AdamWConfig:
    # bf16 optimizer states for the 340B config (memory posture)
    return OPT_BF16 if ALIASES.get(arch, arch) == "nemotron_4_340b" else OPT


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of world_size ranks, this process rank 0: every
    collective returns at once, with its result's shape and dtype."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class DryStep:
    """One cell's step, split as step_costs.measure takes it: micro (one
    microbatch's forward and backward into the accumulators, or the whole
    prefill / decode step), n_micro of them a step, then update (AdamW,
    train only). args: every argument tensor (their local shards are the
    per-device argument bytes); carried: the gradient accumulators, which
    live through the step but are made before it (temporary bytes)."""
    micro: object
    n_micro: int
    update: object
    args: list
    carried: list = dataclasses.field(default_factory=list)


def _local_bytes(tensors) -> int:
    from torch.distributed.tensor import DTensor
    return int(sum((t.to_local() if isinstance(t, DTensor) else t).numel()
                   * t.element_size() for t in tensors))


def _place(specs, shardings):
    """Zero meta tensors of the stand-ins' shapes and dtypes, on their
    shardings."""
    return _zip_map(lambda s, sh: distribute(
        torch.zeros(s.shape, dtype=s.dtype, device="meta"), sh.mesh,
        sh.spec), specs, shardings)


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(_zip_map(fn, x, y) for x, y in zip(a, b))
    return None if a is None else fn(a, b)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def build_step(arch: str, shape_name: str, mesh, sp_residual: bool = True,
               n_micro: int = 0, no_expert_fsdp: bool = False,
               no_remat: bool = False, n_layers: int = 0, *,
               cfg: Optional[MD.ModelConfig] = None,
               shape: Optional[ShapeSpec] = None,
               dtype: torch.dtype = torch.bfloat16):
    """Build one cell's step on mesh (on the fake group the mesh lives on),
    its tensors on the meta device. Returns (DryStep, meta). A (pod, data,
    model) mesh runs as its (pod x data, model) view (mesh.flatten_dp).

    n_micro overrides the grad-accumulation depth; no_expert_fsdp shards
    expert stacks over `model` only (no per-microbatch all-gather of
    experts over `data`); no_remat drops the recompute of each block in
    backward; n_layers > 0 cuts the depth to n_layers (the widths stay),
    and the record says so. cfg and shape, where given, stand in for the
    arch's config and shape_name's shape, and dtype is the parameters'
    (the published bf16 unless set): a step that ran on cards, counted
    the same way (chip_smoke.py's 5e (f5))."""
    cfg = cfg or _arch_cfg(arch, shape_name)
    if no_remat:
        cfg = dataclasses.replace(cfg, remat=False)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = shape or SHAPES[shape_name]
    no_fsdp = ("expert",) if no_expert_fsdp else ()
    run_mesh = flatten_dp(mesh)
    params = MD.init_model(cfg, device="meta", dtype=dtype)
    p_shard = param_shardings(params, run_mesh, no_fsdp_with=no_fsdp)
    policy = POL.sp_policy(run_mesh, seq_shard=sp_residual)
    meta = {"arch": ALIASES.get(arch, arch), "shape": shape_name,
            "kind": shape.kind, "n_layers": cfg.n_layers,
            "run_mesh": dict(zip(run_mesh.mesh_dim_names, run_mesh.shape)),
            "depth_cut": bool(n_layers),
            "n_params": int(sum(p.numel() for p in params.parameters())),
            "ops": "PLAIN (the plain versions of the kernels: meta "
                   "tensors cannot enter a ctypes kernel)"}

    def run(fn):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        def go():
            with POL.use_policy(policy), implicit_replication():
                return fn()
        return go

    if shape.kind == "train":
        n = n_micro or N_MICRO.get(ALIASES.get(arch, arch), 1)
        tcfg = TrainConfig(n_micro=n)
        ocfg = _opt_cfg(arch)
        shard_params(trainable(params), p_shard)
        opt_state = adamw_init(params, ocfg)
        # the whole global batch on the data axes, as the reference places
        # it; microbatch 0 (each has its shapes and layouts) as the step
        # splits it
        specs = IS.train_batch_specs(cfg, shape)
        batch = _place(specs, IS.train_batch_shardings(specs, run_mesh))
        leaves = list(params.parameters())
        if n == 1:
            grads = []

            def micro():
                grads[:] = loss_and_grads(params, cfg, batch, tcfg,
                                          p_shard)[1]
        else:
            mb = _microbatches(batch, n)[0]
            grads = _pinner(params, p_shard)(
                [torch.zeros_like(p, dtype=tcfg.accum_dtype)
                 for p in leaves])

            def micro():
                accumulate(params, cfg, mb, grads, tcfg, p_shard)

        decay = decay_mask(params)

        def update():
            adamw_update(params, grads, opt_state, ocfg, decay=decay)

        meta["n_micro"] = n
        return DryStep(run(micro), n, run(update),
                       leaves + opt_state["m"] + opt_state["v"]
                       + _leaves(batch), grads if n > 1 else []), meta
    shard_params(params, p_shard)
    if shape.kind == "prefill":
        specs = IS.train_batch_specs(cfg, shape)
        batch = _place(specs, IS.train_batch_shardings(specs, run_mesh))

        def prefill():
            with torch.no_grad():
                MD.prefill(params, cfg, batch, ops=MD.PLAIN)
        return DryStep(run(prefill), 1, None,
                       list(params.parameters()) + _leaves(batch)), meta
    state = _place(IS.decode_state_specs(cfg, shape),
                   IS.decode_state_shardings(cfg, shape, run_mesh))
    token, pos, _ = _place(IS.decode_input_specs(cfg, shape),
                           IS.decode_input_shardings(run_mesh,
                                                     shape.global_batch))

    def decode():
        with torch.no_grad():
            MD.decode_step(params, cfg, state, token, pos, 0, ops=MD.PLAIN)
    return DryStep(run(decode), 1, None,
                   list(params.parameters()) + _leaves(state)
                   + [token, pos]), meta


def analyse(step: DryStep, mesh, meta) -> dict:
    """The cell's record: per-device argument and peak bytes, the step's
    costs. Call on the fake group the step was built on."""
    from torch.distributed._tools.mem_tracker import MemTracker
    out = dict(meta)
    out["n_devices"] = int(mesh.size())
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    arg_bytes = _local_bytes(step.args)
    tracker = MemTracker()
    costs = step_costs.measure(step.micro, step.n_micro, step.update,
                               around=lambda: tracker)
    # the step's own tensors are on the meta device; DTensor's bookkeeping
    # (host tensors, its shape inference's fake tensors) is not the step
    peak = tracker.get_tracker_snapshot("peak")[torch.device("meta")][
        "Total"] + _local_bytes(step.carried)
    out["memory"] = {"argument_bytes": arg_bytes,
                     "peak_temp_bytes": int(peak),
                     "device_bytes": int(arg_bytes + peak),
                     "hbm_bytes": H100_HBM_BYTES,
                     "fits": bool(arg_bytes + peak <= H100_HBM_BYTES)}
    out["flops"] = costs.flops
    out["traffic_bytes"] = costs.traffic_bytes
    out["collectives"] = {"counts": dict(costs.collective_counts),
                          "result_bytes": costs.collective_result_bytes,
                          "wire_bytes": costs.collective_wire_bytes}
    return out


def roofline_terms(rec: dict) -> dict:
    """The three roofline terms on one H100, seconds: per-device numbers
    over per-device rates."""
    fab = FABRICS[COLLECTIVE_FABRIC]
    flops, byts = rec.get("flops"), rec.get("traffic_bytes")
    wire = rec.get("collectives", {}).get("wire_bytes")
    terms = {"compute_s": flops / H100_PEAK_BF16 if flops else None,
             "memory_s": byts / H100_HBM_BW if byts else None,
             "collective_s": (wire / fab.link_peak_Bps
                              if wire is not None else None)}
    vals = {k: v for k, v in terms.items() if v}
    terms["dominant"] = max(vals, key=vals.get) if vals else None
    terms["rates"] = {"peak_bf16_flops": H100_PEAK_BF16,
                      "hbm_Bps": H100_HBM_BW,
                      "collective_fabric": COLLECTIVE_FABRIC,
                      "collective_Bps": fab.link_peak_Bps}
    return terms


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path = RESULTS_DIR, force: bool = False,
             sp_residual: bool = True, tag: str = "", n_micro: int = 0,
             no_expert_fsdp: bool = False, no_remat: bool = False,
             n_layers: int = 0) -> dict:
    """One cell on its production mesh over a fake group; writes and
    returns its record (the cached one unless force)."""
    mesh_tag = "pod2" if multi_pod else "pod1"
    cut = f"__L{n_layers}" if n_layers else ""
    name = f"{ALIASES.get(arch, arch)}__{shape_name}__{mesh_tag}{cut}{tag}"
    out_path = pathlib.Path(out_dir) / f"{name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    t0 = time.time()
    try:
        with fake_group(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            step, meta = build_step(arch, shape_name, mesh, sp_residual,
                                    n_micro, no_expert_fsdp, no_remat,
                                    n_layers)
            t_build = time.time() - t0
            rec = analyse(step, mesh, meta)
        rec["ok"] = True
        rec["t_build_s"] = round(t_build, 2)
        rec["t_analyse_s"] = round(time.time() - t0 - t_build, 2)
        rec["roofline"] = roofline_terms(rec)
    except Exception as e:                     # noqa: BLE001 — recorded
        rec = {"arch": ALIASES.get(arch, arch), "shape": shape_name,
               "mesh": mesh_tag, "ok": False, "error": str(e),
               "traceback": traceback.format_exc()[-4000:]}
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1, default=str))
    status = "OK" if rec.get("ok") else "FAIL"
    print(f"[dryrun] {name}: {status} ({time.time() - t0:.1f}s)", flush=True)
    return rec


def _cell_argv(a: str, s: str, mp: bool, args) -> list:
    """The command line that runs one cell of main's in a subprocess."""
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
            "--shape", s, "--out", args.out, "--tag", args.tag,
            "--n-micro", str(args.n_micro), "--layers", str(args.layers)]
    flags = {"--multi-pod": mp, "--force": args.force,
             "--no-sp": args.no_sp, "--no-expert-fsdp": args.no_expert_fsdp,
             "--no-remat": args.no_remat}
    return argv + [f for f, on in flags.items() if on]


def _run_in_subprocess(a: str, s: str, mp: bool, args) -> dict:
    """One cell in a process of its own within CELL_TIMEOUT_S; a cell that
    does not end in it is recorded as failed."""
    name = (f"{ALIASES.get(a, a)}__{s}__{'pod2' if mp else 'pod1'}"
            f"{f'__L{args.layers}' if args.layers else ''}{args.tag}")
    out_path = pathlib.Path(args.out) / f"{name}.json"
    try:
        res = subprocess.run(_cell_argv(a, s, mp, args), capture_output=True,
                             text=True, timeout=CELL_TIMEOUT_S)
        said = [ln for ln in res.stdout.splitlines()
                if ln.startswith(f"[dryrun] {name}:")]
        print(said[-1] if said else f"[dryrun] {name}: exit "
              f"{res.returncode}", flush=True)
    except subprocess.TimeoutExpired:
        rec = {"arch": ALIASES.get(a, a), "shape": s,
               "mesh": "pod2" if mp else "pod1", "ok": False,
               "error": f"no end within {CELL_TIMEOUT_S} s"}
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[dryrun] {name}: FAIL ({rec['error']})", flush=True)
    return json.loads(out_path.read_text()) if out_path.exists() else \
        {"ok": False}


def table(cells, meshes, out_dir) -> str:
    """The records of cells x meshes under out_dir as a markdown table, a
    row a cell, each column "16x16 / 2x16x16" where both meshes ran: ok,
    per device argument and peak temporary GiB, whether they fit in 80
    GiB, the dominant roofline term, build + analyse wall."""
    def cols(rec):
        if not rec.get("ok"):
            return ["no" if rec else "not run"] + [""] * 5
        mem = rec["memory"]
        return ["ok", f"{mem['argument_bytes'] / 2**30:.2f}",
                f"{mem['peak_temp_bytes'] / 2**30:.2f}",
                "yes" if mem["fits"] else "no",
                rec["roofline"]["dominant"].replace("_s", ""),
                f"{rec['t_build_s'] + rec['t_analyse_s']:.1f}"]

    head = ["arch", "shape", "ok", "argument GiB", "peak GiB", "fits",
            "dominant", "build + analyse s"]
    rows = ["| " + " | ".join(head) + " |", "|" + " --- |" * len(head)]
    for a, s in cells:
        per = []
        for mp in meshes:
            path = pathlib.Path(out_dir) / \
                f"{ALIASES.get(a, a)}__{s}__{'pod2' if mp else 'pod1'}.json"
            per.append(cols(json.loads(path.read_text())
                            if path.exists() else {}))
        rows.append(f"| {ALIASES.get(a, a)} | {s} | " + " | ".join(
            " / ".join(c) for c in zip(*per)) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-sp", action="store_true",
                    help="disable sequence-parallel residuals (baseline)")
    ap.add_argument("--n-micro", type=int, default=0,
                    help="override grad-accumulation microbatches")
    ap.add_argument("--no-expert-fsdp", action="store_true",
                    help="shard expert stacks over model only")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation remat")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)
    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    pairs = [(a, s, mp) for a, s in cells for mp in meshes]
    if len(pairs) == 1:
        recs = [run_cell(*pairs[0], pathlib.Path(args.out), force=args.force,
                         sp_residual=not args.no_sp, tag=args.tag,
                         n_micro=args.n_micro,
                         no_expert_fsdp=args.no_expert_fsdp,
                         no_remat=args.no_remat, n_layers=args.layers)]
    else:
        pathlib.Path(args.out).mkdir(parents=True, exist_ok=True)
        with concurrent.futures.ThreadPoolExecutor(CELL_JOBS) as pool:
            recs = list(pool.map(
                lambda c: _run_in_subprocess(*c, args), pairs))
        if not (args.layers or args.tag):
            print(table(cells, meshes, args.out), flush=True)
    n_fail = sum(0 if rec.get("ok") else 1 for rec in recs)
    print(f"[dryrun] {len(recs) - n_fail} of {len(recs)} cells ok",
          flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
