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
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import (ALIASES, SHAPES, all_cells, get_config)
from repro_torch.core.constants import FABRICS
from repro_torch.distributed import policy as POL
from repro_torch.distributed import step_costs
from repro_torch.distributed.sharding import (distribute, param_shardings,
                                              shard_params)
from repro_torch.launch import input_specs as IS
from repro_torch.launch.mesh import flatten_dp, make_production_mesh
from repro_torch.models import model as MD
from repro_torch.models.module import trainable
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.step import (TrainConfig, _pinner, accumulate,
                                    loss_and_grads)

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun_torch"

# One NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): bf16
# tensor-core FLOP/s, HBM bytes/s and bytes. Collectives are priced at the
# link peak of the h100_nvlink4 fabric row (core/constants.py).
H100_PEAK_BF16 = 989e12
H100_HBM_BW = 3.35e12
H100_HBM_BYTES = 80 * 2**30
COLLECTIVE_FABRIC = "h100_nvlink4"

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
               no_remat: bool = False, n_layers: int = 0):
    """Build one cell's step on mesh (on the fake group the mesh lives on),
    its tensors on the meta device. Returns (DryStep, meta). A (pod, data,
    model) mesh runs as its (pod x data, model) view (mesh.flatten_dp).

    n_micro overrides the grad-accumulation depth; no_expert_fsdp shards
    expert stacks over `model` only (no per-microbatch all-gather of
    experts over `data`); no_remat drops the recompute of each block in
    backward; n_layers > 0 cuts the depth to n_layers (the widths stay),
    and the record says so."""
    cfg = _arch_cfg(arch, shape_name)
    if no_remat:
        cfg = dataclasses.replace(cfg, remat=False)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = SHAPES[shape_name]
    no_fsdp = ("expert",) if no_expert_fsdp else ()
    run_mesh = flatten_dp(mesh)
    params = MD.init_model(cfg, device="meta")
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
        mb_shape = dataclasses.replace(shape,
                                       global_batch=shape.global_batch // n)
        specs = IS.train_batch_specs(cfg, mb_shape)
        batch = _place(specs, IS.train_batch_shardings(specs, run_mesh))
        leaves = list(params.parameters())
        if n == 1:
            grads = []

            def micro():
                grads[:] = loss_and_grads(params, cfg, batch, tcfg,
                                          p_shard)[1]
        else:
            grads = _pinner(params, p_shard)(
                [torch.zeros_like(p, dtype=tcfg.accum_dtype)
                 for p in leaves])

            def micro():
                accumulate(params, cfg, batch, grads, tcfg, p_shard)

        def update():
            adamw_update(params, grads, opt_state, ocfg)

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
    n_fail = 0
    for a, s in cells:
        for mp in meshes:
            rec = run_cell(a, s, mp, pathlib.Path(args.out),
                           force=args.force, sp_residual=not args.no_sp,
                           tag=args.tag, n_micro=args.n_micro,
                           no_expert_fsdp=args.no_expert_fsdp,
                           no_remat=args.no_remat, n_layers=args.layers)
            n_fail += 0 if rec.get("ok") else 1
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
