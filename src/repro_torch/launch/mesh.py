"""Production meshes, the counterpart of repro.launch.mesh. FUNCTIONS, not
module constants, so importing touches no process group.

Each builds a DeviceMesh with named dims on the process group that is up
(torch.distributed initialised by the caller; the dry run brings up a fake
group of the mesh's size): on the card for an NCCL group, on the host
otherwise.
"""

from __future__ import annotations

import torch.distributed as dist


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with multi_pod: the reference's shapes, so the specs compare."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape, axes):
    """Smaller meshes for tests and examples."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def flatten_dp(mesh):
    """The mesh a step runs on: a (pod, data, model) mesh as its (pod x
    data, model) view named ("data", "model"), on the same ranks in the
    same order (init_device_mesh lays ranks out row-major, pod major); any
    other mesh as it is. Every spec shards pod and data together (the fsdp
    rule, the batch, the caches), so each tensor's shards are the same on
    both, and a collective over (pod, data) is one collective over their
    ranks, as the reference's replica groups over (pod, data) are.
    DTensor would otherwise describe a dim sharded over two mesh dims and
    then flattened into a product as a strided shard, whose layout search
    does not end on three mesh dims."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" not in names:
        return mesh
    if names != ("pod", "data", "model"):
        raise ValueError(f"flatten_dp: mesh dims {names}")
    pod, data, model = mesh.shape
    return make_mesh((pod * data, model), ("data", "model"))

