"""Checkpoints with an asynchronous write, in the reference's on-disk format
(repro.checkpoint.manager): each snapshot is a directory step_XXXXXXXX/,
written as step_XXXXXXXX.tmp/ and then renamed, holding leaves.npz (every
leaf as a flat array of its raw bytes, uint8, key leaf_<i>) and
manifest.json (the step, the leaf count, the shapes and the dtype names).
Either package restores what the other wrote, bit for bit.

A tree is a tensor, a mapping (leaves in sorted-key order, as jax.tree
flattens a dict), a list or tuple (in order) or a module (its parameters()
in order). bf16 and every other dtype go through a uint8 view of their
bytes one way and a view back the other, with no numpy dtype for bf16.

Sharded state: a DTensor leaf is saved whole (full_tensor, a gather that
every rank of the process group joins), and in a process group rank 0
alone writes; a blocking save and wait() end at a barrier, so every rank
may read the snapshot after. restore(..., shardings=...) places each leaf
on a mesh (a DTensor with the given placements), which need not be the
mesh it was saved from: the elastic restore onto another topology.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

_DTYPE_NAMES = {torch.float64: "float64", torch.float32: "float32",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


def _flatten(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _flatten(item)]
    raise TypeError(f"checkpoint: cannot flatten a {type(tree).__name__}")


def _whole(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _place(tree, shardings, leaves: list):
    """tree with its leaves taken in order from `leaves` (a new tree; a
    module's parameters are replaced in place and the module returned)."""
    if isinstance(tree, torch.Tensor):
        return leaves.pop(0)
    if isinstance(tree, nn.Module):
        for path, p in list(tree.named_parameters()):
            owner, _, name = path.rpartition(".")
            setattr(tree.get_submodule(owner), name, nn.Parameter(
                leaves.pop(0), requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, Mapping):
        return {k: _place(tree[k], shardings[k], leaves)
                for k in sorted(tree)}
    return type(tree)(_place(t, s, leaves) for t, s in zip(tree, shardings))


def _flat_shardings(tree, shardings) -> list:
    """shardings, a tree of tree's structure (a module's: {parameter path:
    sharding}, as param_shardings gives it), in _flatten's leaf order."""
    if isinstance(tree, torch.Tensor):
        return [shardings]
    if isinstance(tree, nn.Module):
        return [shardings[k] for k, _ in tree.named_parameters()]
    if isinstance(tree, Mapping):
        return [s for k in sorted(tree)
                for s in _flat_shardings(tree[k], shardings[k])]
    return [s for t, sh in zip(tree, shardings)
            for s in _flat_shardings(t, sh)]


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, blocking: bool = False):
        """Snapshot a tree. The device-to-host copy (of a DTensor, its whole
        value) happens here, before returning (so the caller may overwrite
        the tensors); the write runs on a thread unless blocking."""
        self.wait()
        host = [_whole(t).detach().to("cpu", copy=True)
                for t in _flatten(tree)]
        if _in_group() and dist.get_rank() != 0:
            if blocking:
                dist.barrier()
            return

        def write():
            tmp = self.dir / f"step_{step:08d}.tmp"
            tmp.mkdir(parents=True, exist_ok=True)
            np.savez(tmp / "leaves.npz",
                     **{f"leaf_{i}": h.reshape(-1).view(torch.uint8).numpy()
                        for i, h in enumerate(host)})
            manifest = {
                "step": step,
                "n_leaves": len(host),
                "shapes": [list(h.shape) for h in host],
                "dtypes": [_DTYPE_NAMES[h.dtype] for h in host],
                "time": time.time(),
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._gc()

        if blocking:
            write()
            if _in_group():
                dist.barrier()
            return

        def run():
            try:
                write()
            except BaseException as e:         # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the pending write (in a process group, every rank's: a
        barrier); raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _in_group():
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        snaps = self.all_steps()
        for s in snaps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self):
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob(
            "step_*") if not p.name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @torch.no_grad()
    def restore(self, step: int, target_tree, shardings=None):
        """Copy the snapshot into target_tree's tensors, in place (each
        keeps its dtype and device; a DTensor its placements), and return
        target_tree. With shardings (a tree of target_tree's structure of
        distributed.sharding.NamedSharding; a module's as param_shardings
        gives it) each leaf becomes a DTensor on its sharding's mesh and
        placements instead, in a new tree (a module's parameters replaced
        in place)."""
        from torch.distributed.tensor import DTensor, distribute_tensor
        path = self.dir / f"step_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())
        leaves = _flatten(target_tree)
        placed = ([None] * len(leaves) if shardings is None
                  else _flat_shardings(target_tree, shardings))
        with np.load(path / "leaves.npz") as data:
            if len(leaves) != len(data.files):
                raise ValueError(f"leaf count mismatch: {len(leaves)} vs "
                                 f"{len(data.files)}")
            for i, ref in enumerate(leaves):
                arr = torch.from_numpy(data[f"leaf_{i}"]).view(
                    _DTYPES[manifest["dtypes"][i]]).reshape(
                        manifest["shapes"][i])
                if arr.shape != ref.shape:
                    raise ValueError(f"leaf {i}: {tuple(arr.shape)} vs "
                                     f"{tuple(ref.shape)}")
                sh = placed[i]
                if sh is not None:
                    local = ref.to_local() if isinstance(ref, DTensor) \
                        else ref
                    placed[i] = distribute_tensor(
                        arr.to(local.device, local.dtype), sh.mesh,
                        sh.placements)
                elif isinstance(ref, DTensor):
                    ref.copy_(distribute_tensor(
                        arr.to(ref.to_local().device, ref.dtype),
                        ref.device_mesh, ref.placements))
                else:
                    ref.copy_(arr)
        if shardings is None:
            return target_tree
        return _place(target_tree, shardings, placed)
