"""Sharding parity of the port's distribution substrate against the JAX
package, on the production meshes without devices (the reference's
AbstractMesh, the port's {axis: size} mapping):

* every parameter of every arch id carries the reference's logical axes,
  less the leading "layer" entries of a stack (full configs: the port's on
  the meta device, the reference's through jax.eval_shape, paired through
  convert.py's mapping);
* every parameter's spec equals the reference's spec_for, entry for entry
  (the reference's leading layer entries, never sharded, dropped), on
  (16, 16) and (2, 16, 16), with and without no_fsdp_with=("expert",);
* for each of the 33 dry-run cells: batch_sharding, cache_spec on every
  cache of the decode state, train_batch_shardings, decode_state_shardings
  and decode_input_shardings;
* sp_policy's specs and the placements a spec gives on a mesh;
* int8 quantize / dequantize, bit for bit on seeded inputs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as JC
from repro.distributed import policy as JPOL
from repro.distributed import sharding as JSH
from repro.launch import input_specs as JIS
from repro.models import model as JM
from repro.models.module import Param, is_param
from repro.optim import compress as JCOMP
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.distributed import policy as TPOL
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import input_specs as TIS
from repro_torch.models import model as TM
from repro_torch.models.module import param_axes
from repro_torch.optim import compress as TCOMP

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, names = MESHES[name]
    try:
        jm = AbstractMesh(shape, names)
    except TypeError:                    # older jax: ((name, size), ...)
        jm = AbstractMesh(tuple(zip(names, shape)))
    return jm, dict(zip(names, shape))


@functools.lru_cache(maxsize=None)
def _models(arch):
    ref = jax.eval_shape(functools.partial(JM.init_model, JC.get_config(arch)),
                         jax.random.PRNGKey(0))
    return ref, TM.init_model(TC.get_config(arch), device="meta")


class _Stacked:
    """A reference leaf seen through one layer of its stack: indexing drops
    the leading entry (which must be the layer axis, never sharded)."""

    def __init__(self, axes, spec=None):
        self.axes, self.spec = tuple(axes), spec

    def __getitem__(self, i):
        assert self.axes[0] == "layer", self.axes
        assert self.spec is None or self.spec[0] is None, self.spec
        return _Stacked(self.axes[1:],
                        None if self.spec is None else self.spec[1:])


def _pairs(arch, specs=None):
    """(port path, reference leaf through its layers) for every parameter;
    specs: the reference's param_shardings tree, carried beside the axes."""
    ref, port = _models(arch)
    if specs is None:
        tree = jax.tree.map(lambda p: _Stacked(p.axes), ref, is_leaf=is_param)
    else:
        tree = jax.tree.map(
            lambda p, s: _Stacked(p.axes, tuple(s.spec) + (None,) * (
                len(p.axes) - len(s.spec))), ref, specs, is_leaf=is_param)
    return [(path, leaf) for path, _, _, leaf in convert.pairs(port, tree)]


@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_logical_axes_equal_the_references(arch):
    _, port = _models(arch)
    got = param_axes(port)
    pairs = _pairs(arch)
    assert len(pairs) == len(got) == sum(1 for _ in port.parameters())
    for path, leaf in pairs:
        assert got[path] == leaf.axes, path


@pytest.mark.parametrize("no_fsdp", [(), ("expert",)], ids=["fsdp",
                                                           "no_expert_fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_param_specs_equal_the_references(arch, mesh, no_fsdp):
    jm, tm = _meshes(mesh)
    ref, port = _models(arch)
    want = JSH.param_shardings(ref, jm, no_fsdp_with=no_fsdp)
    got = TSH.param_shardings(port, tm, no_fsdp_with=no_fsdp)
    for path, leaf in _pairs(arch, want):
        spec = list(leaf.spec)
        while spec and spec[-1] is None:
            spec.pop()
        assert got[path].spec == tuple(spec), path
    # the optimizer state takes the parameters' specs, in parameters() order
    st = TSH.state_shardings(port, tm, no_fsdp_with=no_fsdp)
    assert [s.spec for s in st["m"]] == [got[k].spec for k, _ in
                                         port.named_parameters()]
    assert st["step"].spec == tuple(JSH.state_shardings(
        ref, jm)["step"].spec)


def _leaf_specs(tree):
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _leaf_specs(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [s for v in tree for s in _leaf_specs(v)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("cell", [f"{a}:{s}" for a, s in JC.all_cells()])
def test_cell_specs_equal_the_references(cell, mesh):
    arch, shape = cell.split(":")
    jm, tm = _meshes(mesh)
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    jshape, tshape = JC.SHAPES[shape], TC.SHAPES[shape]
    assert tuple(JSH.batch_sharding(jm).spec) == \
        TSH.batch_sharding(tm).spec
    jb = JIS.train_batch_specs(jcfg, jshape)
    tb = TIS.train_batch_specs(tcfg, tshape)
    assert {k: tuple(v.shape) for k, v in jb.items()} == \
        {k: tuple(v.shape) for k, v in tb.items()}
    assert {k: tuple(v.spec) for k, v in
            JIS.train_batch_shardings(jb, jm).items()} == \
        {k: v.spec for k, v in TIS.train_batch_shardings(tb, tm).items()}
    jst = JIS.decode_state_specs(jcfg, jshape)
    tst = TIS.decode_state_specs(tcfg, tshape)
    shapes = [tuple(x.shape) for x in jax.tree.leaves(jst)]
    assert shapes == [tuple(t.shape) for t in _leaf_specs(tst)]
    assert all(t.device.type == "meta" for t in _leaf_specs(tst))
    want = [tuple(x.spec) for x in jax.tree.leaves(
        JIS.decode_state_shardings(jcfg, jshape, jm))]
    assert want == [s.spec for s in _leaf_specs(
        TIS.decode_state_shardings(tcfg, tshape, tm))]
    for shp in shapes:
        if len(shp) >= 3:
            assert tuple(JSH.cache_spec(shp, jm)) == TSH.cache_spec(shp, tm)
    assert [tuple(x.shape) for x in JIS.decode_input_specs(jcfg, jshape)] \
        == [tuple(t.shape) for t in TIS.decode_input_specs(tcfg, tshape)]
    assert [tuple(x.spec) for x in JIS.decode_input_shardings(
        jm, jshape.global_batch)] == [s.spec for s in
                                      TIS.decode_input_shardings(
                                          tm, tshape.global_batch)]


@pytest.mark.parametrize("seq_shard", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_sp_policy_and_placements(mesh, seq_shard):
    """The reference's residual and logits specs; the port's extra
    block_in (the sequence gathered) is the residual without its sequence
    entry. A spec's placements: Shard(d) on each mesh dim of entry d."""
    from torch.distributed.tensor import Replicate, Shard
    jm, tm = _meshes(mesh)
    want = JPOL.sp_policy(jm, seq_shard=seq_shard).specs
    got = TPOL.sp_policy(tm, seq_shard=seq_shard).specs
    for kind in ("residual", "logits"):
        assert got[kind] == tuple(want[kind]), kind
    assert got["block_in"] == got["residual"][:1] + (None, None)
    names = list(tm)
    res = TSH.placements(got["residual"], tm)
    assert [p for n, p in zip(names, res) if n != "model"] == \
        [Shard(0)] * (len(names) - 1)
    assert res[names.index("model")] == (Shard(1) if seq_shard
                                         else Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        TSH.placements((("data", "pod"),), {"pod": 2, "data": 2})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_is_the_references_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((64, 33)) * 10.0 ** rng.uniform(-4, 2)) \
        .astype(np.float32)
    jq, js = JCOMP.quantize(jnp.asarray(g))
    tq, ts = TCOMP.quantize(torch.tensor(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(TCOMP.dequantize(tq, ts).numpy(),
                                  np.asarray(JCOMP.dequantize(jq, js)))
    assert TCOMP.wire_bytes_ratio() == JCOMP.wire_bytes_ratio()
