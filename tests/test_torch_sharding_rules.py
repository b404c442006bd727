"""The port's ``sharding/rules.py`` against ``repro.sharding.rules``, spec
for spec, in the pytest process (pure logic: no process group).

Every leaf of all ten configs' ``reduce_for_smoke`` params trees (the JAX
package's ``params_struct`` and the port's meta-device one, whose leaf
paths must agree), their decode caches (``decode_specs`` at
``decode_32k``) and their train batches (``train_4k``), over the meshes
(1, 1), (2, 4), (4, 2), (16, 16) of ("data", "model") and (2, 16, 16) of
("pod", "data", "model").  The reference's rules read only a mesh's
``axis_names`` and ``devices.shape``, so a stand-in object is its mesh; its
``NamedSharding`` is swapped for the bare spec.  The port's mesh is a
``MeshShape``.
"""
import types

import jax
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.launch import specs as jspecs
from repro.sharding import rules as jrules
from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.sharding import rules
from repro_torch.sharding.rules import MeshShape, P

MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 4)),
          (("data", "model"), (4, 2)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]
ARCHS = configs.list_archs()


def _meshes():
    for names, shape in MESHES:
        yield (types.SimpleNamespace(axis_names=names,
                                     devices=np.empty(shape, object)),
               MeshShape(names, shape))


@pytest.fixture(autouse=True)
def _bare_jax_specs(monkeypatch):
    monkeypatch.setattr(jrules, "NamedSharding", lambda mesh, spec: spec)


def _jax_flat(tree):
    return [(path, leaf) for path, leaf in jrules._paths_and_leaves(tree)[0]]


def _specs(tree):
    return [tuple(s.spec) for _, s in rules.paths_and_leaves(tree)]


def _jspecs(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _cfgs(arch):
    return (jconfigs.reduce_for_smoke(jconfigs.get_config(arch)),
            configs.reduce_for_smoke(configs.get_config(arch)))


def test_ten_configs():
    assert len(ARCHS) == 10 and ARCHS == jconfigs.list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    jstruct = jspecs.params_struct(jcfg)
    struct = specs.params_struct(cfg)
    jflat = _jax_flat(jstruct)
    flat = rules.paths_and_leaves(struct)
    assert [p for p, _ in flat] == [p for p, _ in jflat]
    assert [tuple(x.shape) for _, x in flat] == \
        [tuple(x.shape) for _, x in jflat]
    for jmesh, mesh in _meshes():
        for kw in ({}, {"mode": "ep"}, {"model_parallel": False}):
            want = _jspecs(jrules.param_shardings(jcfg, jstruct, jmesh, **kw))
            got = _specs(rules.param_shardings(cfg, struct, mesh, **kw))
            assert got == want, (arch, mesh, kw)
        for path, leaf in flat:
            assert tuple(rules.param_spec(cfg, path, tuple(leaf.shape),
                                          mesh)) == \
                tuple(jrules.param_spec(jcfg, path, tuple(leaf.shape),
                                        jmesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_shardings_match_reference(arch):
    jcfg, cfg = _cfgs(arch)
    dshape = jconfigs.get_shape("decode_32k")
    jcache = jspecs.decode_specs(jcfg, dshape, jspecs.params_struct(jcfg))[0]
    cache = specs.decode_specs(cfg, configs.get_shape("decode_32k"),
                               specs.params_struct(cfg))[0]
    assert [p for p, _ in rules.paths_and_leaves(cache)] == \
        [p for p, _ in _jax_flat(jcache)]
    tshape = jconfigs.get_shape("train_4k")
    jbatch = jspecs.train_batch_specs(jcfg, tshape)
    batch = specs.train_batch_specs(cfg, configs.get_shape("train_4k"))
    for jmesh, mesh in _meshes():
        for seq in (True, False):
            assert _specs(rules.cache_shardings(cfg, cache, mesh,
                                                seq_on_model=seq)) == \
                _jspecs(jrules.cache_shardings(jcfg, jcache, jmesh,
                                               seq_on_model=seq))
        for axes in (None, mesh.axis_names):
            assert _specs(rules.batch_shardings(batch, mesh, axes)) == \
                _jspecs(jrules.batch_shardings(jbatch, jmesh, axes))


def test_cache_shardings_head_vs_seq():
    """tests/test_sharding_rules.py's case at (16, 16): 8 kv heads do not
    divide 16, so the sequence dim takes "model" unless told not to."""
    import torch
    cfg = configs.get_config("minitron-8b")
    kv = torch.empty((32, 128, 32768, 8, 128), device="meta")
    cache = {"layers": {"k": kv, "v": kv}}
    mesh = MeshShape(("data", "model"), (16, 16))
    spec = rules.cache_shardings(cfg, cache, mesh)["layers"]["k"].spec
    assert spec == P(None, "data", "model", None, None)
    spec = rules.cache_shardings(cfg, cache, mesh,
                                 seq_on_model=False)["layers"]["k"].spec
    assert spec == P(None, "data", None, None, None)


def test_activation_rules_and_strip_axes_match_reference():
    for jmesh, mesh in _meshes():
        want = jrules.default_activation_rules(jmesh)
        got = rules.default_activation_rules(mesh)
        assert sorted(got) == sorted(want)
        for key in want:
            assert tuple(got[key]) == tuple(want[key])
        for axes in ({"model"}, {"data"}, {"pod", "data"}):
            ws = jrules.strip_axes(want, axes)
            gs = rules.strip_axes(got, axes)
            assert {k: tuple(v) for k, v in gs.items()} == \
                {k: tuple(v) for k, v in ws.items()}
    assert rules.replicated(MeshShape(("data", "model"), (2, 4))).spec == P()
    assert rules.FSDP_ARCHS == jrules.FSDP_ARCHS


def test_spec_placements():
    m2 = MeshShape(("cohort", "model"), (2, 4))
    assert rules.spec_placements(P(None, "model"), m2) == \
        [Replicate(), Shard(1)]
    assert rules.spec_placements(P(), m2) == [Replicate(), Replicate()]
    m3 = MeshShape(("pod", "data", "model"), (2, 16, 16))
    # a tuple of axes shards one dim over each of those mesh dims
    assert rules.spec_placements(P(("pod", "data"), None, "model"), m3) == \
        [Shard(0), Shard(0), Shard(2)]
    with pytest.raises(ValueError, match="not an axis"):
        rules.spec_placements(P("data"), m2)
    sh = rules.NamedSharding(m2, P("model"))
    assert sh.placements == [Replicate(), Shard(0)]
