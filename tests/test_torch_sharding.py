"""The port's sharding rules (``repro_torch.distributed.sharding``) and
placement policies (``distributed.mesh_backend.placement_specs``) against
the reference's, on device-less meshes: the reference's ``abstract_mesh``
and the port's ``AbstractMesh`` of the same shape.  Neither side needs a
device or a process group.

For all ten archs of ``ALL_ARCHS`` at their PUBLISHED widths, on the
2×4, 16×16 and 2×16×16 meshes, and for the train / prefill / decode
kinds (the production ``SHAPES``), these must equal the reference's
entry for entry: the param specs of ``tree_shardings`` with the
divisibility guard's ``dropped`` records, the batch specs, the decode
cache specs with their drops, and ``MeshPolicy``'s table.  Specs are
compared as tuples (a ``PartitionSpec`` iterates as its entries).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.distributed import mesh_backend as ref_mb
from repro.distributed import sharding as ref_sh
from repro.launch.steps import input_specs as ref_input_specs
from repro.models import Transformer as RefTransformer
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config
from repro_torch.distributed import mesh_backend as mb
from repro_torch.distributed import sharding as sh
from repro_torch.launch.steps import input_specs
from repro_torch.models import Transformer
from repro_torch.tree import flatten_with_paths

ARCHS = tuple(cfg.name for cfg in ALL_ARCHS)
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}


def _meshes(mesh):
    shape, axes = MESHES[mesh]
    return ref_sh.abstract_mesh(shape, axes), sh.abstract_mesh(shape, axes)


def _ref_specs(tree):
    """{path: spec tuple} of a reference NamedSharding tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            tuple(s.spec) for path, s in flat}


def _port_specs(tree):
    return {p: s.spec for p, s in flatten_with_paths(
        tree, is_leaf=lambda x: isinstance(x, sh.NamedSharding))}


def _drops(dropped):
    return [tuple(d) for d in dropped]


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_param_batch_and_cache_specs_match_reference(name, mesh, kind):
    jmesh, tmesh = _meshes(mesh)
    jcfg, cfg = ref_get_config(name), get_config(name)
    jrules, trules = ref_sh.make_rules(jmesh, kind), sh.make_rules(tmesh,
                                                                   kind)
    jm, tm = RefTransformer(jcfg), Transformer(cfg)

    # params
    want = _ref_specs(ref_sh.tree_shardings(jrules, jm.abstract_params(),
                                            jm.logical_axes()))
    got = _port_specs(sh.tree_shardings(trules, tm.abstract_params(),
                                        tm.logical_axes()))
    assert got == want
    assert _drops(trules.dropped) == _drops(jrules.dropped)

    # batch
    shape = SHAPES[KINDS[kind]]
    jb = ref_sh.batch_specs(jrules, jcfg, kind,
                            ref_input_specs(jcfg, REF_SHAPES[KINDS[kind]]))
    tb = sh.batch_specs(trules, cfg, kind, input_specs(cfg, shape))
    assert {k: s.spec for k, s in tb.items()} == \
        {k: tuple(s.spec) for k, s in jb.items()}

    # the decode cache
    if kind == "decode":
        B, T = shape.global_batch, shape.seq_len
        jcache = jax.eval_shape(lambda: jm.init_cache(B, T))
        tcache = tm.init_cache(B, T, device="meta")
        n = len(jrules.dropped)
        want = _ref_specs(ref_sh.cache_shardings(jrules, jcache))
        got = _port_specs(sh.cache_shardings(trules, tcache))
        assert got == want
        assert _drops(trules.dropped[n:]) == _drops(jrules.dropped[n:])


@pytest.mark.parametrize("seq_shard", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_mesh_policy_table_matches_reference(name, mesh, seq_shard):
    jmesh, tmesh = _meshes(mesh)
    jp = ref_sh.MeshPolicy(ref_sh.make_rules(jmesh, "train"),
                           ref_get_config(name), seq_shard=seq_shard)
    tp = sh.MeshPolicy(sh.make_rules(tmesh, "train"), get_config(name),
                       seq_shard=seq_shard)
    assert tp.table == {k: tuple(v) for k, v in jp.table.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_fsdp_layers_rules_match_reference(name, mesh):
    jmesh, tmesh = _meshes(mesh)
    jrules = ref_sh.make_rules(jmesh, "train", fsdp_layers=True)
    trules = sh.make_rules(tmesh, "train", fsdp_layers=True)
    jm, tm = RefTransformer(ref_get_config(name)), Transformer(
        get_config(name))
    want = _ref_specs(ref_sh.tree_shardings(jrules, jm.abstract_params(),
                                            jm.logical_axes()))
    got = _port_specs(sh.tree_shardings(trules, tm.abstract_params(),
                                        tm.logical_axes()))
    assert got == want
    assert _drops(trules.dropped) == _drops(jrules.dropped)


def _placement_shapes():
    """The reference's 16-way case: qwen2.5's 40 heads and arctic's 56
    do not divide a 16-way "model" axis, arctic's 128 experts do."""
    q, a = get_config("qwen2.5-14b"), get_config("arctic-480b")
    assert q.n_heads == 40 and a.n_heads == 56 and a.n_experts == 128
    return {"w_q": (q.d_model, q.n_heads * q.d_head),
            "heads40": (128, q.n_heads), "heads56": (64, a.n_heads),
            "experts128": (64, a.n_experts), "scalar": (),
            "a": (256, 256), "v": (30,)}


@pytest.mark.parametrize("mesh", [((2, 4), ("data", "model")),
                                  ((1, 8), ("data", "model")),
                                  ((1, 16), ("data", "model")),
                                  ((16, 16), ("data", "model"))],
                         ids=["2x4", "1x8", "1x16", "16x16"])
@pytest.mark.parametrize("policy", ["replicate", "fsdp", "tp"])
def test_placement_specs_match_reference(policy, mesh):
    shapes = _placement_shapes()
    jshapes = {k: jax.ShapeDtypeStruct(v, np.float32)
               for k, v in shapes.items()}
    tshapes = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
    want, wdrop = ref_mb.placement_specs(jshapes,
                                         ref_sh.abstract_mesh(*mesh), policy)
    got, gdrop = mb.placement_specs(tshapes, sh.abstract_mesh(*mesh),
                                    policy)
    assert got == {k: tuple(v) for k, v in want.items()}
    assert _drops(gdrop) == _drops(wdrop)
    if policy == "tp" and mesh[0] == (1, 16):
        assert got["heads40"][-1] is None and got["heads56"][-1] is None
        assert got["experts128"][-1] == "model"
        assert {"heads40", "heads56"} <= {d[0] for d in gdrop}


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8, 16])
def test_auto_mesh_shape_matches_reference(n):
    assert mb.auto_mesh_shape(n) == ref_mb.auto_mesh_shape(n)


def test_canonical_placement_matches_reference():
    for placement in ({"b": ["data", None], "a": [["pod", "data"]]},
                      [("x", ("model",))], None, {}):
        assert mb.canonical_placement(placement) == \
            ref_mb.canonical_placement(placement)


@pytest.mark.parametrize("spec,want", [
    ((("pod", "data"), None, "model"), ("S0", "S0", "S2")),
    ((None, "data"), ("R", "S1", "R")),
    ((), ("R", "R", "R")),
])
def test_spec_to_placements(spec, want):
    """A spec is per tensor dim, placements per mesh dim: a tuple entry
    shards its dim over each named axis, major to minor."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = sh.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    got = sh.placements(mesh, spec)
    assert got == tuple(Replicate() if w == "R" else Shard(int(w[1]))
                        for w in want)


def test_spec_out_of_axis_order_raises():
    mesh = sh.abstract_mesh((2, 2, 2), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="axis order"):
        sh.placements(mesh, (("data", "pod"),))


def test_policy_is_the_identity_on_plain_tensors():
    tm = sh.MeshPolicy(sh.make_rules(sh.abstract_mesh(), "train"),
                       get_config("qwen2.5-14b"))
    x = torch.ones(2, 3, 4)
    assert tm.acts(x, "embeds") is x and tm.acts(x, "no-such-tag") is x


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_without_a_group_is_abstract(multi_pod):
    """With no process group of the pod's size the production mesh is its
    shape and names only: the reference's 16×16 ("data", "model") and
    2×16×16 ("pod", "data", "model") (the ``DeviceMesh`` on a fake group
    of 256 ranks: tests/test_torch_mesh.py)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    assert not dist.is_initialized()
    got = make_production_mesh(multi_pod=multi_pod)
    assert isinstance(got, sh.AbstractMesh)
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert got.shape == want
