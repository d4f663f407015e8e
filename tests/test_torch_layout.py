"""Port parity for ``launch/shardings.py`` and the layout of
``launch/mesh.py``, on the CPU.

The specs are the reference's ``PartitionSpec`` trees as tuples.  Each
function is held to the reference on the reference's own inputs (its
stacked shape trees, made by ``jax.eval_shape``, so the full configs
allocate nothing), and ``param_pspecs`` also on the port's own tree
(``Model.init_shapes``: layers a list, so each layer's spec is the
reference's without its stacking dims).  All ten configs, full and
reduced, with and without ``pack_weights_int8``.  ``filter_*`` is held
on fake meshes of the production and debug shapes (the reference reads
only ``axis_names`` and ``devices.shape``), ``kv_pool_sharding`` on a
real one-device mesh.  Equality is exact: the rules are strings and
integers.
"""
import os
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.launch import shardings as j_sh
from repro.models import get_model as j_get_model
from repro.quant.quantizer import pack_weights_int8 as j_pack
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import shardings as t_sh
from repro_torch.models import get_model
from repro_torch.quant.quantizer import pack_weights_int8

ARCHS = list_archs()
LAYOUT_SHAPES = [((32, 8), ("data", "model")),
                 ((2, 32, 8), ("pod", "data", "model")),
                 ((16, 16), ("data", "model")),
                 ((1, 2), ("data", "model"))]


def _tuple(spec):
    return tuple(tuple(a) if isinstance(a, (tuple, list)) else a
                 for a in spec)


def _ref_leaves(tree, is_spec=False):
    """{path: leaf} of a reference tree (PartitionSpecs or shapes)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=(lambda x: isinstance(x, P)) if is_spec else None)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def _port_leaves(tree, path=""):
    """{path: leaf} of a port tree; a layer list's items flattened into
    their index."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{path}/{k}" if path else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_port_leaves(v, f"{path}/{i}"))
        return out
    return {path: tree}


_SHAPES = {}


def _ref_shapes(arch, reduced, packed):
    key = (arch, reduced, packed)
    if key not in _SHAPES:
        jm = j_get_model(j_get_config(arch, reduced=reduced))
        s = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        _SHAPES[key] = jax.eval_shape(j_pack, s) if packed else s
    return _SHAPES[key]


def _port_tree(arch, reduced, packed):
    cfg = get_config(arch, reduced=reduced)
    tree = get_model(cfg, device="cpu").init_shapes()
    return pack_weights_int8(tree, cfg=cfg) if packed else tree


def _ref_key(cfg, port_path):
    """The reference's path of a port leaf, and its stacking dims."""
    parts = port_path.split("/")
    if parts[0] != "layers":
        return port_path, 0
    rest = "/".join(parts[2:])
    if cfg.sliding_window:
        local = int(parts[1]) % 2 == 0
        return f"layers/{'local' if local else 'global'}/{rest}", 1
    if cfg.family == "hybrid":
        return f"layers/{rest}", 2
    return f"layers/{rest}", 1


CASES = [(a, r, p) for a in ARCHS for r in (False, True)
         for p in (False, True)]
IDS = [f"{a}-{'reduced' if r else 'full'}-{'int8' if p else 'float'}"
       for a, r, p in CASES]


@pytest.mark.parametrize("arch,reduced,packed", CASES, ids=IDS)
def test_param_and_opt_pspecs_match_reference(arch, reduced, packed):
    """On the reference's shape tree, the port's ``param_pspecs`` and
    ``opt_pspecs`` give the reference's specs; on the port's own tree,
    every leaf's spec is the reference's without the stacking dims."""
    shapes = _ref_shapes(arch, reduced, packed)
    j_specs = j_sh.param_pspecs(shapes)
    t_specs = t_sh.param_pspecs(shapes)
    want = {k: _tuple(v) for k, v in _ref_leaves(j_specs, True).items()}
    assert _port_leaves(t_specs) == want
    j_opt = {k: _tuple(v) for k, v in _ref_leaves(
        j_sh.opt_pspecs(shapes, j_specs), True).items()}
    assert _port_leaves(t_sh.opt_pspecs(shapes, t_specs)) == j_opt

    cfg = get_config(arch, reduced=reduced)
    tree = _port_tree(arch, reduced, packed)
    port = _port_leaves(t_sh.param_pspecs(tree))
    ref_shapes = _ref_leaves(shapes)
    seen = set()
    for path, spec in port.items():
        key, stack = _ref_key(cfg, path)
        assert key in want, (path, key)
        assert spec == want[key][stack:], (path, spec, want[key])
        assert len(spec) == len(ref_shapes[key].shape) - stack
        seen.add(key)
    assert seen == set(want)


@pytest.mark.parametrize("shape,axes", LAYOUT_SHAPES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v[0], int) else None)
@pytest.mark.parametrize("arch", ARCHS)
def test_filter_spec_for_layout_matches_reference(arch, shape, axes):
    """``filter_spec_for_layout`` on a layout of the mesh's shape equals
    ``filter_pspec_for_mesh`` for every leaf of the full config's tree
    (packed too), with and without the leaf's shape, and for the batch
    and page-pool specs."""
    mesh = types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, np.int8))
    layout = t_mesh.make_layout(shape, axes)
    assert not layout.bound
    for packed in (False, True):
        shapes = _ref_shapes(arch, False, packed)
        specs = _ref_leaves(j_sh.param_pspecs(shapes), True)
        leaves = _ref_leaves(shapes)
        for path, spec in specs.items():
            for shp in (None, leaves[path].shape):
                want = _tuple(j_sh.filter_pspec_for_mesh(spec, mesh, shp))
                got = t_sh.filter_spec_for_layout(_tuple(spec), layout, shp)
                assert got == want, (path, shp)
    for nd in (1, 2, 4):
        want = _tuple(j_sh.filter_pspec_for_mesh(j_sh.batch_pspec(nd), mesh,
                                                 (64,) * nd))
        assert t_sh.filter_spec_for_layout(t_sh.batch_pspec(nd), layout,
                                           (64,) * nd) == want
    cfg = get_config(arch)
    want = _tuple(j_sh.filter_pspec_for_mesh(
        j_sh.kv_page_pspec(), mesh, (1, 1, cfg.n_kv_heads, 1)))
    assert t_sh.kv_pool_sharding(layout, cfg.n_kv_heads) == want
    assert t_sh.kv_page_pspec() == _tuple(j_sh.kv_page_pspec())


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_pool_sharding_matches_reference(arch):
    """On a real one-device mesh: the reference's NamedSharding's spec."""
    cfg = get_config(arch)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want = _tuple(j_sh.kv_pool_sharding(mesh, cfg.n_kv_heads).spec)
    assert t_sh.kv_pool_sharding(t_mesh.make_layout((1, 1)),
                                 cfg.n_kv_heads) == want


@pytest.fixture(scope="module")
def j_cache_pspecs():
    """The reference's ``cache_pspecs`` lives in its dry run, whose import
    sets ``XLA_FLAGS``; the variable is put back."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import cache_pspecs
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return cache_pspecs


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_reference(arch, j_cache_pspecs):
    """The decode caches of every config (reduced), for model axes of 1,
    2 and 16 and with/without the KV heads."""
    jm = j_get_model(j_get_config(arch, reduced=True))
    j_cache = jax.eval_shape(lambda: jm.init_cache(2, 16))
    cfg = get_config(arch, reduced=True)
    t_cache = get_model(cfg, device="cpu").init_cache(2, 16)
    for kv in (0, cfg.n_kv_heads):
        for m in (1, 2, 16):
            want = {k: _tuple(v) for k, v in _ref_leaves(
                j_cache_pspecs(j_cache, kv, m), True).items()}
            got = _port_leaves(t_sh.cache_pspecs(t_cache, kv, m))
            assert got == want, (kv, m)


def test_zero_shard_matches_reference():
    for spec, shape in [((None, "model"), (1536, 256)),
                        (("model", None), (8, 8)), ((None,), (16,)),
                        ((None, None, "model"), (28, 17, 64))]:
        assert t_sh.zero_shard(spec, shape) == _tuple(
            j_sh.zero_shard(P(*spec), shape))


# -------------------------------------------------------------- layout

def test_production_and_debug_layouts():
    """The H100 production shapes (``model`` inside one 8-GPU node), shape
    only without a 256/512-rank job; the debug layout of one process."""
    pod = t_mesh.make_production_layout()
    assert (pod.shape, pod.axis_names, pod.bound) == \
        ((32, 8), ("data", "model"), False)
    multi = t_mesh.make_production_layout(multi_pod=True)
    assert (multi.shape, multi.axis_names, multi.n_devices, multi.name) == \
        ((2, 32, 8), ("pod", "data", "model"), 512, "2x32x8")
    dbg = t_mesh.make_debug_layout(4)
    assert dbg.shape == (1, 1) and dbg.bound and dbg.backend is None
    with pytest.raises(RuntimeError, match="shapes only"):
        pod.all_reduce(np.zeros(1), "model")


def test_coords_and_axis_groups():
    """Ranks row-major over the axes, ``model`` fastest, as jax orders a
    mesh's devices; each axis's groups are the ranks agreeing on the
    other axes."""
    lay = t_mesh.Layout(("pod", "data", "model"), (2, 2, 2), rank=5)
    assert lay.coords() == {"pod": 1, "data": 0, "model": 1}
    assert lay.index("model") == 1 and lay.index("expert") == 0
    assert lay.size(("pod", "data")) == 4 and lay.size("expert") == 1
    devices = np.arange(8).reshape(2, 2, 2)
    for axis, dim in (("pod", 0), ("data", 1), ("model", 2)):
        want = sorted(sorted(int(r) for r in row) for row in
                      np.moveaxis(devices, dim, -1).reshape(-1, 2))
        assert sorted(t_mesh._axis_groups(lay, axis)) == want
    with pytest.raises(ValueError):
        t_mesh.Layout(("data", "model"), (2,))


def test_collectives_over_one_rank_move_and_count_nothing():
    lay = t_mesh.make_layout((1, 1))
    x = torch.arange(6.0)
    assert lay.all_reduce(x) is x and lay.max(x) is x
    assert lay.all_gather(x) is x
    with t_mesh.use_layout(lay):
        assert t_mesh.current_layout() is lay
        assert t_mesh.all_reduce(x, "model") is x
        assert t_mesh.max(x, "data") is x
    assert t_mesh.current_layout() is None
    assert lay.stats.stats().counts == {}
    with pytest.raises(RuntimeError, match="no layout"):
        t_mesh.all_reduce(x, "model")


def test_ring_rule_of_the_counter_matches_the_reference_parser():
    """``CollectiveCounter``'s wire bytes: the reference's ring model
    (``parse_collectives``: all-reduce 2(g-1)/g, all-gather (g-1)/g)."""
    c = t_mesh.CollectiveCounter()
    c.record("all-reduce", 1000, 4)
    c.record("all-gather", 1000, 8)
    c.record("all-reduce", 10, 2, "pod", internode=True)
    s = c.stats()
    assert s.counts == {"all-reduce": 2, "all-gather": 1}
    assert s.wire_bytes == {"all-reduce": 1500 + 10, "all-gather": 875}
    assert s.total_operand_bytes == 2010 and s.cross_pod_bytes == 10
    assert s.internode_bytes == 10


def test_backend_is_explicit():
    assert t_mesh.pick_backend("cpu", 2) == "gloo"
    assert str(t_mesh.rank_device("cpu", 1, "gloo")) == "cpu"


def test_init_ranks_defaults_to_the_card():
    """``device=None`` means the card, as at every entry point of the
    port: without one it raises before any process group is made."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would take it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mesh.init_ranks(0, 1, "file:///nonexistent/rendezvous")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("shape,axis,crosses", [
    ((32, 8), "model", False), ((32, 8), "data", True),
    ((32, 8), ("pod", "data"), True), ((2, 32, 8), "pod", True),
    ((2, 32, 8), "model", False), ((4, 2), "data", False),
    ((1, 16), "model", True), ((1, 1), "data", False)])
def test_groups_that_span_nodes(shape, axis, crosses):
    """8-GPU nodes of consecutive ranks, "model" fastest: the production
    layouts keep "model" inside a node and cross nodes on the data
    axes."""
    assert t_mesh.make_layout(shape).crosses_nodes(axis) == crosses
