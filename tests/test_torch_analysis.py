"""Analysis parity: ``build_flow`` in the JAX package (``repro``) and in its
PyTorch port (``repro_torch``) from the same factory arguments gives the
same optimized graph, initializers, ranges, tail reports and accumulator
widths, for every workload (HSW included).

The analysis half is numpy-only in both packages, so every value is
compared **exactly**.  Names are compared *up to renaming of generated
names*: fresh tensor/node names come from a process-global counter
(``core/graph.py``), so the same flow yields ``..._584`` in one package and
``..._710`` in the other.  ``_name_map`` pairs the names by topological
position and the comparisons go through that map.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.workloads import ALL_WORKLOADS as J_WORKLOADS
import repro_torch.core as tcore
from repro_torch.core.workloads import ALL_WORKLOADS as T_WORKLOADS

ALL_NAMES = list(J_WORKLOADS)
RANGE_ARRAYS = ("lo", "hi", "int_lo", "int_hi", "scale", "bias")


def _flows(name, domain="interval"):
    return (jcore.build_flow(J_WORKLOADS[name](), domain=domain),
            tcore.build_flow(T_WORKLOADS[name](), domain=domain))


def _name_map(gj, gt):
    """{reference name: port name} for tensors and nodes, paired by
    topological position; asserts the pairing is one-to-one."""
    gj.toposort()
    gt.toposort()
    assert list(gj.inputs) == list(gt.inputs)
    assert len(gj.nodes) == len(gt.nodes)
    tmap = {i: i for i in gj.inputs}
    nmap = {}

    def pair(a, b):
        assert tmap.setdefault(a, b) == b, f"{a} pairs with two names"
    for nj, nt in zip(gj.nodes, gt.nodes):
        assert nj.op_type == nt.op_type
        assert len(nj.inputs) == len(nt.inputs)
        assert len(nj.outputs) == len(nt.outputs)
        nmap[nj.name] = nt.name
        for a, b in zip(list(nj.inputs) + list(nj.outputs),
                        list(nt.inputs) + list(nt.outputs)):
            pair(a, b)
    assert len(set(tmap.values())) == len(tmap), "pairing is not injective"
    assert [tmap[o] for o in gj.outputs] == list(gt.outputs)
    return tmap, nmap


def _same_value(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), what
        for x, y in zip(a, b):
            _same_value(x, y, what)
    else:
        assert a == b, what


@pytest.mark.parametrize("name", ALL_NAMES)
def test_flow_graph_parity(name):
    """Same op sequence, attrs and initializer values (bit for bit)."""
    assert_graph_parity(*_flows(name))


def assert_graph_parity(rj, rt):
    gj, gt = rj.graph, rt.graph
    tmap, _ = _name_map(gj, gt)
    assert [n.op_type for n in gj.nodes] == [n.op_type for n in gt.nodes]
    for nj, nt in zip(gj.nodes, gt.nodes):
        assert sorted(nj.attrs) == sorted(nt.attrs), nj.name
        for k in nj.attrs:
            _same_value(nj.attrs[k], nt.attrs[k], f"{nj.name}.{k}")
    assert {tmap[k] for k in gj.initializers if k in tmap} \
        <= set(gt.initializers)
    used = [k for k in gj.initializers if k in tmap]
    assert len(used) == len([k for k in gt.initializers
                             if k in set(tmap.values())])
    for k in used:
        a, b = gj.initializers[k], gt.initializers[tmap[k]]
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes(), f"initializer {k} differs"


@pytest.mark.parametrize("name", ALL_NAMES)
def test_flow_range_parity(name):
    """Every tensor's ScaledIntRange has identical fields."""
    assert_range_parity(*_flows(name))


def assert_range_parity(rj, rt):
    tmap, _ = _name_map(rj.graph, rt.graph)
    ranges_j, ranges_t = rj.model.ranges, rt.model.ranges
    assert {tmap[k] for k in ranges_j if k in tmap} == \
        {k for k in ranges_t if k in set(tmap.values())}
    checked = 0
    for k, r in ranges_j.items():
        if k not in tmap:
            continue
        q = ranges_t[tmap[k]]
        for f in RANGE_ARRAYS:
            a, b = getattr(r, f), getattr(q, f)
            assert (a is None) == (b is None), f"{k}.{f}"
            if a is not None:
                assert a.shape == b.shape, f"{k}.{f}"
                np.testing.assert_array_equal(a, b, err_msg=f"{k}.{f}")
        for f in ("scale_src", "bias_src"):
            assert {tmap.get(s, s) for s in getattr(r, f)} == \
                set(getattr(q, f)), f"{k}.{f}"
        checked += 1
    assert checked >= len(rj.graph.nodes)


@pytest.mark.parametrize("name", ALL_NAMES)
def test_flow_reports_parity(name):
    """tail_reports, threshold specs and per-layer accumulator bits."""
    assert_reports_parity(*_flows(name))


def assert_reports_parity(rj, rt):
    tmap, nmap = _name_map(rj.graph, rt.graph)
    assert len(rj.tail_reports) == len(rt.tail_reports)
    for a, b in zip(rj.tail_reports, rt.tail_reports):
        # anchors name Quant nodes the conversion removed; generated
        # names differ only in the counter suffix, which is not compared
        assert (a.n_ops, a.converted, a.status, a.method, a.reason) == \
            (b.n_ops, b.converted, b.status, b.method, b.reason)
        assert tmap[a.input_tensor] == b.input_tensor
    assert len(rj.threshold_specs) == len(rt.threshold_specs)
    for a, b in zip(rj.threshold_specs, rt.threshold_specs):
        np.testing.assert_array_equal(a.thresholds, b.thresholds)
        _same_value(np.asarray(a.out_scale), np.asarray(b.out_scale), "scale")
        _same_value(np.asarray(a.out_bias), np.asarray(b.out_bias), "bias")
        assert (a.n_steps, a.method) == (b.n_steps, b.method)
    assert rj.accumulator_reports, "no accumulator reports"
    assert len(rj.accumulator_reports) == len(rt.accumulator_reports)
    for a, b in zip(rj.accumulator_reports, rt.accumulator_reports):
        assert nmap[a.node_name] == b.node_name
        assert (a.op_type, a.K, a.sira_bits, a.datatype_bits,
                a.baseline_bits) == \
            (b.op_type, b.K, b.sira_bits, b.datatype_bits, b.baseline_bits)
    assert [s.name for s in rj.steps] == [s.name for s in rt.steps]
    assert [s.modified for s in rj.steps] == [s.modified for s in rt.steps]


@pytest.mark.parametrize("name", ALL_NAMES)
def test_flow_outputs_parity(name):
    """Both optimized graphs compute the same function (numpy executor)."""
    assert_outputs_parity(*_flows(name))


def assert_outputs_parity(rj, rt):
    feeds = next(iter(rj.model.sample_inputs(
        rng=np.random.default_rng(5), n=1)))
    oj = rj.model.execute(feeds)
    ot = rt.model.execute(feeds)
    for a, b in zip(rj.graph.outputs, rt.graph.outputs):
        np.testing.assert_array_equal(oj[a], ot[b])


def test_affine_domain_runs_in_the_port():
    """``domain="affine"`` runs through ``build_flow`` and ``analyze`` and
    never proves a wider range than the interval domain."""
    wl = T_WORKLOADS["TFC-w2a2"]()
    res = tcore.build_flow(wl, domain="affine")
    assert res.model.domain == "affine"
    assert sum(r.sira_bits for r in res.accumulator_reports) == 26
    r_aff = tcore.analyze(wl.graph, wl.input_range, domain="affine")
    r_int = tcore.analyze(wl.graph, wl.input_range, domain="interval")
    assert r_aff.keys() == r_int.keys()
    for k, r in r_aff.items():
        assert float(np.min(r.lo)) >= float(np.min(r_int[k].lo)) - 1e-9, k
        assert float(np.max(r.hi)) <= float(np.max(r_int[k].hi)) + 1e-9, k


@pytest.mark.parametrize("step,transform,keys", [
    ("step_dataflow_estimate", "DataflowEstimate",
     ("dataflow_report", "dataflow_estimate")),
    ("step_dataflow_fold", "DataflowFold", ("folding",)),
])
def test_dataflow_steps_run_in_the_port(step, transform, keys):
    """Each dataflow step runs on its own, in both domains, and puts its
    result under the model's metadata."""
    assert step in tcore.STEP_REGISTRY
    for domain in ("interval", "affine"):
        res = tcore.build_flow(T_WORKLOADS["TFC-w2a2"](), steps=[step],
                               domain=domain, target_fps=1000.0)
        assert [s.name for s in res.steps] == ["lint_graph", transform]
        for k in keys:
            assert res.model.metadata.get(k) is not None, (domain, k)


def test_accumulator_dtype_returns_torch_dtypes():
    assert tcore.accumulator_dtype(12) == torch.int16
    assert tcore.accumulator_dtype(15) == torch.int16
    assert tcore.accumulator_dtype(16) == torch.int32
    assert tcore.accumulator_dtype(31) == torch.int32
    assert tcore.accumulator_dtype(32) == torch.int64
