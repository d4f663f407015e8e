"""The affine (zonotope) domain and the soundness fuzzer of the port
(``repro_torch.core.affine``, ``repro_torch.core.fuzz``) against the JAX
package's (``repro``), fed the same numpy inputs and seeds, plus the
port's own fix of the ``MatMul``/``Gemm`` interval transfer.

* The affine flow of every workload gives the reference's graph,
  initializers, ranges, tail reports and per-layer accumulator bits, up to
  renaming of generated names (the helpers of ``test_torch_analysis``).
* ``random_graph`` and ``random_tail_graph`` build the same graphs from
  the same ``np.random.Generator``, and both domains give them the same
  ranges, on 100 seeds each.
* The port's MatMul transfer differs from the reference's on purpose: the
  reference sends a point activation times a constant, and any dynamic x
  dynamic product, to a hull of one product (K = 1), which is unsound.
  The port takes the exact constant-weight transfer whenever the weight is
  a point and K from shape inference otherwise.  A fuzz graph that reaches
  a point activation times a constant in the reference is held to
  soundness in the port instead of to equality.
"""
import json
import pathlib

import numpy as np
import pytest

import repro.core as jcore
import repro.core.affine as jaffine
import repro.core.fuzz as jfuzz
from repro.core.workloads import ALL_WORKLOADS as J_WORKLOADS
import repro_torch.core as tcore
import repro_torch.core.affine as taffine
import repro_torch.core.fuzz as tfuzz
from repro_torch.core import Graph, ScaledIntRange, analyze
from repro_torch.core.intervals import dot_interval
from repro_torch.core.lint import contraction_dim
from repro_torch.core.workloads import ALL_WORKLOADS as T_WORKLOADS
from repro_torch.core.workloads import WORKLOADS as T_QNN
from test_torch_analysis import (RANGE_ARRAYS, assert_graph_parity,
                                 assert_outputs_parity, assert_range_parity,
                                 assert_reports_parity)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALL_NAMES = list(J_WORKLOADS)
BENCH = {r["workload"]: r for r in json.loads(
    (ROOT / "benchmarks/baselines/BENCH_dataflow.json").read_text())[
        "results"]}

_FLOWS = {}


def _flows(name, domain):
    """The reference's and the port's flow of one workload, built once."""
    if (name, domain) not in _FLOWS:
        _FLOWS[name, domain] = (
            jcore.build_flow(J_WORKLOADS[name](), domain=domain),
            tcore.build_flow(T_WORKLOADS[name](), domain=domain))
    return _FLOWS[name, domain]


def _rng_range(r):
    return ScaledIntRange(lo=np.asarray(r[0]), hi=np.asarray(r[1]))


# --------------------------------------------------------------------------
# AffineForm algebra and the per-op transfers, against the reference
# --------------------------------------------------------------------------

def _concretized(form):
    lo, hi = form.concretize()
    return np.asarray(lo), np.asarray(hi)


def test_affine_form_algebra_matches_reference():
    rng = np.random.default_rng(0)
    c = rng.normal(size=(5,))
    a, b = rng.normal(size=(5,)), rng.normal(size=(5,))
    k = rng.normal(size=(5,))
    out = []
    for mod in (jaffine, taffine):
        x = mod.AffineForm(c, {"a": a})
        y = mod.AffineForm(-c, {"a": b, "b": a})
        forms = [x + y, x - y, x - x, x.scale_by(k), x + 2.5,
                 x.affine_map(k, 0.5, err_radius=b, symbol="e"),
                 mod.AffineForm.from_interval(c - np.abs(a), c + np.abs(b))]
        out.append([_concretized(f) for f in forms])
        assert (x - x).is_point
    for (lj, hj), (lt, ht) in zip(*out):
        np.testing.assert_array_equal(lj, lt)
        np.testing.assert_array_equal(hj, ht)


def test_sub_cancellation_exact():
    g = Graph(inputs=["x"], outputs=["y"])
    g.add_node("Sub", ["x", "x"], ["y"])
    in_r = {"x": _rng_range((-3.0, 5.0))}
    r_int = analyze(g, in_r, domain="interval")["y"]
    r_aff = analyze(g, in_r, domain="affine")["y"]
    assert float(np.max(r_int.width())) == pytest.approx(16.0)
    assert float(np.max(r_aff.width())) == pytest.approx(0.0, abs=1e-9)
    assert float(r_aff.lo) == pytest.approx(0.0, abs=1e-9)


def test_residual_partial_cancellation():
    g = Graph(inputs=["x"], outputs=["y"])
    c = g.add_initializer(np.asarray(0.5), name="half")
    g.add_node("Mul", ["x", c], ["h"])
    g.add_node("Sub", ["x", "h"], ["y"])
    in_r = {"x": _rng_range((-1.0, 1.0))}
    assert float(np.max(analyze(g, in_r)["y"].width())) == pytest.approx(3.0)
    assert float(np.max(analyze(g, in_r, domain="affine")["y"].width())) \
        == pytest.approx(1.0)


def test_matmul_form_matches_dot_interval_and_reference():
    rng = np.random.default_rng(3)
    W = rng.normal(size=(5, 3))
    x_lo = rng.normal(size=(5,)) - 1.0
    x_hi = x_lo + np.abs(rng.normal(size=(5,)))
    lo_t, hi_t = taffine._matmul_form(
        taffine.AffineForm.from_interval(x_lo, x_hi), W).concretize()
    lo_j, hi_j = jaffine._matmul_form(
        jaffine.AffineForm.from_interval(x_lo, x_hi), W).concretize()
    lo_i, hi_i = dot_interval(W, x_lo, x_hi)
    np.testing.assert_allclose(lo_t, lo_i, atol=1e-12)
    np.testing.assert_allclose(hi_t, hi_i, atol=1e-12)
    np.testing.assert_array_equal(lo_t, lo_j)
    np.testing.assert_array_equal(hi_t, hi_j)


@pytest.mark.parametrize("op,bounds", [
    ("Relu", (-2.0, 4.0)), ("Relu", (-3.0, -1.0)), ("Relu", (0.5, 2.0)),
    ("MulSelf", (-2.0, 3.0)), ("Div", (-1.0, 7.0)), ("Flatten", (-1.0, 1.0)),
])
def test_single_op_affine_ranges_equal_reference_and_sound(op, bounds):
    """One node in the affine domain: the port's range equals the
    reference's and contains every sampled output."""
    ranges, graphs = [], []
    for core in (jcore, tcore):
        g = core.Graph(inputs=["x"], outputs=["y"])
        if op == "MulSelf":
            g.add_node("Mul", ["x", "x"], ["y"])
        elif op == "Div":
            c = g.add_initializer(np.asarray([0.5, -2.0, 4.0]), name="c")
            g.add_node("Div", ["x", c], ["y"])
        else:
            g.add_node(op, ["x"], ["y"])
        r_in = core.ScaledIntRange(lo=np.asarray(bounds[0]),
                                   hi=np.asarray(bounds[1]))
        ranges.append(core.analyze(g, {"x": r_in}, domain="affine")["y"])
        graphs.append(g)
    rj, rt = ranges
    for f in ("lo", "hi"):
        np.testing.assert_array_equal(getattr(rj, f), getattr(rt, f))
    xs = np.random.default_rng(1).uniform(*bounds, size=(64, 3))
    ys = graphs[1].execute({"x": xs})["y"]
    assert rt.contains(ys, atol=1e-9)


def test_tighten_range_preserves_scaled_int_grid():
    r = ScaledIntRange.from_scaled_int(-10, 20, 0.25, 1.0,
                                       scale_src=frozenset({"s"}))
    t = tcore.tighten_range(r, np.asarray(-0.6), np.asarray(3.3))
    assert t.is_scaled_int
    assert float(t.scale) == 0.25 and float(t.bias) == 1.0
    assert t.scale_src == frozenset({"s"})
    assert float(t.int_lo) == -6.0 and float(t.int_hi) == 9.0
    np.testing.assert_allclose(t.lo, 0.25 * -6 + 1.0)
    rj = jcore.ScaledIntRange.from_scaled_int(-10, 20, 0.25, 1.0)
    tj = jcore.tighten_range(rj, np.asarray(-0.6), np.asarray(3.3))
    for f in RANGE_ARRAYS:
        np.testing.assert_array_equal(getattr(tj, f), getattr(t, f))


def test_domain_knob_on_model_and_flow():
    wl = T_WORKLOADS["TFC-w2a2"]()
    m = tcore.SiraModel.from_workload(wl, domain="affine")
    assert m.domain == "affine" and m.copy().domain == "affine"
    assert tcore.build_flow(wl, domain="affine").model.domain == "affine"
    with pytest.raises(ValueError, match="unknown domain"):
        analyze(wl.graph, wl.input_range, domain="octagon")


def test_provenance_records_affine_tightening():
    g = Graph(inputs=["x"], outputs=["y"])
    c = g.add_initializer(np.asarray(0.5), name="half")
    g.add_node("Mul", ["x", c], ["h"])
    g.add_node("Sub", ["x", "h"], ["y"])
    m = tcore.SiraModel(g, {"x": _rng_range((-1.0, 1.0))}, domain="affine")
    assert m.provenance["y"].affine_tightened
    assert not m.provenance["h"].affine_tightened
    assert m.explain("y").entries[0].affine_tightened


# --------------------------------------------------------------------------
# the affine flow of every workload, against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL_NAMES)
def test_affine_flow_graph_and_range_parity(name):
    rj, rt = _flows(name, "affine")
    assert rt.model.domain == "affine"
    assert_graph_parity(rj, rt)
    assert_range_parity(rj, rt)


@pytest.mark.parametrize("name", ALL_NAMES)
def test_affine_flow_reports_and_outputs_parity(name):
    rj, rt = _flows(name, "affine")
    assert_reports_parity(rj, rt)
    assert_outputs_parity(rj, rt)


@pytest.mark.parametrize("name", ALL_NAMES)
def test_summed_bits_equal_the_dataflow_baseline(name):
    """Summed proven accumulator bits in each domain equal the committed
    ``BENCH_dataflow.json`` columns; affine never proves more bits per
    layer, and its ranges lie inside the interval ones."""
    ri, ra = _flows(name, "interval")[1], _flows(name, "affine")[1]
    bits_i = [r.sira_bits for r in ri.accumulator_reports]
    bits_a = [r.sira_bits for r in ra.accumulator_reports]
    assert sum(bits_i) == BENCH[name]["acc_bits_sum_interval"]
    assert sum(bits_a) == BENCH[name]["acc_bits_sum_affine"]
    assert all(a <= i for a, i in zip(bits_a, bits_i))
    for ni, na in zip(ri.graph.nodes, ra.graph.nodes):
        assert ni.op_type == na.op_type
        for ti, ta in zip(ni.outputs, na.outputs):
            a, i = ra.model.ranges[ta], ri.model.ranges[ti]
            assert float(np.min(a.lo)) >= float(np.min(i.lo)) - 1e-6, ti
            assert float(np.max(a.hi)) <= float(np.max(i.hi)) + 1e-6, ti


# --------------------------------------------------------------------------
# fuzz graphs: equal graphs, equal ranges (or sound where C1 differs)
# --------------------------------------------------------------------------

def _same_range(a, b):
    for f in RANGE_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None):
            return False
        if x is not None and (x.shape != y.shape
                              or not np.array_equal(x, y)):
            return False
    return a.scale_src == b.scale_src and a.bias_src == b.bias_src


def _same_graph(gj, gt):
    """Equal up to generated node names: fuzz graphs name every tensor."""
    assert (gj.inputs, gj.outputs) == (gt.inputs, gt.outputs)
    assert [(n.op_type, n.inputs, n.outputs, n.attrs) for n in gj.nodes] \
        == [(n.op_type, n.inputs, n.outputs, n.attrs) for n in gt.nodes]
    assert gj.initializers.keys() == gt.initializers.keys()
    for k, v in gj.initializers.items():
        assert v.tobytes() == gt.initializers[k].tobytes(), k


def _reaches_point_matmul(g, ranges):
    """MatMul nodes whose activation and weight ranges are both points:
    the reference's K = 1 hull (C1) decides their range."""
    return [n.name for n in g.nodes if n.op_type in ("MatMul", "Gemm")
            and ranges[n.inputs[0]].is_point
            and ranges[n.inputs[1]].is_point]


SEED_CHUNKS = [range(i, i + 10) for i in range(0, 100, 10)]


@pytest.mark.parametrize("seeds", SEED_CHUNKS,
                         ids=lambda s: f"seeds{s.start}-{s.stop - 1}")
def test_random_graphs_equal_reference_in_both_domains(seeds):
    """Per seed: the same graph and input range from both packages; each
    domain's ranges equal the reference's, except on a graph where the
    reference reaches C1 — that one is checked for soundness (sampled
    executions inside the port's ranges) instead.  Every graph's port
    ranges are also held to sampled soundness."""
    c1_seeds = []
    for seed in seeds:
        n_nodes = 3 + seed % 7
        gj, irj, shape = jfuzz.random_graph(np.random.default_rng(seed),
                                            n_nodes=n_nodes)
        gt, irt, shape_t = tfuzz.random_graph(np.random.default_rng(seed),
                                              n_nodes=n_nodes)
        _same_graph(gj, gt)
        assert shape == shape_t and _same_range(irj["x"], irt["x"])
        for domain in ("interval", "affine"):
            rj = jcore.analyze(gj, irj, domain=domain)
            rt = tcore.analyze(gt, irt, domain=domain)
            assert rj.keys() == rt.keys()
            if _reaches_point_matmul(gj, rj):
                c1_seeds.append((seed, domain))
                continue
            for k in rj:
                assert _same_range(rj[k], rt[k]), (seed, domain, k)
        rep = tfuzz.check_containment(gt, irt, shape, n_samples=4,
                                      rng=np.random.default_rng(seed),
                                      name=f"seed{seed}")
        assert rep.ok, "\n".join(str(v) for v in rep.violations)
    # seeds 24 and 62 reach C1 in the affine domain (the Sub cancels a
    # MatMul's activation to a point); none of seeds 0-99 in the interval
    assert all(d == "affine" for _, d in c1_seeds), c1_seeds


@pytest.mark.parametrize("seeds", SEED_CHUNKS,
                         ids=lambda s: f"seeds{s.start}-{s.stop - 1}")
def test_random_tail_graphs_equal_reference(seeds):
    """Per seed: the same tail graph, the same ranges in both domains and
    the same converted thresholds."""
    for seed in seeds:
        gj, irj, cj = jfuzz.random_tail_graph(np.random.default_rng(seed))
        gt, irt, ct = tfuzz.random_tail_graph(np.random.default_rng(seed))
        _same_graph(gj, gt)
        assert cj == ct and _same_range(irj["x"], irt["x"])
        for domain in ("interval", "affine"):
            rj = jcore.analyze(gj, irj, domain=domain)
            rt = tcore.analyze(gt, irt, domain=domain)
            for k in rj:
                assert _same_range(rj[k], rt[k]), (seed, domain, k)
        sj, _ = jcore.convert_tails(gj.copy(), jcore.analyze(gj, irj))
        st, _ = tcore.convert_tails(gt.copy(), tcore.analyze(gt, irt))
        assert len(sj) == len(st), seed
        for a, b in zip(sj, st):
            np.testing.assert_array_equal(a.thresholds, b.thresholds)


# --------------------------------------------------------------------------
# the fuzz suites, on the reference's default seeds
# --------------------------------------------------------------------------

def test_run_fuzz_clean_on_default_seeds():
    rep = tfuzz.run_fuzz()
    assert rep.graphs == 20 + 2 * len(T_QNN)      # raw and after the flow
    assert rep.samples > 0 and rep.tensors_checked > 0
    assert rep.ok, "\n".join(str(v) for v in rep.violations[:5])


def test_run_tail_fuzz_clean_on_default_seeds():
    rep = tfuzz.run_tail_fuzz()
    assert rep.graphs >= 40 and rep.tensors_checked > 0
    assert rep.ok, "\n".join(str(v) for v in rep.violations[:5])


def test_fuzz_report_counts_equal_reference():
    """Same graphs, samples and checks as the reference's fuzzer on a
    seed whose graphs do not reach C1."""
    rj = jfuzz.run_fuzz(n_random=12, n_samples=4, seed=7, workloads=False)
    rt = tfuzz.run_fuzz(n_random=12, n_samples=4, seed=7, workloads=False)
    assert (rj.graphs, rj.samples, rj.tensors_checked) == \
        (rt.graphs, rt.samples, rt.tensors_checked)
    assert rt.ok


def test_fuzz_catches_a_lying_analyzer(monkeypatch):
    """The oracle flags an analysis that claims [-2, 0] for an input it
    samples from [-2, 2]."""
    g = Graph(inputs=["x"], outputs=["y"])
    g.add_node("Relu", ["x"], ["y"])
    wide = {"x": _rng_range((-2.0, 2.0))}
    assert tfuzz.check_containment(g, wide, (4,), n_samples=4,
                                   rng=np.random.default_rng(0)).ok
    lie = {"x": _rng_range((-2.0, 0.0)), "y": _rng_range((0.0, 0.0))}
    monkeypatch.setattr(tfuzz, "analyze",
                        lambda g_, ir_, domain="interval": dict(lie))
    rep = tfuzz.check_containment(g, wide, (4,), n_samples=8,
                                  rng=np.random.default_rng(0))
    assert not rep.ok
    assert {v.kind for v in rep.violations} >= {"interval", "affine"}


def test_tail_fuzz_catches_a_lying_certifier():
    """A certifier that always claims 'monotone increasing' tricks the
    bisection extractor into wrong thresholds; the oracle catches it."""
    from repro_torch.core.thresholds import _tail_params_channels

    def liar(g, tail, ranges):
        C = _tail_params_channels(g, tail)
        return tcore.MonotoneCertificate(
            status="monotone", method="transfer",
            direction=np.ones(C, np.int64))

    rep = tfuzz.run_tail_fuzz(n_random=25, seed=0, method="bisect",
                              certifier=liar)
    assert rep.violations
    assert all(v.kind == "tail-exact" for v in rep.violations)


def test_random_graph_is_well_formed():
    rng = np.random.default_rng(5)
    for i in range(10):
        g, in_ranges, shape = tfuzz.random_graph(rng, n_nodes=6)
        rep = tcore.lint_graph(g, in_ranges,
                               input_shapes={g.inputs[0]: shape})
        assert rep.ok, f"random graph {i}: {rep}"


# --------------------------------------------------------------------------
# C1: the MatMul transfer, pinned
# --------------------------------------------------------------------------

def _point_activation_graph(op):
    """x in [5, 6] through 3 thresholds below 5 makes t the point 3;
    y = t @ ones(4, 3) is 12 everywhere."""
    g = Graph(inputs=["x"], outputs=["y"])
    thr = g.add_initializer(np.tile([1.0, 2.0, 3.0], (4, 1)), name="thr")
    g.add_node("MultiThreshold", ["x", thr], ["t"],
               attrs=dict(axis=-1, out_scale=1.0, out_bias=0.0))
    w = g.add_initializer(np.ones((4, 3)), name="w")
    ins = ["t", w]
    if op == "Gemm":
        ins.append(g.add_initializer(np.asarray([0.0, 1.0, -1.0]),
                                     name="bias"))
    g.add_node(op, ins, ["y"])
    return g, {"x": _rng_range((5.0, 6.0))}


@pytest.mark.parametrize("domain", ["interval", "affine"])
@pytest.mark.parametrize("op", ["MatMul", "Gemm"])
def test_c1_point_activation_times_constant_is_exact(op, domain):
    g, in_r = _point_activation_graph(op)
    r = analyze(g, in_r, domain=domain)
    assert r["t"].is_point and float(np.max(r["t"].hi)) == 3.0
    y = g.execute({"x": np.full((2, 4), 5.5)})["y"]
    assert r["y"].contains(y, atol=1e-9)
    np.testing.assert_array_equal(r["y"].lo, y[0])
    np.testing.assert_array_equal(r["y"].hi, y[0])


def test_c1_point_activation_without_scaled_int_form():
    """A point that carries no integer form (real lo/hi only) goes through
    ``dot_interval`` against the constant, not through a hull."""
    g = Graph(inputs=["x"], outputs=["y"])
    w = g.add_initializer(np.asarray([[0.5, -1.0], [2.0, 0.25]]), name="w")
    g.add_node("MatMul", ["x", w], ["y"])
    r = analyze(g, {"x": _rng_range(([0.1, -0.3], [0.1, -0.3]))})["y"]
    want = np.asarray([0.1, -0.3]) @ g.initializers[w]
    np.testing.assert_allclose(r.lo, want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(r.hi, want, rtol=0, atol=1e-15)


def test_c1_dynamic_times_dynamic_takes_k_from_shapes():
    """a, b in [1, 2] with K = 8: a @ b reaches 32.  With declared input
    shapes the range holds it; without them K is unknown and the
    analysis raises, naming the node."""
    g = Graph(inputs=["a", "b"], outputs=["y"])
    g.add_node("MatMul", ["a", "b"], ["y"], name="scores")
    in_r = {"a": _rng_range((1.0, 2.0)), "b": _rng_range((1.0, 2.0))}
    shapes = {"a": (3, 8), "b": (8, 5)}
    r = analyze(g, in_r, input_shapes=shapes)["y"]
    y = g.execute({"a": np.full((3, 8), 2.0), "b": np.full((8, 5), 2.0)})
    assert r.contains(y["y"]) and float(r.hi) == 32.0 and float(r.lo) == 8.0
    assert contraction_dim(g, g.nodes[0], shapes) == 8
    with pytest.raises(ValueError, match="'scores'"):
        analyze(g, in_r)
    # K from the second operand alone: b = c + zeros(6, 2) has a known
    # shape once c's is declared; a's shape stays unknown
    g2 = Graph(inputs=["a", "c"], outputs=["y"])
    z = g2.add_initializer(np.zeros((6, 2)), name="z")
    g2.add_node("Add", ["c", z], ["b"])
    g2.add_node("MatMul", ["a", "b"], ["y"])
    r2 = analyze(g2, {"a": _rng_range((1.0, 2.0)),
                      "c": _rng_range((1.0, 2.0))},
                 input_shapes={"c": (1, 2)})["y"]
    assert float(r2.hi) == 6 * 2.0 * 2.0


@pytest.mark.parametrize("domain", ["interval", "affine"])
def test_c1_seed_2035068239_is_sound_in_the_port(domain):
    """The falsifying example of the reference's hypothesis property test:
    its affine ``Sub`` cancels ``t3`` to a point before ``t3 @ w4``."""
    rng = np.random.default_rng(2035068239)
    g, in_ranges, shape = tfuzz.random_graph(rng, n_nodes=5)
    ranges = analyze(g, in_ranges, domain=domain)
    xs = np.random.default_rng(0).uniform(
        float(in_ranges["x"].lo), float(in_ranges["x"].hi), size=(64,) + shape)
    env = g.execute({"x": xs}, record_all=True)
    for t, v in env.items():
        if not g.is_constant(t):
            assert ranges[t].contains(v, atol=1e-6), (t, domain)
    rep = tfuzz.check_containment(g, in_ranges, shape, n_samples=16, rng=rng)
    assert rep.ok, "\n".join(str(v) for v in rep.violations)
