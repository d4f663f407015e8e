"""The dataflow DSE of the port (``repro_torch.dataflow``, the
``core/costmodel.py`` shim and the flow's dataflow steps) against the JAX
package's (``repro``), fed the same models and numpy inputs.

* Every column of ``benchmarks/baselines/BENCH_dataflow.json`` that
  ``scripts/check_bench.py`` marks ``exact`` is equal, the ``estimate``
  and ``ratio`` columns lie within that script's bands, and every column
  (timing aside) equals the reference's ``bench_workload``, on all five
  workloads in both domains.
* Per node, the SIRA and baseline estimates equal the reference's.
* The port's twins of ``tests/test_dataflow.py`` and of the cost-model
  half of ``tests/test_workloads_and_costmodel.py``.
"""
import dataclasses
import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest

import repro.core as jcore
import repro.dataflow as jdf
from repro.core.workloads import ALL_WORKLOADS as J_WORKLOADS
import repro_torch.core as tcore
import repro_torch.dataflow as tdf
from repro_torch.core import DATAFLOW_STEPS, build_flow
from repro_torch.core.workloads import (ALL_WORKLOADS as T_WORKLOADS,
                                        WORKLOADS, make_cnv, make_tfc)
from repro_torch.dataflow import (DeviceBudget, NodeModel, SimEdge, SimNode,
                                  analytical_ii, compare_sira_vs_baseline,
                                  cycles_per_frame, estimate,
                                  extract_dataflow, fifo_depth,
                                  fifo_resources, fold_options,
                                  from_estimate, get_device, max_throughput,
                                  node_resources, search_folding,
                                  select_style, select_tail_style, simulate,
                                  widen_dataflow)
from repro_torch.dataflow.report import dataflow_flows, report_row

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_FILE = "BENCH_dataflow.json"
BASELINE = json.loads((ROOT / "benchmarks/baselines" / BENCH_FILE
                       ).read_text())
BASE_ROWS = {r["workload"]: r for r in BASELINE["results"]}


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHECK_BENCH = _load("scripts/check_bench.py", "check_bench")
BENCH_DATAFLOW = _load("benchmarks/bench_dataflow.py", "bench_dataflow")
RULES = CHECK_BENCH.RULES[BENCH_FILE]["metrics"]


@pytest.fixture(scope="module")
def models():
    """Optimized port SiraModels of the four QNN workloads."""
    return {name: build_flow(maker()).model
            for name, maker in WORKLOADS.items()}


# --------------------------------------------------------------------------
# the benchmark's columns, against the baseline and the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(T_WORKLOADS))
def test_bench_columns_equal_baseline_and_reference(name):
    flows = dataflow_flows(T_WORKLOADS[name](), device=BASELINE["device"],
                           target_fps=BASELINE["target_fps"])
    row = report_row(name, flows)
    base = BASE_ROWS[name]
    rows = [CHECK_BENCH._compare_metric(
        name, m, kind, floor, base.get(m), row.get(m),
        timing_tol=1.5, ratio_tol=0.5, estimate_tol=0.05)
        for m, (kind, floor) in RULES.items() if kind != "timing"]
    failed = [(r.metric, r.base, r.fresh, r.note) for r in rows if r.failed]
    assert not failed, failed
    for m, (kind, _) in RULES.items():
        if kind == "exact":
            assert row[m] == base[m], m
    ref = BENCH_DATAFLOW.bench_workload(name, BASELINE["device"],
                                        BASELINE["target_fps"])
    assert {k: v for k, v in row.items() if k != "seconds"} == \
        {k: v for k, v in ref.items() if k != "seconds"}
    for domain, res in flows.items():
        md = res.model.metadata
        assert md["dataflow_estimate"] is md["dataflow_report"].sira
        assert md["folding"].feasible == base["fold_feasible"], domain


def _node_fields(est):
    return [tuple(v for k, v in dataclasses.asdict(n).items() if k != "name")
            for n in est.nodes]


@pytest.mark.parametrize("domain", ["interval", "affine"])
@pytest.mark.parametrize("name", list(T_WORKLOADS))
def test_per_node_estimates_equal_reference(name, domain):
    """SIRA and baseline estimates, node by node (names aside, they come
    from a process-global counter), at the searched folding."""
    mj = jcore.build_flow(J_WORKLOADS[name](), domain=domain).model
    mt = tcore.build_flow(T_WORKLOADS[name](), domain=domain).model
    cj = jdf.compare_sira_vs_baseline(mj)
    ct = compare_sira_vs_baseline(mt)
    for side in ("sira", "baseline"):
        a, b = getattr(cj, side), getattr(ct, side)
        assert _node_fields(a) == _node_fields(b), side
        assert [(f.depth, f.width_bits, f.elems, f.luts, f.brams)
                for f in a.fifos] == \
            [(f.depth, f.width_bits, f.elems, f.luts, f.brams)
             for f in b.fifos], side
    fj = jdf.search_folding(mj, target_fps=5000.0, device="zcu104")
    ft = search_folding(mt, target_fps=5000.0, device="zcu104")
    assert (fj.feasible, fj.binding, fj.achieved_fps, fj.utilization) == \
        (ft.feasible, ft.binding, ft.achieved_fps, ft.utilization)
    assert sorted(fj.folding.values()) == sorted(ft.folding.values())


# --------------------------------------------------------------------------
# analytical II + FIFO depths vs the cycle-accurate simulator
# --------------------------------------------------------------------------

def _sized_edges(nodes, topology):
    """FIFO-size a topology as ``estimate`` does: analytical depths from
    rate imbalance and join-latency skew."""
    by = {n.name: n for n in nodes}
    ii = {n.name: n.stride * n.outputs_per_frame for n in nodes}
    producers_of = {}
    for s, d in topology:
        producers_of.setdefault(nodes[d].name, []).append(nodes[s].name)
    lat = {}
    for n in nodes:
        best = 0.0
        for p in producers_of.get(n.name, ()):
            cin = by[p].outputs_per_frame
            ipo = max(1, math.ceil(cin / n.outputs_per_frame))
            best = max(best, lat[p] + ipo * ii[p] / by[p].outputs_per_frame)
        lat[n.name] = best + n.stride
    edges = []
    for s, d in topology:
        p, c = nodes[s], nodes[d]
        arrivals = {pp: lat[pp] for pp in producers_of[c.name]}
        skew = max(arrivals.values()) - arrivals[p.name]
        cin = p.outputs_per_frame
        ipo = max(1, math.ceil(cin / c.outputs_per_frame))
        depth = fifo_depth(cin, ii[p.name], ii[c.name], ipo=ipo,
                           skew_cycles=skew)
        edges.append(SimEdge(src=p.name, dst=c.name, cin=cin,
                             cout=c.outputs_per_frame, depth=depth))
    return edges


def test_analytical_models_match_simulator_on_random_graphs():
    """On random chains and diamonds the analytically sized FIFOs never
    deadlock and the simulated cycles per frame equal the analytical
    max-node II, and equal the reference simulator's result."""
    rng = np.random.default_rng(0)
    for trial in range(60):
        if trial % 3 < 2:
            n = int(rng.integers(2, 6))
            nodes = [SimNode(f"n{i}", int(rng.integers(1, 6)),
                             int(rng.integers(1, 9))) for i in range(n)]
            topo = [(i, i + 1) for i in range(n - 1)]
        else:
            nodes = [SimNode(f"n{i}", int(rng.integers(1, 6)),
                             int(rng.integers(1, 9))) for i in range(4)]
            topo = [(0, 1), (0, 2), (1, 3), (2, 3)]
        edges = _sized_edges(nodes, topo)
        res = simulate(nodes, edges, frames=5)
        assert not res.deadlocked, (nodes, topo)
        assert res.cycles_per_frame == analytical_ii(nodes), (nodes, topo)
        for e in edges:
            assert res.max_occupancy[(e.src, e.dst)] <= e.depth
        ref = jdf.simulate(
            [jdf.SimNode(n.name, n.stride, n.outputs_per_frame)
             for n in nodes],
            [jdf.SimEdge(e.src, e.dst, e.cin, e.cout, e.depth)
             for e in edges], frames=5)
        assert (ref.deadlocked, ref.cycles_per_frame, ref.max_occupancy) \
            == (res.deadlocked, res.cycles_per_frame, res.max_occupancy)


def test_simulator_validates_real_tfc_estimate(models):
    est = estimate(models["TFC-w2a2"])
    nodes, edges = from_estimate(est)
    res = simulate(nodes, edges, frames=3)
    assert not res.deadlocked
    assert res.cycles_per_frame == est.max_cycles


def test_undersized_fifo_degrades_or_deadlocks():
    nodes = [SimNode("a", 1, 8), SimNode("b", 8, 1)]
    good = simulate(nodes, [SimEdge("a", "b", 8, 1,
                                    fifo_depth(8, 8, 8, ipo=8))], frames=5)
    assert good.cycles_per_frame == analytical_ii(nodes)
    bad = simulate(nodes, [SimEdge("a", "b", 8, 1, 1)], frames=5)
    assert bad.deadlocked or bad.cycles_per_frame > analytical_ii(nodes)


# --------------------------------------------------------------------------
# per-tail cost models (paper Fig 23, Table 4)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("channels,pe,crossover", [
    (64, 1, 7), (64, 4, 9),
    (256, 1, 5), (256, 4, 7), (256, 16, 8),
    (1024, 1, 4), (1024, 16, 7),
])
def test_fig23_crossover_pins(channels, pe, crossover):
    styles = [select_tail_style(24, n_o, 16, channels, pe)
              for n_o in range(2, 11)]
    flip = next((n_o for n_o, s in zip(range(2, 11), styles)
                 if s == "composite"), None)
    assert flip == crossover
    assert styles == sorted(styles, key=lambda s: s == "composite")


def test_select_tail_style_paper_rule_boundaries():
    assert select_tail_style(24, 3, 16, 10**6, 1) == "thresholding"
    assert select_tail_style(24, 9, 16, 1, 1) == "composite"
    assert select_tail_style(24, 2, 16, 256, 4) == "thresholding"
    assert select_tail_style(24, 10, 16, 256, 4) == "composite"
    tc = tdf.tail_cost(24, 8, 16, 512, 1)
    assert tc.composite_luts < tc.thresholding_luts


def test_tail_cost_models_equal_reference_on_a_grid():
    """Every Table-4 model and the per-tail choice give the reference's
    numbers over a grid of bitwidths, channels and PE."""
    grid = [(n_i, n_o, n_p, ch, pe) for n_i in (2, 8, 16, 24, 32)
            for n_o in (2, 4, 8, 10) for n_p in (4, 16)
            for ch in (64, 1024) for pe in (1, 4, 16)]
    args_of = {
        "lut_mul": lambda n_i, n_o, n_p, ch, pe: (n_i, n_p, pe),
        "lut_add": lambda n_i, n_o, n_p, ch, pe: (n_i, n_p, pe),
        "lut_toint": lambda n_i, n_o, n_p, ch, pe: (n_i, pe),
        "lut_max": lambda n_i, n_o, n_p, ch, pe: (n_i, pe),
        "lut_meta_kernel": lambda n_i, n_o, n_p, ch, pe: (n_i, n_p, ch, pe),
        "lut_composite_compute": lambda n_i, n_o, n_p, ch, pe: (n_i, n_p, pe),
        "lut_composite_memory": lambda n_i, n_o, n_p, ch, pe: (n_p, ch),
        "lut_composite_total": lambda n_i, n_o, n_p, ch, pe:
            (n_i, n_p, ch, pe),
        "lut_threshold_memory": lambda n_i, n_o, n_p, ch, pe: (n_i, n_o, ch),
        "lut_threshold_compute": lambda n_i, n_o, n_p, ch, pe: (n_i, n_o, pe),
        "lut_threshold_total": lambda n_i, n_o, n_p, ch, pe:
            (n_i, n_o, ch, pe),
        "n_thresholds": lambda n_i, n_o, n_p, ch, pe: (n_o, ch),
        "tail_cost": lambda *a: a,
        "select_tail_style": lambda *a: a,
    }
    for point in grid:
        for name, args in args_of.items():
            got = getattr(tdf, name)(*args(*point))
            want = getattr(jdf, name)(*args(*point))
            if dataclasses.is_dataclass(want):
                got, want = dataclasses.asdict(got), dataclasses.asdict(want)
            assert got == want, (name, point)
    assert tdf.ELEMENTWISE_COEFFS is tcore.COST_REGISTRY


def test_threshold_cost_exponential_and_composite_linear_in_bits():
    assert tdf.lut_threshold_total(16, 8, 128, 2) > \
        8 * tdf.lut_threshold_total(16, 4, 128, 2)
    assert tdf.lut_composite_total(32, 16, 128, 2) < \
        3 * tdf.lut_composite_total(16, 16, 128, 2)


def test_hbm_tail_bytes_fusion_win_and_reference_formula():
    """The fused tail moves over 4x fewer device-memory bytes than the
    unfused composite chain; the formula is the reference's
    ``tpu_tail_bytes``."""
    n = 1 << 20
    unfused = tdf.hbm_tail_bytes(n, 32, 4, 256, "composite", fused=False)
    fused = tdf.hbm_tail_bytes(n, 32, 4, 256, "thresholding")
    assert unfused > 4 * fused
    for args in [(n, 32, 4, 256, "composite", False),
                 (n, 16, 2, 64, "composite", True),
                 (1000, 24, 8, 512, "thresholding", True)]:
        assert tdf.hbm_tail_bytes(*args) == jdf.tpu_tail_bytes(*args)


# --------------------------------------------------------------------------
# per-node models
# --------------------------------------------------------------------------

def test_cycles_monotone_in_folding():
    nm = NodeModel(name="m", op_type="MatMul", kind="mvau", pixels=4,
                   channels=12, K=30)
    opts = fold_options(nm)
    assert all(nm.channels % pe == 0 and nm.K % simd == 0
               for pe, simd in opts)
    full = cycles_per_frame(nm, 1, 1)
    assert full == 4 * 12 * 30
    for pe, simd in opts:
        assert cycles_per_frame(nm, pe, simd) <= full
    assert cycles_per_frame(nm, 12, 30) == 4


def test_mvau_style_follows_bitwidths():
    narrow = NodeModel(name="n", op_type="MatMul", kind="mvau", pixels=1,
                       channels=64, K=64, in_bits=2, weight_bits=2,
                       acc_bits=12)
    wide = NodeModel(name="w", op_type="MatMul", kind="mvau", pixels=1,
                     channels=64, K=64, in_bits=8, weight_bits=8,
                     acc_bits=24)
    assert select_style(narrow) == "lut_mac"
    assert select_style(wide) == "dsp_mac"
    assert node_resources(wide, "dsp_mac", pe=4, simd=2).dsps == 4
    r16 = node_resources(
        NodeModel(name="w16", op_type="MatMul", kind="mvau", pixels=1,
                  channels=64, K=64, in_bits=16, weight_bits=16,
                  acc_bits=40), "dsp_mac", pe=4, simd=2)
    assert r16.dsps == 8


def test_fifo_resources_srl_vs_bram_cutover():
    small = fifo_resources(depth=16, width_bits=8)
    assert small.brams == 0 and small.luts > 0
    assert fifo_resources(depth=4096, width_bits=32).brams >= 1


def test_devices_equal_reference_and_unknown_raises():
    assert {k: dataclasses.asdict(v) for k, v in tdf.DEVICES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jdf.DEVICES.items()}
    with pytest.raises(KeyError, match="unknown device"):
        get_device("nonexistent-part")


# --------------------------------------------------------------------------
# SIRA against the baseline on the four QNN workloads
# --------------------------------------------------------------------------

def test_sira_reduces_resources_on_all_workloads(models):
    for name, model in models.items():
        comp = compare_sira_vs_baseline(model)
        assert comp.lut_reduction > 0, name
        assert comp.dsp_reduction > 0, name
        assert comp.acc_bits_reduction > 0, name
        assert comp.mean_acc_bits_sira < comp.mean_acc_bits_datatype, name
        assert len(comp.sira.nodes) == len(comp.baseline.nodes)
        assert [n.cycles for n in comp.sira.nodes] == \
            [n.cycles for n in comp.baseline.nodes]


def test_extract_dataflow_tfc_structure(models):
    dfg = extract_dataflow(models["TFC-w2a2"])
    kinds = [n.kind for n in dfg.nodes]
    assert kinds.count("mvau") == 3
    assert kinds.count("threshold") == 2
    assert len(dfg.edges) == len(dfg.nodes) - 1


def test_baseline_styles_are_conservative(models):
    comp = compare_sira_vs_baseline(models["TFC-w2a2"])
    assert set(comp.baseline.style_counts()) == {"dsp_mac", "composite"}
    assert "thresholding" in comp.sira.style_counts()


def test_extract_dataflow_folds_constant_weight_prep(models):
    dfg = extract_dataflow(models["CNV-w2a2"])
    mvaus = [n for n in dfg.nodes if n.kind == "mvau"]
    assert all(n.weight_bits <= 4 for n in mvaus)
    names = {n.name for n in dfg.nodes}
    assert {e.consumer for e in dfg.edges} <= names
    assert {e.producer for e in dfg.edges} <= names


# --------------------------------------------------------------------------
# folding search
# --------------------------------------------------------------------------

def test_folding_hits_target_fps_within_budget(models):
    fold = search_folding(models["TFC-w2a2"], target_fps=1000.0,
                          device="pynq-z1")
    assert fold.feasible and fold.binding is None
    assert fold.achieved_fps >= 1000.0
    assert all(v <= 1.0 for v in fold.utilization.values())
    tight = search_folding(models["TFC-w2a2"], target_fps=100_000.0,
                           device="pynq-z1")
    assert tight.feasible and tight.achieved_fps >= 100_000.0
    assert any(pe * simd > 1 for pe, simd in tight.folding.values())


def test_folding_infeasible_budget_reports_binding_resource(models):
    tiny = DeviceBudget("tiny", luts=400, dsps=1, brams=1)
    fold = search_folding(models["TFC-w2a2"], target_fps=1000.0,
                          device=tiny)
    assert not fold.feasible
    assert fold.binding in ("luts", "dsps", "brams")
    assert fold.utilization[fold.binding] > 1.0


def test_folding_infeasible_throughput_reports_binding_node():
    model = build_flow(make_cnv()).model
    fold = search_folding(model, target_fps=99e6, device="u250")
    assert not fold.feasible
    assert fold.binding.startswith("ii:")


def test_folding_search_prices_widened_nodes(models):
    model = models["TFC-w2a2"]
    dfg = extract_dataflow(model)
    wide = widen_dataflow(model, dfg)
    mvaus = [n for n in dfg.nodes if n.kind == "mvau"]
    assert mvaus and all(wide[n.name].acc_bits < 32 for n in mvaus)
    tight = search_folding(model, target_fps=100_000.0, device="pynq-z1")
    styles = {n.name: n.style for n in tight.estimate.nodes}
    assert any(styles[n.name] == "lut_mac" for n in mvaus)


def test_max_throughput_is_feasible_and_fastest(models):
    model = models["TFC-w2a2"]
    best = max_throughput(model, device="pynq-z1")
    assert best.feasible
    slow = search_folding(model, target_fps=1000.0, device="pynq-z1")
    assert best.achieved_fps >= slow.achieved_fps


def test_folding_traces_its_search():
    from repro_torch.obs.trace import Tracer, get_tracer, set_tracer
    tracer, prev = Tracer(enabled=True), get_tracer()
    set_tracer(tracer)
    try:
        search_folding(build_flow(make_tfc()).model, target_fps=1000.0)
    finally:
        set_tracer(prev)
    assert any(sp.name == "dse:search_folding" for sp in tracer.spans)
    assert tracer.counters.get("folding.candidates", 0) > 0


# --------------------------------------------------------------------------
# build-flow integration and the shim
# --------------------------------------------------------------------------

@pytest.mark.parametrize("domain", ["interval", "affine"])
def test_dataflow_flow_steps_ride_cached_analysis(domain):
    result = build_flow(make_tfc(), steps=DATAFLOW_STEPS, domain=domain,
                        target_fps=1000.0)
    report = result.model.metadata["dataflow_report"]
    assert report.lut_reduction > 0
    assert result.model.metadata["folding"].feasible
    by_name = {s.name: s for s in result.steps}
    assert by_name["DataflowEstimate"].analysis_calls == 0
    assert by_name["DataflowFold"].analysis_calls == 0
    assert not by_name["DataflowEstimate"].modified


def test_core_costmodel_shim_resolves_to_dataflow():
    from repro_torch.core import costmodel as old
    from repro_torch.dataflow import costmodel as new
    assert old.select_tail_style is new.select_tail_style
    assert old.lut_composite_total is new.lut_composite_total
    assert old.ELEMENTWISE_COEFFS is new.ELEMENTWISE_COEFFS
    assert "tail_cost" in dir(old)
    with pytest.raises(AttributeError):
        old.not_a_cost_model


def test_dataflow_exports_match_reference():
    """The port exports the reference's names, with the device-memory
    mirror under its port name."""
    want = {n for n in dir(jdf) if not n.startswith("_")} - \
        {"tpu_tail_bytes"} | {"hbm_tail_bytes"}
    have = {n for n in dir(tdf) if not n.startswith("_")}
    assert want <= have, want - have


# --------------------------------------------------------------------------
# the paper's QNN workloads (Table 5) through SIRA, as the cost models see
# them
# --------------------------------------------------------------------------

def _streamline(graph, input_ranges):
    model, _ = tcore.Streamline().apply(
        tcore.SiraModel(graph.copy(), input_ranges))
    return model.metadata["aggregation"]


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_workload_streamline_threshold_equivalence(name):
    wl = WORKLOADS[name]()
    rng = np.random.default_rng(5)
    res = _streamline(wl.graph, wl.input_range)
    g2, specs = tcore.convert_tails_to_thresholds(res.graph, wl.input_range)
    assert len(specs) >= 1
    lo = float(np.min(wl.input_range["X"].lo))
    hi = float(np.max(wl.input_range["X"].hi))
    for _ in range(3):
        x = rng.uniform(lo, hi, size=wl.input_shape)
        y0 = wl.graph.execute({"X": x})[wl.graph.outputs[0]]
        y1 = res.graph.execute({"X": x})[res.graph.outputs[0]]
        y2 = g2.execute({"X": x})[g2.outputs[0]]
        np.testing.assert_allclose(y0, y1, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(y0, y2, rtol=1e-9, atol=1e-9)


def test_accumulator_reduction_matches_paper_ballpark():
    """SIRA accumulators land 10-45% below the datatype bound on average
    and at least 50% below 32 bits, with the reference's per-layer bits."""
    bits_s, bits_d = [], []
    for name, maker in WORKLOADS.items():
        wl = maker()
        res = _streamline(wl.graph, wl.input_range)
        reps = tcore.minimize_accumulators(res.graph, wl.input_range)
        bits_s += [r.sira_bits for r in reps]
        bits_d += [r.datatype_bits for r in reps]
    red = 1 - np.mean(bits_s) / np.mean(bits_d)
    assert 0.10 <= red <= 0.45, red
    assert 1 - np.mean(bits_s) / 32.0 >= 0.5
    want = []
    for maker in jcore.workloads.WORKLOADS.values():
        wl = maker()
        model, _ = jcore.Streamline().apply(
            jcore.SiraModel(wl.graph.copy(), wl.input_range))
        want += [r.sira_bits for r in jcore.minimize_accumulators(
            model.metadata["aggregation"].graph, wl.input_range)]
    assert bits_s == want


def test_verification_and_stuck_channels():
    wl = make_cnv()
    ranges = tcore.analyze(wl.graph, wl.input_range)
    rng = np.random.default_rng(0)
    data = [{"X": rng.uniform(-1, 1, size=wl.input_shape)}
            for _ in range(4)]
    rep = tcore.verify_ranges(wl.graph, ranges, data)
    assert rep.contained, rep.violations[:3]
    quant_outs = [n.outputs[0] for n in wl.graph.nodes
                  if n.op_type == "Quant"]
    stuck = [tcore.stuck_channels(ranges, t) for t in quant_outs
             if t in ranges]
    assert stuck and all(s.dtype == bool for s in stuck)
