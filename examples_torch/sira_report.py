"""SIRA analysis report on the PyTorch/CUDA port: accumulator widths,
layer-tail implementation choice, FPGA cost projections and the H100
kernel routes — driven by the SiraModel pass pipeline.  With
``--workload``, additionally runs the dataflow DSE subsystem and prints
the per-node resource/II/style report plus the SIRA-vs-baseline
accelerator deltas and the folding search.

    PYTHONPATH=src python examples_torch/sira_report.py --arch glm4-9b
    PYTHONPATH=src python examples_torch/sira_report.py --workload TFC-w2a2

Twin of ``examples/sira_report.py``: the same flags and lines.
``--device`` is the FPGA board the DSE prices; ``--torch-device`` (default
the card, raising without one) is where ``--trace`` compiles the model.
The reference's TPU line is replaced by the H100's: the route
``kernels/int_matmul.py`` and ``kernels/multithreshold.py`` pick for the
block's products and tails.

Observability hooks (``repro_torch.obs``): ``--trace out.json`` records
the whole report run (flow steps, range analysis, compile) as a Chrome
trace_event JSON loadable in Perfetto; ``--explain TENSOR`` prints the
range-provenance chain for a tensor of the analyzed model.

    PYTHONPATH=src python examples_torch/sira_report.py --workload CNV-w2a2 \
        --trace out.json --explain <acc-tensor>
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core import (MinimizeAccumulators, SiraModel, Streamline,
                              build_flow, summarize)
from repro_torch.core.lower import resolve_device
from repro_torch.core.workloads import ALL_WORKLOADS
from repro_torch.dataflow import (compare_sira_vs_baseline, extract_dataflow,
                                  search_folding, select_tail_style,
                                  tail_cost)
from repro_torch.kernels.int_matmul import (CUDA_CORES, TENSOR_CORES,
                                            route_for as matmul_route)
from repro_torch.kernels.multithreshold import route_for as threshold_route
from repro_torch.models.export import export_block_graph
from repro_torch.obs import enable_tracing, get_tracer, set_tracer

#: token rows of the H100 mapping's products: one 2048-token prefill
TOKENS = 2048
ROUTE_NAMES = {TENSOR_CORES: "int8 wgmma on the tensor cores",
               CUDA_CORES: "CUDA cores"}


def h100_routes(model, a_bits: int, channels: int) -> dict:
    """The kernel each integer product of ``model`` and its
    ``a_bits``-bit layer tail take on the card for ``TOKENS`` rows:
    int8 operands where both integer ranges fit [-128, 127] (the
    lowering's rule), the route ``route_for`` picks from the shape."""
    nodes = {n.name: n for n in model.graph.nodes}
    routes: dict = {}
    for r in model.metadata["accumulator_reports"]:
        x, w = nodes[r.node_name].inputs[:2]
        weight = model.graph.initializers[w]
        rx = model.ranges[x]
        in8 = (float(np.min(rx.int_lo)) >= -128
               and float(np.max(rx.int_hi)) <= 127
               and float(weight.min()) >= -128
               and float(weight.max()) <= 127)
        route = matmul_route(TOKENS, weight.shape[0], weight.shape[1],
                             torch.int8 if in8 else torch.int32)
        routes[route] = routes.get(route, 0) + 1
    n_thr = 2 ** a_bits - 1
    return dict(int_matmul=routes, multithreshold=threshold_route(
        TOKENS, channels, n_thr, torch.int32), thresholds=n_thr)


def arch_report(args) -> tuple:
    cfg = get_config(args.arch, reduced=True)
    print(f"=== SIRA report: {args.arch} (reduced block, "
          f"w{args.w_bits}a{args.a_bits}) ===")
    g, inp = export_block_graph(cfg, w_bits=args.w_bits, a_bits=args.a_bits)
    model = SiraModel(g, inp, name=args.arch).transform(
        Streamline(), MinimizeAccumulators())
    reps = model.metadata["accumulator_reports"]
    print(f"{'kernel':28s} {'K':>6s} {'SIRA':>5s} {'dtype':>6s} {'save':>6s}")
    for r in reps:
        print(f"{r.node_name:28s} {r.K:6d} {r.sira_bits:4d}b "
              f"{r.datatype_bits:5d}b {r.reduction_vs_datatype:6.0%}")
    s = summarize(reps)
    print(f"\nmean accumulator: {s['mean_sira']:.1f}b SIRA vs "
          f"{s['mean_datatype']:.1f}b datatype-bound "
          f"({s['reduction_vs_datatype']:.0%} smaller; paper avg 22%)")

    n_i = int(round(s["mean_sira"]))
    style = select_tail_style(n_i, args.a_bits, 16, cfg.d_model, 4)
    tc = tail_cost(n_i, args.a_bits, 16, cfg.d_model, 4)
    print(f"\nlayer-tail style for {args.a_bits}-bit activations: {style}")
    print(f"  thresholding: {tc.thresholding_luts:,.0f} LUTs | "
          f"composite fixed16.8: {tc.composite_luts:,.0f} LUTs")
    acc = "int16" if s["mean_sira"] <= 15 else "int32"
    h100 = h100_routes(model, args.a_bits, cfg.d_model)
    products = ", ".join(f"{ROUTE_NAMES[k]} x{v}"
                         for k, v in sorted(h100["int_matmul"].items()))
    print(f"H100 mapping ({TOKENS} token rows): accumulator dtype {acc}, "
          f"int_matmul on {products}, multithreshold tail on "
          f"{h100['multithreshold']} ({h100['thresholds']} thresholds x "
          f"{cfg.d_model} channels)")
    return model, dict(
        accumulators=[[r.node_name, r.K, r.sira_bits, r.datatype_bits]
                      for r in reps],
        mean_sira=s["mean_sira"], mean_datatype=s["mean_datatype"],
        reduction_vs_datatype=s["reduction_vs_datatype"], tail_style=style,
        thresholding_luts=tc.thresholding_luts,
        composite_luts=tc.composite_luts, accumulator_dtype=acc,
        h100=h100)


def verification_report(model) -> dict:
    """Surface the verify_ranges containment/coverage artifacts
    (``--verify``): violations, per-tensor range coverage, and channels
    SIRA proves stuck at a constant value."""
    from repro_torch.core import stuck_channels
    rep = model.metadata.get("verification")
    if rep is None:
        print("\nverification: no report (no sample inputs available)")
        return {}
    print(f"\n=== range verification ({model.domain} domain) ===")
    status = "PASS" if rep.contained else "FAIL"
    print(f"containment: {status} "
          f"({len(rep.observed)} tensors instrumented)")
    for v in rep.violations[:10]:
        print(f"  violation: {v}")
    cov = sorted(rep.coverage.items(), key=lambda kv: kv[1])
    mean_cov = None
    if cov:
        mean_cov = sum(c for _, c in cov) / len(cov)
        print(f"coverage: mean {mean_cov:.0%} of proven width observed; "
              f"loosest tensors:")
        for name, c in cov[:5]:
            lo, hi = rep.observed[name]
            print(f"  {name:28s} {c:6.1%}  observed [{lo:.4g}, {hi:.4g}]")
    n_stuck = 0
    for t in model.graph.outputs:
        if t in model.ranges:
            mask = stuck_channels(model.ranges, t)
            n_stuck += int(mask.sum())
    if n_stuck:
        print(f"stuck output channels (provably constant): {n_stuck}")
    return dict(contained=bool(rep.contained), instrumented=len(rep.observed),
                violations=len(rep.violations), mean_coverage=mean_cov,
                stuck_channels=n_stuck)


def workload_report(args) -> tuple:
    print(f"=== Dataflow DSE report: {args.workload} on {args.device} "
          f"[{args.domain} domain] ===")
    model = build_flow(ALL_WORKLOADS[args.workload](),
                       domain=args.domain).model

    reports = model.metadata.get("tail_reports", [])
    if reports:
        print("\nthreshold conversion (monotonicity certificates):")
        for r in reports:
            if r.converted:
                print(f"  {r.anchor:14s} converted  {r.status}/{r.method} "
                      f"({r.n_ops} ops -> 1 MultiThreshold)")
            else:
                print(f"  {r.anchor:14s} kept chain uncertified: "
                      f"{r.reason} -> meta-kernel pricing")

    dfg = extract_dataflow(model)
    fold = search_folding(model, target_fps=args.target_fps,
                          device=args.device, dataflow_graph=dfg)
    folding = fold.folding if fold.feasible else None
    comp = compare_sira_vs_baseline(model, device=args.device,
                                    folding=folding, dataflow_graph=dfg)
    est = comp.sira

    print(f"\n{'node':22s} {'kind':11s} {'style':13s} {'PExSIMD':>8s} "
          f"{'II':>7s} {'bits i/o/acc':>12s} {'LUT':>7s} {'DSP':>4s} "
          f"{'BRAM':>5s}")
    for n in est.nodes:
        mark = " <- bottleneck" if n.name == est.bottleneck else ""
        print(f"{n.name:22s} {n.kind:11s} {n.style:13s} "
              f"{n.pe:>4d}x{n.simd:<3d} {n.cycles:>7d} "
              f"{n.in_bits:>4d}/{n.out_bits}/{n.acc_bits:<3d} "
              f"{n.luts:>7.0f} {n.dsps:>4d} {n.brams:>5d}{mark}")
    fifo_luts = sum(f.luts for f in est.fifos)
    fifo_brams = sum(f.brams for f in est.fifos)
    print(f"{'(stream FIFOs)':22s} {'':11s} {'':13s} {'':>8s} {'':>7s} "
          f"{'':>12s} {fifo_luts:>7.0f} {'':>4s} {fifo_brams:>5d}")

    b = comp.baseline
    print("\ntotals (SIRA vs datatype-bound baseline, same folding):")
    print(f"  LUTs {b.luts:,.0f} -> {est.luts:,.0f} "
          f"(-{comp.lut_reduction:.0%}; paper -17%)")
    print(f"  DSPs {b.dsps} -> {est.dsps} "
          f"(-{comp.dsp_reduction:.0%}; paper -66%)")
    print(f"  BRAMs {b.brams} -> {est.brams}")
    print(f"  mean accumulator {comp.mean_acc_bits_datatype:.1f}b -> "
          f"{comp.mean_acc_bits_sira:.1f}b "
          f"(-{comp.acc_bits_reduction:.0%}; paper -22%)")
    print(f"  layer-tail rLUT {comp.tail_lut_ratio:.2f}")

    print(f"\nfolding search @ {args.target_fps:g} FPS on {args.device}:")
    if fold.feasible:
        util = ", ".join(f"{k} {v:.0%}"
                         for k, v in fold.utilization.items())
        print(f"  feasible — achieved {fold.achieved_fps:,.0f} FPS "
              f"({util})")
    else:
        print(f"  infeasible — binding constraint: {fold.binding}")

    out = dict(
        nodes=[[n.kind, n.style, n.pe, n.simd, n.cycles, n.in_bits,
                n.out_bits, n.acc_bits, n.luts, n.dsps, n.brams]
               for n in est.nodes],
        fifo_luts=fifo_luts, fifo_brams=fifo_brams,
        luts=[b.luts, est.luts], dsps=[b.dsps, est.dsps],
        brams=[b.brams, est.brams],
        mean_acc_bits=[comp.mean_acc_bits_datatype, comp.mean_acc_bits_sira],
        tail_lut_ratio=comp.tail_lut_ratio, feasible=bool(fold.feasible),
        achieved_fps=fold.achieved_fps if fold.feasible else None)
    if args.verify:
        out["verification"] = verification_report(model)
    return model, out


def explain_report(model, tensor: str) -> None:
    """Print the range-provenance chain for one tensor (``--explain``)."""
    print(f"\n=== range provenance: {tensor} ===")
    try:
        chain = model.explain(tensor)
    except KeyError as e:
        raise SystemExit(f"--explain: {e.args[0]}") from None
    print(chain.render())


def _resolve_workload(name: str) -> str:
    """Accept either the exact workload key or a unique prefix
    (``CNV`` -> ``CNV-w2a2``)."""
    if name in ALL_WORKLOADS:
        return name
    hits = sorted(k for k in ALL_WORKLOADS if k.startswith(name))
    if len(hits) == 1:
        return hits[0]
    raise SystemExit(f"--workload: unknown workload {name!r} "
                     f"(choices: {sorted(ALL_WORKLOADS)})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=list_archs())
    ap.add_argument("--workload", metavar="NAME",
                    help="print the dataflow DSE per-node report for a "
                         "QNN workload instead of an LM-arch report "
                         f"(choices: {sorted(ALL_WORKLOADS)}; a unique "
                         "prefix like 'CNV' is accepted)")
    ap.add_argument("--device", default="pynq-z1",
                    help="the FPGA board the DSE prices")
    ap.add_argument("--target-fps", type=float, default=1000.0)
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--a-bits", type=int, default=4)
    ap.add_argument("--domain", default="interval",
                    choices=("interval", "affine"),
                    help="range-analysis abstract domain (affine = "
                         "zonotope reduced product, tighter bounds)")
    ap.add_argument("--verify", action="store_true",
                    help="print the verify_ranges containment/coverage "
                         "report (workload reports only)")
    ap.add_argument("--trace", default=None, metavar="TRACE_JSON",
                    help="record the report run (flow/analysis/compile "
                         "spans) and write a Chrome trace_event JSON "
                         "loadable in Perfetto")
    ap.add_argument("--explain", default=None, metavar="TENSOR",
                    help="print the range-provenance chain for TENSOR "
                         "of the analyzed model")
    ap.add_argument("--torch-device", default="cuda",
                    help="where --trace compiles the model (default the "
                         "card; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.torch_device)
    if args.workload:
        args.workload = _resolve_workload(args.workload)

    # an in-process caller gets its own tracer back, whatever it was
    prev = get_tracer()
    tracer = enable_tracing() if args.trace else None
    try:
        model, out = (workload_report(args) if args.workload
                      else arch_report(args))
        if args.trace:
            # compile too, so the trace carries the backend-lowering
            # spans alongside flow/analysis — the full pipeline picture
            model.compile(device=device)
        if args.explain:
            explain_report(model, args.explain)
    finally:
        set_tracer(prev)
    if tracer is not None:
        tracer.write_chrome_trace(args.trace)
        print(f"\nwrote {args.trace} ({len(tracer.spans)} spans — open "
              f"in https://ui.perfetto.dev)")
        out["trace_spans"] = len(tracer.spans)
    return out


if __name__ == "__main__":
    main()
