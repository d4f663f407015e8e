"""Quickstart on the PyTorch/CUDA port: SIRA on a quantized MLP with the
SiraModel pass pipeline — analyze, streamline, threshold, minimize
accumulators, verify, all driven by one declarative build flow with a
cached range analysis — then the compiled backend on the card.

    PYTHONPATH=src python examples_torch/quickstart.py
    PYTHONPATH=src python examples_torch/quickstart.py --torch-device cpu

Twin of ``examples/quickstart.py``: the same six steps and lines.  Step 6
compiles on ``--torch-device`` (default the card, raising without one):
there the plan runs the hand-written ``quantize``, ``int_matmul`` (one
fused with its scale/bias epilogue) and ``multithreshold`` kernels; on
the CPU their plain PyTorch versions.  ``main`` returns the printed
numbers.
"""
import argparse
import time

import numpy as np

from repro_torch.core import SiraModel, build_flow, summarize
from repro_torch.core.lower import resolve_device
from repro_torch.core.workloads import make_tfc

BATCH = 32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-device", default="cuda",
                    help="where step 6 compiles and runs (default the "
                         "card; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.torch_device)

    wl = make_tfc()
    model = SiraModel.from_workload(wl)
    print(f"=== {model.name}: {len(model.graph.nodes)} nodes ===")

    # 1) SIRA analysis: ranges, scales, biases for every tensor — computed
    #    once, cached on the model, invalidated only by graph mutation
    n_si = sum(r.is_scaled_int for r in model.ranges.values())
    print(f"SIRA: {len(model.ranges)} tensors analyzed, "
          f"{n_si} scaled-integer")

    # 2) the whole optimization pipeline as one declarative flow
    #    (explicitize → aggregate → threshold → accumulators → verify),
    #    with per-step numerical-equivalence checks armed
    result = build_flow(model, verify="equivalence")
    for step in result.steps:
        print(f"  step {step.name:28s} modified={str(step.modified):5s} "
              f"analyses={step.analysis_calls} {step.seconds * 1e3:7.1f} ms")
    print(f"streamlined: {len(wl.graph.nodes)} → "
          f"{len(result.graph.nodes)} nodes, "
          f"{len(result.aggregation.erased)} scale/bias constants "
          f"aggregated, {len(result.threshold_specs)} layer tails "
          f"collapsed to MultiThreshold nodes")

    # 3) accumulator minimization (paper §4.2) — report from the flow
    reps = result.accumulator_reports
    s = summarize(reps)
    for r in reps:
        print(f"  {r.op_type} K={r.K}: SIRA {r.sira_bits}b vs "
              f"datatype-bound {r.datatype_bits}b")
    print(f"accumulators: {s['reduction_vs_datatype']:.0%} below the "
          f"datatype bound (paper: 22%)")

    # 4) empirical verification (paper §6.1) ran as the final flow step
    print(f"verification: contained={result.verification.contained} over "
          f"{len(result.verification.observed)} tensors")

    # 5) equivalence: the whole pipeline is numerically exact
    rng = np.random.default_rng(0)
    x = np.abs(rng.uniform(0, 1, size=wl.input_shape))
    y0 = wl.graph.execute({"X": x})[wl.graph.outputs[0]]
    y2 = result.graph.execute({"X": x})[result.graph.outputs[0]]
    assert np.allclose(y0, y2), "pipeline must be exact"
    print("equivalence: original == streamlined+thresholded (exact)")

    # 6) compiled backend: an eager step list on the torch device through
    #    the kernels (int_matmul with the SIRA accumulator width, fused
    #    epilogue, multithreshold, quantize), batched
    t0 = time.perf_counter()
    compiled = result.model.compile(device=device)
    xb = np.abs(rng.uniform(0, 1, size=(BATCH,) + wl.input_shape[1:]))
    yc = compiled({"X": xb})[result.graph.outputs[0]]
    compiled_s = time.perf_counter() - t0
    yi = result.graph.execute({"X": xb})[result.graph.outputs[0]]
    assert np.allclose(yc, yi, rtol=1e-5, atol=1e-5)
    print(f"compiled backend on {device}: {compiled.kernel_calls} — "
          f"matches the interpreter on a batch of {xb.shape[0]}")
    return dict(
        nodes=len(model.graph.nodes), tensors=len(model.ranges),
        scaled_int=n_si,
        step_ms={st.name: st.seconds * 1e3 for st in result.steps},
        streamlined_nodes=len(result.graph.nodes),
        aggregated=len(result.aggregation.erased),
        tails=len(result.threshold_specs),
        accumulators=[[r.op_type, r.K, r.sira_bits, r.datatype_bits]
                      for r in reps],
        reduction_vs_datatype=s["reduction_vs_datatype"],
        contained=bool(result.verification.contained),
        verified_tensors=len(result.verification.observed),
        kernel_calls=compiled.kernel_calls, batch=BATCH,
        compiled_s=compiled_s)


if __name__ == "__main__":
    main()
