"""Accumulator-aware QAT on the PyTorch/CUDA port: train a small QNN
under an accumulator-bit budget (A2Q/A2Q+ projection,
``repro_torch.qat``), then run the trained weights through SIRA + the
dataflow DSE and print the proven-bits / resource report — the paper
stack's train -> analyze -> optimize -> price loop in one command.

    PYTHONPATH=src python examples_torch/train_qat.py
    PYTHONPATH=src python examples_torch/train_qat.py --budget 12
    PYTHONPATH=src python examples_torch/train_qat.py --budget 12 --zero-center
    PYTHONPATH=src python examples_torch/train_qat.py --budget 0      # off
    PYTHONPATH=src python examples_torch/train_qat.py --torch-device cpu

Twin of ``examples/train_qat.py``: the same flags, defaults and lines.
``--device`` is the FPGA board the DSE prices; ``--torch-device``
(default the card, raising without one) is where the model trains.
``main`` returns the printed numbers and every step's loss.
"""
import argparse

from repro_torch.core.lower import resolve_device
from repro_torch.dataflow import compare_sira_vs_baseline
from repro_torch.qat import (QATConfig, check_budget_invariant,
                             proven_layer_bits, run_qat)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=14,
                    help="target accumulator bits per layer "
                         "(0 = unconstrained)")
    ap.add_argument("--zero-center", action="store_true",
                    help="A2Q+ zero-centering variant (asymmetric caps; "
                         "roughly 2x the feasible weight mass)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--hidden", type=int, nargs="+", default=[32, 32])
    ap.add_argument("--weight-bits", type=int, default=4)
    ap.add_argument("--act-bits", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="pynq-z1",
                    help="the FPGA board the DSE prices")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint/resume directory (optional)")
    ap.add_argument("--torch-device", default="cuda",
                    help="where the model trains (default the card; 'cpu' "
                         "runs on the CPU)")
    return ap.parse_args(argv)


def train(args, model=None):
    """Train the run ``args`` set on ``model`` when one is given, else on
    the config's own model on ``--torch-device``; print the run's lines
    and return its ``QATResult``."""
    device = resolve_device(args.torch_device)
    cfg = QATConfig(budget=args.budget, zero_center=args.zero_center,
                    steps=args.steps, hidden=tuple(args.hidden),
                    weight_bits=args.weight_bits, act_bits=args.act_bits,
                    seed=args.seed, ckpt_dir=args.ckpt_dir)
    tag = (f"budget {args.budget}b"
           + (" + zero-center" if args.zero_center else "")
           if args.budget else "unconstrained")
    print(f"=== accumulator-aware QAT: {tag}, "
          f"w{cfg.weight_bits}a{cfg.act_bits}, {cfg.steps} steps ===")
    res = run_qat(cfg, model=model, device=device)
    if res.resumed_from:
        print(f"resumed from step {res.resumed_from}")
    print(f"task loss {res.losses[0]:.4f} -> {res.final_loss:.4f}")
    return res


def report(args, model, params) -> dict:
    """Prove ``params`` of the QAT ``model`` with SIRA (and check the
    budget where there is one), price it with the dataflow DSE; print
    the report and return its numbers."""
    result, bits = proven_layer_bits(model, params)
    budgets = model.budgets()
    print(f"\n{'layer':12s} {'K':>5s} {'budget':>7s} {'proven':>7s}")
    for i, (b, budget) in enumerate(zip(bits, budgets)):
        k = model.layer_dims[i][0]
        tgt = f"{budget.bits}b" if budget else "-"
        print(f"l{i}_matmul    {k:5d} {tgt:>7s} {b:6d}b")
    if args.budget:
        check_budget_invariant(model, params, bits)
        print("A2Q invariant holds: proven bits <= budget on every layer")

    comp = compare_sira_vs_baseline(result.model, device=args.device)
    b = comp.baseline
    print(f"\nDSE on {args.device} (SIRA vs datatype-bound baseline):")
    print(f"  LUTs {b.luts:,.0f} -> {comp.sira.luts:,.0f} "
          f"(-{comp.lut_reduction:.0%})")
    print(f"  DSPs {b.dsps} -> {comp.sira.dsps} "
          f"(-{comp.dsp_reduction:.0%})")
    print(f"  mean accumulator {comp.mean_acc_bits_datatype:.1f}b -> "
          f"{comp.mean_acc_bits_sira:.1f}b")
    return dict(
        proven_bits=list(bits),
        budgets=[budget.bits if budget else None for budget in budgets],
        invariant_checked=bool(args.budget),
        luts=[b.luts, comp.sira.luts], dsps=[b.dsps, comp.sira.dsps],
        mean_acc_bits=[comp.mean_acc_bits_datatype,
                       comp.mean_acc_bits_sira])


def main(argv=None) -> dict:
    args = parse_args(argv)
    res = train(args)
    return dict(resumed_from=res.resumed_from, losses=list(res.losses),
                first_loss=res.losses[0], final_loss=res.final_loss,
                **report(args, res.model, res.state.params))


if __name__ == "__main__":
    main()
