"""Dry run of every (architecture x input shape x layout) cell.

Counterpart of ``src/repro/launch/dryrun.py``, which compiles each cell
over 512 fake XLA devices and reads XLA's memory and cost analyses.  The
port has no compiler to ask: each cell is costed from the model code's
shapes alone (``roofline/cost.py`` over ``Model.init_shapes``, a tree of
``meta`` tensors cut to one device's blocks), with nothing allocated, and
the roofline divides by the H100's peaks (``roofline/analysis.py``).
The cells and ``cell_applicable``'s skips are the reference's; the
production layouts are an H100 cluster's, (32, 8) and (2, 32, 8)
(``launch/mesh.py``).  One JSON ``CellResult`` per cell:
experiments/dryrun/<arch>__<shape>__<layout>.json.

``--measure`` (a card is required) also runs the cell's per-device share
through the normal entry points — ``Model.forward`` for a prefill,
``Model.decode_step`` for a decode, ``launch.train.run`` for a training
step — where one card holds it (a layout with model = 1; ``--batch`` and
``--seq`` cut the cell), and reports the measured seconds, the peak
device memory and the real parameter and optimizer bytes beside the
prediction, the measured time's share of the roofline bound and the
model-FLOP utilisation.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape decode_32k --mesh pod          # one cell, the 32x8 layout
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape prefill_32k --layout 1x1 --batch 1 --measure
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape train_4k --layout 4x2 --batch 8 --seq 2048   # a cut cell

``--layout`` costs one layout of any shape instead of ``--mesh``'s,
``--batch`` and ``--seq`` replace the cell's global batch and sequence
length.  ``main`` returns the ``CellResult`` list.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from ..configs import (SHAPES, ShapeCell, cell_applicable, get_config,
                       list_archs)
from ..roofline.analysis import (HBM_BW, INTERNODE_BW, NVLINK_BW,
                                 PEAK_FLOPS, mfu, model_flops_for,
                                 roofline_from)
from ..roofline.cost import cell_cost
from ..core.lower import resolve_device
from .mesh import make_layout, make_production_layout


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    skipped: bool = False
    reason: str = ""
    compile_s: float = 0.0            # seconds the costing took
    memory: Dict[str, float] = dataclasses.field(default_factory=dict)
    cost: Dict[str, float] = dataclasses.field(default_factory=dict)
    collectives: Dict[str, Any] = dataclasses.field(default_factory=dict)
    roofline: Dict[str, float] = dataclasses.field(default_factory=dict)
    note: str = ""
    measured: Dict[str, Any] = dataclasses.field(default_factory=dict)


def parse_layout(text: str):
    """"32x8" or "2x32x8" → a layout of that shape."""
    return make_layout(tuple(int(n) for n in text.split("x")))


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             microbatches: int = 8, quant_bits: int = 0,
             zero2: bool = False, remat: bool = True,
             int8_weights: bool = False, int8_kv: bool = False,
             capacity_factor: float = 0.0, *, layout=None,
             shape: Optional[ShapeCell] = None) -> CellResult:
    """Cost one cell.  ``layout`` (default: the production one) and
    ``shape`` (default: ``SHAPES[shape_name]``) may be given to cost a
    cell cut to one card.  ``quant_bits`` and ``zero2`` change nothing
    that is counted here (fake-quant's elementwise work is not, and the
    optimizer state is always ZeRO-split over "data")."""
    cfg = get_config(arch)
    if capacity_factor and cfg.moe.n_experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    shape = shape or SHAPES[shape_name]
    layout = layout or make_production_layout(multi_pod=multi_pod)
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        return CellResult(arch, shape_name, layout.name, ok=False,
                          skipped=True, reason=reason)
    t0 = time.time()
    try:
        c = cell_cost(cfg, shape, layout, microbatches=microbatches,
                      remat=remat, int8_weights=int8_weights,
                      int8_kv=int8_kv)
    except Exception:
        return CellResult(arch, shape_name, layout.name, ok=False,
                          reason=traceback.format_exc()[-2000:],
                          compile_s=time.time() - t0)
    mf = model_flops_for(cfg, shape, shape.kind)
    rl = roofline_from(c.cost(), c.collectives, layout.n_devices, mf,
                       NVLINK_BW, peak_flops=PEAK_FLOPS[_dtype(cfg)],
                       hbm_bw=HBM_BW, internode_bw=INTERNODE_BW)
    mem = c.memory()
    colls = c.collectives
    return CellResult(
        arch, shape_name, layout.name, ok=True,
        compile_s=time.time() - t0, memory=mem, cost=c.cost(),
        collectives=dict(counts=colls.counts,
                         operand_bytes=colls.operand_bytes,
                         wire_bytes=colls.wire_bytes,
                         cross_pod_bytes=colls.cross_pod_bytes,
                         internode_bytes=colls.internode_bytes),
        roofline=rl.to_dict(), note=c.note)


def _dtype(cfg) -> str:
    return str(cfg.dtype).replace("torch.", "")


# ------------------------------------------------------------ --measure

def measure_cell(res: CellResult, shape: ShapeCell, layout, *,
                 microbatches: int = 8, remat: bool = True,
                 reps: int = 3, steps: int = 6, warm: int = 3,
                 seed: int = 0, device=None) -> Dict[str, Any]:
    """Run ``res``'s cell (one device's share: ``layout`` must have
    model = 1) on the card (``device=None``: raises without one) and
    compare with the prediction."""
    dev = resolve_device(device)
    if layout.size("model") != 1:
        raise ValueError("--measure runs one device's share on one card: "
                         "the layout's model axis must be 1")
    cfg = get_config(res.arch)
    b = -(-shape.global_batch // layout.size(("pod", "data")))
    S = shape.seq_len
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if shape.kind == "train":
        if remat:
            raise ValueError("launch.train steps without remat: cost the "
                             "cell with remat=False (--no-remat)")
        from . import train as trainer
        out = trainer.run(["--arch", res.arch, "--steps", str(steps),
                           "--batch", str(b), "--seq", str(S),
                           "--microbatches", str(microbatches),
                           "--device", str(dev), "--log-every", str(steps)])
        meas = dict(seconds=statistics.median(out.step_seconds[warm:]),
                    what=f"seconds per step, median of steps "
                         f"{warm}-{steps - 1}")
        meas.update(state_bytes(out.state))
        del out
    else:
        from ..models import get_model
        model = get_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(seed))
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        toks = torch.randint(0, cfg.vocab, (b, S if shape.kind == "prefill"
                                            else 1), generator=gen,
                             device=dev)
        with torch.inference_mode():
            if shape.kind == "prefill":
                def call():
                    return model(toks)
            else:
                cache = model.init_cache(b, S)

                def call():
                    return model.decode_step(toks, cache, S - 1)
            call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        meas = dict(seconds=(time.perf_counter() - t0) / reps,
                    what=f"host clock over {reps} calls after a warm one, "
                         f"ended by a synchronize")
        meas["param_bytes"] = sum(t.numel() * t.element_size()
                                  for t in model.params.parameters())
        del model
    meas["peak_bytes"] = torch.cuda.max_memory_allocated()
    meas["card"] = torch.cuda.get_device_name(0)
    return compare(res, meas, layout.n_devices)


def state_bytes(state) -> Dict[str, int]:
    """Bytes of a train state's params and optimizer state."""
    from ..tree import leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree)
                   if t is not None)
    return dict(param_bytes=nbytes(state.params),
                opt_bytes=nbytes(state.opt))


def compare(res: CellResult, meas: Dict[str, Any],
            n_devices: int = 1) -> Dict[str, Any]:
    """A measurement of one device's share (``seconds``, and what it
    has of ``param_bytes``, ``opt_bytes``, ``peak_bytes``) beside the
    prediction: bytes, the roofline's bound and its share of the measured
    time, and the model-FLOP utilisation (the share's model FLOPs over
    measured seconds x the H100's bf16 peak)."""
    rl = res.roofline
    bound_s = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
    out = dict(meas)
    out.update(
        predicted_param_bytes=res.memory["param_bytes"],
        predicted_opt_bytes=res.memory["opt_bytes"],
        predicted_peak_bytes=res.memory["predicted_peak_bytes"],
        compute_s=rl["compute_s"], memory_s=rl["memory_s"],
        collective_s=rl["collective_s"], bound_s=bound_s,
        bottleneck=rl["bottleneck"],
        bound_share=bound_s / meas["seconds"],
        mfu=mfu(rl["model_flops"], meas["seconds"], n_devices))
    if "param_bytes" in meas:
        out["param_bytes_equal"] = int(meas["param_bytes"]) == int(
            res.memory["param_bytes"])
    if "opt_bytes" in meas:
        out["opt_bytes_equal"] = int(meas["opt_bytes"]) == int(
            res.memory["opt_bytes"])
    res.measured = out
    return out


# -------------------------------------------------------------------- CLI

def main(argv=None) -> List[CellResult]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--quant-bits", type=int, default=0)
    ap.add_argument("--int8-weights", action="store_true")
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--attn-p-bf16", action="store_true",
                    help="accepted for the reference's CLI: the port's "
                         "16-bit attention always rounds P")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--layout", default=None,
                    help="e.g. 1x1 or 4x2 instead of --mesh's layouts")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch instead of the cell's")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length instead of the cell's")
    ap.add_argument("--measure", action="store_true",
                    help="also run the cell on the card (model = 1)")
    args = ap.parse_args(argv)

    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    if args.layout:
        layouts = [parse_layout(args.layout)]
    else:
        layouts = [make_production_layout(multi_pod=mp) for mp in
                   {"pod": [False], "multipod": [True],
                    "both": [False, True]}[args.mesh]]

    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch in archs:
        for shape_name in shapes:
            base = SHAPES[shape_name]
            shape = dataclasses.replace(
                base, global_batch=args.batch or base.global_batch,
                seq_len=args.seq or base.seq_len)
            for layout in layouts:
                tag = f"{arch}__{shape_name}__{layout.name}"
                res = run_cell(arch, shape_name,
                               microbatches=args.microbatches,
                               quant_bits=args.quant_bits,
                               remat=not args.no_remat,
                               int8_weights=args.int8_weights,
                               int8_kv=args.int8_kv,
                               capacity_factor=args.capacity_factor,
                               layout=layout, shape=shape)
                if args.measure and res.ok:
                    measure_cell(res, shape, layout,
                                 microbatches=args.microbatches,
                                 remat=not args.no_remat)
                results.append(res)
                path = os.path.join(args.out, tag + ".json")
                with open(path, "w") as f:
                    json.dump(dataclasses.asdict(res), f, indent=1)
                status = ("SKIP" if res.skipped else
                          "OK" if res.ok else "FAIL")
                extra = ""
                if res.ok:
                    rl = res.roofline
                    extra = (f" mem={res.memory['total_per_device_gb']:.2f}"
                             f"GB bottleneck={rl['bottleneck']}")
                    if res.measured:
                        extra += (f" measured={res.measured['seconds']:.4f}s"
                                  f" bound_share="
                                  f"{res.measured['bound_share']:.3f} mfu="
                                  f"{res.measured['mfu']:.3f}")
                print(f"[{status}] {tag}{extra}", flush=True)
                if not res.ok and not res.skipped:
                    print(res.reason[-600:], flush=True)
    n_ok = sum(r.ok for r in results)
    n_skip = sum(r.skipped for r in results)
    print(f"\n{n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} failed / {len(results)} cells")
    return results


if __name__ == "__main__":
    main()
