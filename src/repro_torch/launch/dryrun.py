"""Dry run of every (architecture x input shape x layout) cell.

Counterpart of ``src/repro/launch/dryrun.py``, which compiles each cell
over 512 fake XLA devices and counts what the compiled program does
(``roofline/hlo_cost.py``).  The port has no compiler to ask: each cell's
program is run once on ``meta`` tensors (shapes, no data: nothing is
computed or allocated) through the entry points ``--measure`` runs, as
rank 0 of the layout runs it, and counted (``roofline/op_cost.py``):

* a prefill: ``Model.forward`` of one device's share of the batch;
* a decode: ``Model.decode_step`` against a cache as deep as the cell;
* a training step: ``train/train_step.py make_train_step``'s step on the
  global batch (the rank's rows of each microbatch), with ``remat``, the
  gradient reductions, AdamW and the ZeRO all-gather.

The model is the cell's architecture split over the layout's "model"
axis (``Model.shard``) on a recording layout (``launch/mesh.py
make_recording_layout``), whose collectives record through the counter a
real run fills.  ``cost`` (FLOPs, HBM bytes, launches), ``collectives``
and ``roofline`` (``roofline/analysis.py``, the H100's peaks) come from
that count; ``by_op`` and ``by_scope`` say per ATen op or kernel and per
layer where the FLOPs, the bytes and the launches go.  ``predicted``
holds ``roofline/cost.py``'s figures (a model of the code from its
shapes) and the ratios of counted to predicted FLOPs, bytes and
collective bytes, so that a model that drifts from its code shows.  The
resident bytes (``memory``) are ``cost.py``'s.  A layout that the port's
tensor parallelism refuses (``launch/shardings.py
check_tensor_parallel``) runs no program: such a cell keeps the
prediction and says so in its ``note``.  The cells and
``cell_applicable``'s skips are the reference's; the production layouts
are an H100 cluster's, (32, 8) and (2, 32, 8) (``launch/mesh.py``).  One
JSON ``CellResult`` per cell:
experiments/dryrun/<arch>__<shape>__<layout>.json.

``--measure`` (a card is required) also runs the cell's per-device share
through the same entry points (``launch.train.run`` for a training step)
where one card holds it (a layout with model = 1; ``--batch`` and
``--seq`` cut the cell), and reports the measured seconds, the peak
device memory and the real parameter and optimizer bytes beside the
prediction, the measured time's share of the counted roofline bound and
the model-FLOP utilisation.

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
import functools
import json
import os
import resource
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
from ..roofline.op_cost import PRODUCT_OPS, Totals, analyze_program
from ..core.lower import resolve_device
from .mesh import make_layout, make_production_layout, \
    make_recording_layout

#: the reason of a cell whose count fails on packed MoE experts
FAULT_9 = ("reference fault 9 (ROADMAP C): packed int8 MoE experts run in "
           "neither package; the port's apply_moe raises TypeError at "
           "torch.bmm (models/moe.py), the reference's AttributeError "
           "(src/repro/models/moe.py:67)")


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
    counted: bool = False             # cost/collectives/roofline counted
    predicted: Dict[str, Any] = dataclasses.field(default_factory=dict)
    by_op: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    by_scope: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    #: the hand-written kernels' counted launches, per kernel and per
    #: "<kernel>:<route>" (``kernels/_build.py LAUNCH_COUNTS``'s keys)
    kernel_launches: Dict[str, int] = dataclasses.field(
        default_factory=dict)


def parse_layout(text: str):
    """"32x8" or "2x32x8" → a layout of that shape."""
    return make_layout(tuple(int(n) for n in text.split("x")))


class NotCounted(Exception):
    """The port runs no program for this cell on this layout."""


def _per_device_batch(shape: ShapeCell, layout) -> int:
    return -(-shape.global_batch // layout.size(("pod", "data")))


def _train_microbatches(shape: ShapeCell, layout, microbatches: int
                        ) -> int:
    """``microbatches``, or the most that still give each data rank whole
    rows of every microbatch (the train step's rule)."""
    dp = layout.size(("pod", "data"))
    B = shape.global_batch
    return max(n for n in range(1, microbatches + 1)
               if B % n == 0 and (B // n) % dp == 0) \
        if B % dp == 0 else microbatches


@functools.lru_cache(maxsize=256)
def _trace(cfg, shape: ShapeCell, layout_shape, axis_names, *,
           microbatches: int, remat: bool, quant_bits: int,
           int8_weights: bool, int8_kv: bool) -> Totals:
    from .shardings import check_tensor_parallel
    from ..models.convert import ParamTree
    from ..models.transformer import Model
    from ..quant.quantizer import QuantSpec, pack_weights_int8
    layout = make_recording_layout(layout_shape, axis_names)
    try:
        check_tensor_parallel(cfg, layout)
    except ValueError as e:
        raise NotCounted(str(e)) from None
    meta = torch.device("meta")
    whole = Model(cfg, meta)
    tree = whole.init_shapes()
    if int8_weights:
        tree = pack_weights_int8(tree, cfg=cfg)
    whole.params = ParamTree(tree)
    model = whole.shard(layout)
    quant = QuantSpec(bits=quant_bits) if quant_bits else None
    front = cfg.frontend_len or {"patch": 256, "frame": 64}.get(
        cfg.frontend, 0)
    S = shape.seq_len

    def tokens(B, n):
        return torch.zeros((B, n), dtype=torch.long, device=meta)

    def frontend(B):
        return torch.zeros((B, front, cfg.d_model), dtype=cfg.dtype,
                           device=meta) if front else None
    if shape.kind == "train":
        from ..optim import AdamW
        from ..train import init_train_state, make_train_step
        opt = AdamW()
        state = init_train_state(model, opt, 0, params=model.param_tree())
        step = make_train_step(model, opt, microbatches=microbatches,
                               quant=quant, remat=remat)
        B = shape.global_batch
        batch = dict(tokens=tokens(B, S), labels=tokens(B, S))
        if front:
            batch["frontend_embed"] = frontend(B)
        return analyze_program(step, state, batch, layout=layout)
    b = _per_device_batch(shape, layout)
    with torch.inference_mode():
        if shape.kind == "prefill":
            return analyze_program(model, tokens(b, S), frontend(b),
                                   quant=quant, layout=layout)
        cache = model.init_cache(b, S, kv_dtype=torch.int8 if int8_kv
                                 else None)
        return analyze_program(model.decode_step, tokens(b, 1), cache,
                               S - 1, quant=quant, layout=layout)


def trace_cell(cfg, shape: ShapeCell, layout, *, microbatches: int = 8,
               remat: bool = True, quant_bits: int = 0,
               int8_weights: bool = False, int8_kv: bool = False
               ) -> Totals:
    """The count (``roofline/op_cost.py``) of rank 0's program for one
    cell under ``layout``'s shape; raises :class:`NotCounted` where the
    port's tensor parallelism refuses the layout.  The last 256 counts
    are cached (a count is deterministic): callers must not change the
    result."""
    return _trace(cfg, shape, tuple(layout.shape), tuple(layout.axis_names),
                  microbatches=microbatches, remat=remat,
                  quant_bits=quant_bits, int8_weights=int8_weights,
                  int8_kv=int8_kv)


def counted_cost(t: Totals) -> Dict[str, float]:
    """The reference's cost dict ("flops", "bytes accessed") of a count,
    with its launches and its FLOPs split into products, the hand-written
    kernels and the rest."""
    products = t.flops_of(PRODUCT_OPS)
    kernels = t.flops_of(t.kernels)       # the wrappers' calls
    return {"flops": t.flops, "bytes accessed": t.bytes,
            "launches": float(t.total_launches),
            "product_flops": products, "kernel_flops": kernels,
            "other_flops": t.flops - products - kernels,
            "kernel_launches": float(sum(t.kernels.values()))}


def _colls(stats) -> Dict[str, Any]:
    return dict(counts=stats.counts, operand_bytes=stats.operand_bytes,
                wire_bytes=stats.wire_bytes,
                cross_pod_bytes=stats.cross_pod_bytes,
                internode_bytes=stats.internode_bytes)


def _ratio(a: float, b: float) -> Optional[float]:
    return a / b if b else None


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             microbatches: int = 8, quant_bits: int = 0,
             zero2: bool = False, remat: bool = True,
             int8_weights: bool = False, int8_kv: bool = False,
             capacity_factor: float = 0.0, *, layout=None,
             shape: Optional[ShapeCell] = None) -> CellResult:
    """Count one cell.  ``layout`` (default: the production one) and
    ``shape`` (default: ``SHAPES[shape_name]``) may be given to cost a
    cell cut to one card.  ``zero2`` changes nothing (the optimizer state
    is always ZeRO-split over "data")."""
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

    def roofline(cost, stats):
        return roofline_from(cost, stats, layout.n_devices, mf, NVLINK_BW,
                             peak_flops=PEAK_FLOPS[_dtype(cfg)],
                             hbm_bw=HBM_BW, internode_bw=INTERNODE_BW)
    predicted = dict(cost=c.cost(), collectives=_colls(c.collectives),
                     roofline=roofline(c.cost(), c.collectives).to_dict())
    res = CellResult(arch, shape_name, layout.name, ok=True,
                     memory=c.memory(), cost=c.cost(),
                     collectives=predicted["collectives"],
                     roofline=predicted["roofline"], note=c.note,
                     predicted=predicted)
    mb = microbatches
    notes = [c.note] if c.note else []
    if shape.kind == "train":
        mb = _train_microbatches(shape, layout, microbatches)
        if mb != microbatches:
            notes.append(f"counted at {mb} microbatches: {microbatches} "
                         f"leave a data rank no whole row of each")
    try:
        t = trace_cell(cfg, shape, layout, microbatches=mb, remat=remat,
                       quant_bits=quant_bits, int8_weights=int8_weights,
                       int8_kv=int8_kv)
    except NotCounted as e:
        notes.append(f"not counted, the port runs no program here "
                     f"({e}): cost, collectives and roofline are "
                     f"predicted")
    except Exception as e:
        reason = traceback.format_exc()[-2000:]
        if isinstance(e, TypeError) and int8_weights and \
                cfg.moe.n_experts:
            reason = FAULT_9 + "\n" + reason
        res.ok, res.reason = False, reason
        res.compile_s = time.time() - t0
        return res
    else:
        res.counted = True
        res.cost = counted_cost(t)
        res.collectives = _colls(t.collectives)
        res.roofline = roofline(res.cost, t.collectives).to_dict()
        # copies: the count is cached and shared
        res.by_op = {k: dict(v) for k, v in t.by_op.items()}
        res.by_scope = {k: dict(v) for k, v in t.by_scope.items()}
        res.kernel_launches = t.kernel_launches()
        pc = predicted["collectives"]["operand_bytes"]
        predicted["ratio"] = dict(
            flops=_ratio(t.flops, c.flops),
            bytes=_ratio(t.bytes, c.bytes),
            collective_bytes=_ratio(sum(t.collective_bytes.values()),
                                    sum(pc.values())))
    res.note = "; ".join(notes)
    res.compile_s = time.time() - t0
    return res


def _dtype(cfg) -> str:
    return str(cfg.dtype).replace("torch.", "")


# ------------------------------------------------------------ --measure

def measure_cell(res: CellResult, shape: ShapeCell, layout, *,
                 microbatches: int = 8, remat: bool = True,
                 reps: int = 3, steps: int = 6, warm: int = 3,
                 seed: int = 0, device=None) -> Dict[str, Any]:
    """Run ``res``'s cell (one device's share: ``layout`` must have
    model = 1) on the card (``device=None``: raises without one) and
    compare with the prediction and the count: ``kernel_launches`` are
    the hand-written kernels' launches of one call (of one step: the
    run's over its steps)."""
    from ..kernels import _build
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
        before = dict(_build.LAUNCH_COUNTS)
        out = trainer.run(["--arch", res.arch, "--steps", str(steps),
                           "--batch", str(b), "--seq", str(S),
                           "--microbatches", str(microbatches),
                           "--device", str(dev), "--log-every", str(steps)])
        meas = dict(seconds=statistics.median(out.step_seconds[warm:]),
                    what=f"seconds per step, median of steps "
                         f"{warm}-{steps - 1}",
                    kernel_launches=_per_call(before, steps))
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
            before = dict(_build.LAUNCH_COUNTS)
            call()
            launches = _per_call(before, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                call()
            torch.cuda.synchronize()
        meas = dict(seconds=(time.perf_counter() - t0) / reps,
                    what=f"host clock over {reps} calls after a warm one, "
                         f"ended by a synchronize",
                    kernel_launches=launches)
        meas["param_bytes"] = sum(t.numel() * t.element_size()
                                  for t in model.params.parameters())
        del model
    meas["peak_bytes"] = torch.cuda.max_memory_allocated()
    meas["card"] = torch.cuda.get_device_name(0)
    return compare(res, meas, layout.n_devices)


def _per_call(before: Dict[str, int], calls: int) -> Dict[str, float]:
    """The kernels' launches since ``before`` (a copy of
    ``LAUNCH_COUNTS``), per call."""
    from ..kernels import _build
    return {k: (v - before.get(k, 0)) / calls
            for k, v in _build.LAUNCH_COUNTS.items()
            if v != before.get(k, 0)}


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
    has of ``param_bytes``, ``opt_bytes``, ``peak_bytes``,
    ``kernel_launches``) beside the cell: bytes, the roofline's bound (of
    the count, where the cell is counted) and its share of the measured
    time, the model-FLOP utilisation (the share's model FLOPs over
    measured seconds x the H100's bf16 peak), and whether the
    hand-written kernels' launches equal the count's."""
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
    if "kernel_launches" in meas and res.counted:
        out["traced_kernel_launches"] = dict(res.kernel_launches)
        out["kernel_launches_equal"] = meas["kernel_launches"] == {
            k: float(v) for k, v in res.kernel_launches.items()}
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
    t_start = time.perf_counter()

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
                    extra += (f" launches={res.cost['launches']:.0f}"
                              if res.counted else " predicted")
                    if res.measured:
                        extra += (f" measured={res.measured['seconds']:.4f}s"
                                  f" bound_share="
                                  f"{res.measured['bound_share']:.3f} mfu="
                                  f"{res.measured['mfu']:.3f}")
                print(f"[{status}] {tag}{extra}", flush=True)
                if not res.ok and not res.skipped:
                    head, _, tail = res.reason.partition("\n")
                    print(head[:600] + "\n" + tail[-600:], flush=True)
    n_ok = sum(r.ok for r in results)
    n_skip = sum(r.skipped for r in results)
    print(f"\n{n_ok} ok, {n_skip} skipped, "
          f"{len(results) - n_ok - n_skip} failed / {len(results)} cells "
          f"in {time.perf_counter() - t_start:.1f} s, peak RSS "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024:.0f}"
          f" MiB")
    return results


if __name__ == "__main__":
    main()
