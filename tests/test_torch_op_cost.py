"""``roofline/op_cost.py``: the port's own program counted on ``meta``
tensors, on the CPU.

(a) the mirrors of ``tests/test_hlo_cost.py``: a loop of products counts
    each product exactly (and agrees with the reference's
    ``analyze_hlo`` of the same function within that test's 5%), nested
    loops multiply, a write into a slice of a (64, 32, 32) buffer counts
    the slice, views count nothing;
(b) on every reduced config, the product FLOPs the count gives a
    prefill, a decode step and a training step (two microbatches,
    ``remat``) equal ``roofline/cost.py``'s and
    ``torch.utils.flop_counter``'s on the CPU run of the same program
    (whose attention is stubbed where the card runs the flash kernel:
    the kernel's work is no ATen product);
(c) the reduced qwen2-1.5b forward against the reference's
    ``analyze_hlo`` count of its compiled forward: the reference's
    attention scan covers every key block, the port's kernel only the
    causal pairs, so the count plus the pairs above the diagonal must
    lie below the reference's by at most 8 FLOPs a score (the softmax's
    elementwise work inside the reference's scan, which the port's one
    kernel launch does not count as FLOPs);
(d) TFC-w2a2 and CNV-w2a2 at batch 256 launch each kernel as often as
    ``chip_smoke.expected_launches`` reads from the plan;
(e) a count builds and launches nothing, and a ``meta`` tensor reaching a
    wrapper outside a count raises;
plus the dry run's use of the count: its figures, the ``predicted``
ratios, the per-layer scopes (``obs`` spans; the backward by autograd
node) and the recording layout; the kernels' work is computed under a
count only, and ``visible_pairs``'s closed form.
"""
import dataclasses
import importlib
import json
import pathlib
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.roofline.hlo_cost import analyze_hlo
from repro_torch.configs import ShapeCell, get_config, list_archs
from repro_torch.core import build_flow
from repro_torch.core.lower import lower
from repro_torch.core.workloads import WORKLOADS
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_layout, make_recording_layout
from repro_torch.models import attention as t_attn
from repro_torch.models import get_model
from repro_torch.optim import AdamW
from repro_torch.roofline.cost import cell_cost
from repro_torch.obs.trace import get_tracer
from repro_torch.roofline.op_cost import PRODUCT_OPS, analyze_program
from repro_torch.train import init_train_state, make_train_step

ARCHS = list_archs()
META = torch.device("meta")


def meta(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=META)


# ------------------------------------------------------------------ (a)

def _loop(x):
    for _ in range(7):
        x = torch.tanh(x @ x)
    return x


def _nested(x):
    for _ in range(5):
        for _ in range(3):
            x = x @ x
    return x


def _slice_write(how):
    def f(x):
        buf = torch.zeros((64, 32, 32), device=x.device)
        for i in range(64):
            x = x * 1.5
            if how == "setitem":
                buf[i] = x
            elif how == "index_put_":
                buf.index_put_((torch.tensor([i], device=x.device),),
                               x[None])
            else:
                buf.index_copy_(0, torch.tensor([i], device=x.device),
                                x[None])
        return buf
    return f


def _views(x):
    y = x.view(16, 256).t().unsqueeze(0).expand(3, 256, 16)
    y = y.permute(2, 1, 0)[1:, ::2].select(2, 1).detach()
    return torch.as_strided(y, (4, 4), (1, 4)).squeeze()


def _case_loop():
    t = analyze_program(_loop, meta(64, 64))
    assert t.by_op["mm"]["flops"] == 7 * 2 * 64 ** 3
    assert t.flops_of(PRODUCT_OPS) == 7 * 2 * 64 ** 3
    assert t.flops == 7 * 2 * 64 ** 3 + 7 * 64 * 64     # tanh: its result
    assert t.launches == {"mm": 7, "tanh": 7}
    # the reference's count of the same loop, compiled: within the 5% its
    # own test allows between a scan and the unrolled graph
    xs = jax.ShapeDtypeStruct((64, 64), jnp.float32)

    def j_loop(x):
        for _ in range(7):
            x = jnp.tanh(x @ x)
        return x
    ref = analyze_hlo(jax.jit(j_loop).lower(xs).compile().as_text())
    assert abs(t.flops - ref.flops) / ref.flops < 0.05


def _case_nested():
    t = analyze_program(_nested, meta(32, 32))
    assert t.flops == 15 * 2 * 32 ** 3
    assert t.launches == {"mm": 15}


def _case_slice(how):
    t = analyze_program(_slice_write(how), meta(32, 32))
    stack = 64 * 32 * 32 * 4
    part = 32 * 32 * 4
    # the zero fill writes the buffer once; each step reads and writes x
    # (the multiply) and writes one slice from x: twice the slice
    assert t.bytes == stack + 64 * (2 * part + 2 * part)
    assert t.bytes < 16 * stack


def _case_views():
    t = analyze_program(_views, meta(64, 64))
    assert (t.flops, t.bytes, t.total_launches) == (0.0, 0.0, 0)


HLO_MIRRORS = {
    "loop_of_products": _case_loop,
    "nested_loops_multiply": _case_nested,
    "slice_setitem": lambda: _case_slice("setitem"),
    "slice_index_put_": lambda: _case_slice("index_put_"),
    "slice_index_copy_": lambda: _case_slice("index_copy_"),
    "views_count_nothing": _case_views,
}


@pytest.mark.parametrize("case", list(HLO_MIRRORS))
def test_mirrors_of_the_reference_hlo_cost(case):
    HLO_MIRRORS[case]()


# ------------------------------------------------------------------ (b)

def _front(cfg):
    return cfg.frontend_len or {"patch": 256, "frame": 64}.get(
        cfg.frontend, 0)


def _stub_attention(q, k, v, **kw):
    """No products, gradients to q, k and v alike (the card's kernel is
    no ATen op either)."""
    return q + (k.sum() + v.sum()) * 0


def _flop_counter(cfg, kind, B, S, monkeypatch):
    """flop_counter's products of the CPU run of the program the count
    traces (``dryrun.trace_cell``)."""
    model = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    front = _front(cfg)
    fe = torch.randn(B, front, cfg.d_model, generator=gen) if front \
        else None
    if kind != "decode":
        monkeypatch.setattr(t_attn, "flash_attention", _stub_attention)
    if kind == "train":
        opt = AdamW()
        state = init_train_state(model, opt, 0, params=model.param_tree())
        step = make_train_step(model, opt, microbatches=2, remat=True)
        batch = dict(tokens=toks, labels=toks)
        if fe is not None:
            batch["frontend_embed"] = fe
        with FlopCounterMode(display=False) as fc:
            step(state, batch)
        return fc.get_total_flops()
    with FlopCounterMode(display=False) as fc, torch.inference_mode():
        if kind == "prefill":
            model(toks, fe)
        else:
            model.decode_step(toks[:, :1], model.init_cache(B, S), S - 1)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_product_flops_equal_cost_model_and_flop_counter(arch, kind,
                                                         monkeypatch):
    cfg = get_config(arch, reduced=True)
    S = 2 * cfg.ssm.chunk if cfg.family in ("ssm", "hybrid") else 40
    B = 2 if kind != "train" else 4
    shape = ShapeCell("cell", S, B, kind)
    layout = make_layout((1, 1))
    t = dryrun.trace_cell(cfg, shape, layout, microbatches=2, remat=True)
    counted = t.flops_of(PRODUCT_OPS)
    c = cell_cost(cfg, shape, layout, microbatches=2, remat=True)
    # the decode's attention is plain products over the cache
    predicted = c.matmul_flops + (c.attention_flops if kind == "decode"
                                  else 0.0)
    assert counted == predicted
    assert counted == _flop_counter(cfg, kind, B, S, monkeypatch)


# ------------------------------------------------------------------ (c)

@pytest.mark.parametrize("S", [64, 256, 1024])
def test_forward_flops_against_the_reference_hlo_count(S):
    jm = j_get_model(j_get_config("qwen2-1.5b", reduced=True))
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    toks = jax.ShapeDtypeStruct((2, S), jnp.int32)
    ref = analyze_hlo(jax.jit(lambda p, t: jm.forward(p, t)).lower(
        params, toks).compile().as_text()).flops
    cfg = get_config("qwen2-1.5b", reduced=True)
    t = dryrun.trace_cell(cfg, ShapeCell("p", S, 2, "prefill"),
                          make_layout((1, 1)))
    H, hd, L = cfg.n_heads, cfg.hd, cfg.n_layers
    scores = 2 * H * S * S * L                  # B x H x S x S per layer
    above = 4.0 * hd * (scores - 2 * H * L * fa.visible_pairs(S, S))
    assert t.flops_of(t.kernels) == 4.0 * hd * 2 * H * L * \
        fa.visible_pairs(S, S)
    gap = ref - (t.flops + above)
    assert 0 <= gap <= 8 * scores, (ref, t.flops, above, gap / scores)


# ------------------------------------------------------------------ (d)

@pytest.fixture(scope="module")
def chip_smoke():
    """``chip_smoke.py`` imported as a module (it exits without a card
    when run)."""
    root = str(pathlib.Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: True
    try:
        return importlib.import_module("chip_smoke")
    finally:
        torch.cuda.is_available = real


@pytest.mark.parametrize("name", ["TFC-w2a2", "CNV-w2a2"])
def test_qnn_launches_are_the_plans(name, chip_smoke):
    model = build_flow(WORKLOADS[name]()).model
    compiled = lower(model, device="meta", use_kernel=True)
    feeds = chip_smoke.feeds_for(model, 256, seed=1)
    t = analyze_program(compiled._forward, feeds)
    want = chip_smoke.expected_launches(model, compiled)
    assert {k: t.kernels.get(k, 0) for k in want} == want
    # each kernel's launches are one row of the per-op table
    assert {k: t.by_op[k]["launches"] for k in want} == want


# ------------------------------------------------------------------ (e)

def _nothing_built(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a count built or launched a kernel")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "_nvcc", refuse)
    monkeypatch.setattr(shutil, "which", refuse)
    monkeypatch.setattr(torch.cuda, "current_stream", refuse)
    monkeypatch.setattr(torch.cuda, "device", refuse)


def _train_program():
    cfg = get_config("qwen2-1.5b", reduced=True)
    return dryrun._trace.__wrapped__(
        cfg, ShapeCell("t", 32, 4, "train"), (2, 2), ("data", "model"),
        microbatches=2, remat=True, quant_bits=8, int8_weights=False,
        int8_kv=False)


def _qnn_program():
    model = build_flow(WORKLOADS["TFC-w2a2"]()).model
    compiled = lower(model, device="meta", use_kernel=True)
    shape = (8,) + tuple(model.metadata["input_shape"][1:])
    return analyze_program(compiled._forward, {
        model.graph.inputs[0]: np.zeros(shape)})


@pytest.mark.parametrize("program", ["train_step", "qnn"])
def test_a_count_builds_and_launches_nothing(program, monkeypatch):
    before = dict(_build.LAUNCH_COUNTS)
    _nothing_built(monkeypatch)
    t = _train_program() if program == "train_step" else _qnn_program()
    assert dict(_build.LAUNCH_COUNTS) == before
    assert sum(t.kernels.values()) > 0


def _wrappers():
    q = meta(1, 8, 2, 16)
    x8, w8 = meta(4, 8, dtype=torch.int8), meta(8, 4, dtype=torch.int8)
    xi, ti = meta(4, 3, dtype=torch.int32), meta(2, 3, dtype=torch.int32)
    lse = meta(1, 2, 8)
    return {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd(q, q, q),
        "flash_attention_fwd_lse": lambda: fa.flash_attention_fwd_lse(
            q, q, q),
        "flash_attention_bwd": lambda: fa.flash_attention_bwd(
            q, q, q, q, lse, q),
        "int_matmul": lambda: kops.int_matmul(x8, w8),
        "multithreshold": lambda: kops.multithreshold(xi, ti),
        "quantize": lambda: kops.quantize(meta(4, 3), 0.5, 0.0),
    }


@pytest.mark.parametrize("wrapper", list(_wrappers()))
def test_meta_tensors_outside_a_count_raise(wrapper):
    with pytest.raises(RuntimeError, match="outside a count"):
        _wrappers()[wrapper]()


def test_counted_wrappers_return_outputs_of_the_kernels_shapes():
    calls = _wrappers()
    t = analyze_program(lambda: [f() for f in calls.values()])
    assert t.kernels == {"flash_attention": 2,
                         "flash_attention_bwd_delta": 1,
                         "flash_attention_bwd_dkdv": 1,
                         "flash_attention_bwd_dq": 1, "int_matmul": 1,
                         "multithreshold": 1, "quantize": 1}
    assert t.routes == {"flash_attention_bwd_dkdv:cuda_cores": 1,
                        "flash_attention_bwd_dq:cuda_cores": 1,
                        "int_matmul:tensor_cores": 1,
                        "multithreshold:compare_count": 1}
    out = {}
    analyze_program(lambda: out.update(
        (k, f()) for k, f in calls.items()))
    assert out["flash_attention_fwd_lse"][1].shape == (1, 2, 8)
    assert out["int_matmul"].dtype == torch.int32
    assert out["multithreshold"].shape == (4, 3)
    # the kernels' work functions: the causal pairs of 8 queries
    assert t.by_op["flash_attention"]["flops"] == 2 * 4.0 * 2 * 16 * 36


def test_gemma2_training_step_counts_the_tensor_core_backward_at_hd256():
    """One bf16 gemma2-2b training step at published widths, cut in depth
    to 2 of its 26 layers (1 x 64, one microbatch, no remat, on ``meta``
    tensors): each layer's dK/dV and dQ go on the ``tensor_cores`` route
    at hd 256, the dK/dV launch with its GQA sum (8 query heads over 4 KV
    heads), and none on ``cuda_cores``."""
    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=2)
    assert (cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.dtype) == (
        256, 8, 4, torch.bfloat16)
    t = dryrun._trace.__wrapped__(
        cfg, ShapeCell("t", 64, 1, "train"), (1, 1), ("data", "model"),
        microbatches=1, remat=False, quant_bits=0, int8_weights=False,
        int8_kv=False)
    assert t.kernels == {"flash_attention": 2,
                         "flash_attention_bwd_delta": 2,
                         "flash_attention_bwd_dkdv": 2,
                         "flash_attention_bwd_dq": 2}
    assert t.routes == {"flash_attention_bwd_dkdv:tensor_cores": 2,
                        "flash_attention_bwd_dq:tensor_cores": 2}
    assert t.by_op["flash_attention_bwd_dkdv_sum"]["launches"] == 2


# ------------------------------------------------------- the dry run

def test_dry_run_figures_come_from_the_count():
    """A counted cell: its cost, collectives and roofline are the count's,
    the prediction stands under ``predicted`` with the ratios, every
    layer has a scope forward and backward."""
    layout = make_layout((4, 2))
    shape = ShapeCell("train_4k", 256, 16, "train")
    res = dryrun.run_cell("granite-3-2b", "train_4k", layout=layout,
                          shape=shape, microbatches=2)
    assert res.ok and res.counted, res.note
    cfg = get_config("granite-3-2b")
    t = dryrun.trace_cell(cfg, shape, layout, microbatches=2)
    assert res.cost["flops"] == t.flops
    assert res.cost["bytes accessed"] == t.bytes
    assert res.cost["launches"] == t.total_launches
    assert res.collectives["counts"] == t.collectives.counts
    assert res.roofline["flops_per_chip"] == t.flops
    pred = res.predicted
    assert pred["ratio"]["flops"] == t.flops / pred["cost"]["flops"]
    assert pred["ratio"]["bytes"] == t.bytes / pred["cost"][
        "bytes accessed"]
    for i in range(cfg.n_layers):
        assert res.by_scope[f"layer{i}"]["launches"] > 0
        assert res.by_scope[f"layer{i}.backward"]["launches"] > 0
    assert res.by_scope["optimizer"]["launches"] > 0
    # (4, 2): data 4 ranks split every microbatch's 8 rows: the gradients
    # reduce-scattered and the params gathered over "data"
    assert {"all-reduce", "reduce-scatter", "all-gather"} <= \
        set(res.collectives["counts"])


def test_layouts_the_port_cannot_run_keep_the_prediction():
    """qwen2-1.5b's 12 heads do not split over 8: no program, the cell
    keeps cost.py's figures and says why."""
    res = dryrun.run_cell("qwen2-1.5b", "prefill_32k")
    assert res.ok and not res.counted
    assert "not counted" in res.note and "12 query heads" in res.note
    assert res.cost == res.predicted["cost"]


def test_recording_layout_takes_meta_tensors_only():
    layout = make_recording_layout((1, 2))
    with pytest.raises(RuntimeError, match="meta"):
        layout.all_reduce(torch.ones(3), "model")
    t = analyze_program(lambda: layout.all_gather(meta(2, 3), "model"),
                        layout=layout)
    assert t.collectives.counts == {"all-gather": 1}
    assert t.by_op["all-gather"]["bytes"] == 2 * 3 * 4 * 3
    with pytest.raises(ValueError, match="recording"):
        analyze_program(lambda: None, layout=make_layout((1, 1)))


def test_scopes_nest_and_count_nothing_outside_a_count():
    """obs spans are the count's scopes; a backward op is filed under the
    span in which autograd made its node; the tracer comes back."""
    tracer = get_tracer()
    with tracer.span("ignored"):
        pass

    def f(x, w):
        span = get_tracer().span
        with span("a"):
            x = x * w
            with span("b"):
                x = x.sin()
        loss = x.sum()
        torch.autograd.grad(loss, [w])
    w = torch.zeros(4, device=META, requires_grad=True)
    t = analyze_program(f, meta(4), w)
    assert get_tracer() is tracer
    assert {k: v["launches"] for k, v in t.by_scope.items()} == {
        "a": 1, "b": 1, "(top)": 2,            # mul; sin; sum, the seed
        "b.backward": 2, "a.backward": 1}      # cos, mul; mul


def test_cell_json_holds_ops_and_layers(tmp_path):
    """The cell's JSON holds the count per op and per layer (forward and
    backward of a step), adding up to its totals."""
    res, = dryrun.main(["--arch", "granite-3-2b", "--shape", "train_4k",
                        "--layout", "1x1", "--batch", "2", "--seq", "64",
                        "--out", str(tmp_path)])
    saved = json.loads(next(tmp_path.glob("*.json")).read_text())
    assert saved["by_op"] == res.by_op and saved["by_scope"] == res.by_scope
    n = get_config("granite-3-2b").n_layers
    assert {"embed", "head", "loss", "optimizer", f"layer{n - 1}",
            f"layer{n - 1}.backward"} <= set(saved["by_scope"])
    for table in ("by_op", "by_scope"):
        assert sum(v["launches"] for v in saved[table].values()) == \
            saved["cost"]["launches"]


def test_work_is_computed_under_a_count_only():
    """Off a count a wrapper's launch site calls no work function."""
    def work():
        raise AssertionError("work computed off a count")
    assert not _build.counted("flash_attention", work, torch.zeros(1))
    with pytest.raises(AssertionError, match="off a count"):
        analyze_program(lambda: _build.counted("flash_attention", work,
                                               meta(1)))


def _pairs(Sq, Sk, causal, window, q_offset):
    return sum(max((min(p, Sk - 1) if causal else Sk - 1)
                   - (max(p - window + 1, 0) if window else 0) + 1, 0)
               for p in range(q_offset, q_offset + Sq))


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset", [
    (64, 64, True, 0, 0), (1, 4096, True, 0, 4095), (100, 300, True, 7, 0),
    (256, 512, True, 0, 256), (33, 40, False, 0, 0), (33, 40, False, 9, 5),
    (16, 16, True, 32, 0), (5, 8, True, 3, 20)])
def test_visible_pairs_closed_form(Sq, Sk, causal, window, q_offset):
    assert fa.visible_pairs(Sq, Sk, causal=causal, window=window,
                            q_offset=q_offset) == \
        _pairs(Sq, Sk, causal, window, q_offset)
