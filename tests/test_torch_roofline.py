"""Port parity for ``roofline/`` and the dry run, on the CPU.

* ``model_flops_for`` equals the reference's on every arch x shape;
* ``roofline_from`` equals the reference's when the reference module's
  own peak constants are passed in (the port holds no such constant: its
  defaults are an H100's);
* ``report.py``'s tables equal the reference's on the same result dicts;
* ``cost.py``'s weight-product FLOPs equal what
  ``torch.utils.flop_counter.FlopCounterMode`` counts on the CPU forward
  of every reduced config (the attention's S² products are left out of
  both: the attention is stubbed out while counting);
* ``Model.init_shapes`` has ``init``'s shapes and dtypes, and the dry
  run's parameter and optimizer bytes are the real tensors' ``nbytes``;
* every dry-run cell of the production layouts is costed or skipped as
  the reference's ``cell_applicable`` says, and the CLI writes its JSON.
"""
import dataclasses
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as J_SHAPES
from repro.configs import cell_applicable as j_cell_applicable
from repro.configs import get_config as j_get_config
from repro.roofline import analysis as j_an
from repro.roofline import report as j_report
from repro_torch.configs import SHAPES, ShapeCell, get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_layout
from repro_torch.models import attention as t_attn
from repro_torch.models import get_model
from repro_torch.optim import AdamW
from repro_torch.roofline import analysis as t_an
from repro_torch.roofline import report as t_report
from repro_torch.roofline.cost import cell_cost
from repro_torch.tree import leaves

ARCHS = list_archs()


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_for_matches_reference(arch):
    for name, shape in SHAPES.items():
        js = J_SHAPES[name]
        assert t_an.model_flops_for(get_config(arch), shape, shape.kind) == \
            j_an.model_flops_for(j_get_config(arch), js, js.kind)


@pytest.mark.parametrize("link", ["ici", "dcn"])
def test_roofline_from_matches_reference_with_its_constants(link):
    bw = j_an.ICI_BW if link == "ici" else j_an.DCN_BW
    cases = [({"flops": 3.2e15, "bytes accessed": 7.1e11}, 256, 1.9e17),
             ({"flops": 1e9, "bytes accessed": 9e12}, 8, 4e9),
             ({"flops": 0.0, "bytes accessed": 0.0}, 1, 0.0)]
    for cost, n, mf in cases:
        for counts in ({}, {"all-reduce": 3, "all-gather": 1}):
            ob = {k: 10 ** 9 * v for k, v in counts.items()}
            wb = {k: 3 * v for k, v in ob.items()}
            want = j_an.roofline_from(
                cost, j_an.CollectiveStats(counts, ob, wb, 7), n, mf, bw)
            got = t_an.roofline_from(
                cost, t_an.CollectiveStats(counts, ob, wb, 7), n, mf, bw,
                peak_flops=j_an.PEAK_FLOPS, hbm_bw=j_an.HBM_BW)
            assert got.to_dict() == want.to_dict()


def test_port_peaks_are_the_h100s():
    assert t_an.PEAK_FLOPS == {"bfloat16": 989e12, "float16": 989e12,
                               "int8": 1979e12, "float32": 67e12}
    assert (t_an.HBM_BW, t_an.NVLINK_BW, t_an.INTERNODE_BW) == \
        (3.35e12, 900e9, 50e9)
    assert t_an.peak_flops(torch.bfloat16) == 989e12


@pytest.fixture(scope="module")
def results():
    """Dry-run result dicts: every arch at one shape on both production
    layouts, plus skipped cells and a failed one."""
    rs = [dryrun.run_cell(a, s, mp) for a in ARCHS
          for s in ("train_4k", "long_500k") for mp in (False, True)]
    rs = [dataclasses.asdict(r) for r in rs]
    rs.append(dict(rs[0], ok=False, reason="boom"))
    return rs


@pytest.mark.parametrize("mesh", [None, "32x8", "2x32x8"])
def test_report_tables_match_reference(results, mesh):
    assert t_report.dryrun_table(results, mesh) == \
        j_report.dryrun_table(results, mesh)
    if mesh:
        assert t_report.roofline_table(results, mesh) == \
            j_report.roofline_table(results, mesh)
    assert t_report.roofline_table(results) == \
        j_report.roofline_table(results, "32x8")


@pytest.mark.parametrize("arch", ARCHS)
def test_matmul_flops_equal_flop_counter(arch, monkeypatch):
    """What the model code multiplies, counted two ways (S² products of
    the attention out of both)."""
    cfg = get_config(arch, reduced=True)
    model = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    monkeypatch.setattr(t_attn, "flash_attention",
                        lambda q, k, v, **kw: torch.zeros_like(q))
    S = 2 * cfg.ssm.chunk if cfg.family in ("ssm", "hybrid") else 40
    toks = torch.randint(0, cfg.vocab, (2, S))
    front = cfg.frontend_len or {"patch": 256, "frame": 64}.get(
        cfg.frontend, 0)
    fe = torch.randn(2, front, cfg.d_model) if front else None
    with FlopCounterMode(display=False) as fc, torch.inference_mode():
        model(toks, fe)
    cost = cell_cost(cfg, ShapeCell("fwd", S, 2, "prefill"),
                     make_layout((1, 1)))
    assert fc.get_total_flops() == cost.matmul_flops


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_are_inits(arch):
    cfg = get_config(arch, reduced=True)
    model = get_model(cfg, device="cpu")
    shapes = model.init_shapes()
    real = model.init(torch.Generator().manual_seed(0)).param_tree()
    assert [(t.shape, t.dtype) for t in leaves(shapes)] == \
        [(t.shape, t.dtype) for t in leaves(real)]
    assert all(t.device.type == "meta" for t in leaves(shapes))


def test_predicted_param_and_opt_bytes_are_the_real_ones():
    """Reduced qwen2 at layout (1, 1): the train cell's parameter and
    AdamW-state bytes equal the tensors' ``nbytes``."""
    cfg = get_config("qwen2-1.5b", reduced=True)
    params = get_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0)).param_tree()
    opt = AdamW(total_steps=10).init(params)
    c = cell_cost(cfg, ShapeCell("t", 64, 8, "train"), make_layout((1, 1)),
                  microbatches=2)
    assert c.param_bytes == sum(t.nbytes for t in leaves(params))
    assert c.opt_bytes == sum(t.nbytes for t in leaves(opt))
    res = dryrun.run_cell("qwen2-1.5b", "train_4k", layout=make_layout(
        (1, 1)), shape=ShapeCell("t", 2048, 2, "train"), microbatches=2)
    mem = res.memory
    meas = dryrun.compare(res, dict(seconds=0.5,
                                    param_bytes=int(mem["param_bytes"]),
                                    opt_bytes=int(mem["opt_bytes"]) + 4))
    assert meas["param_bytes_equal"] and not meas["opt_bytes_equal"]
    assert meas["bound_share"] == pytest.approx(
        max(res.roofline["compute_s"], res.roofline["memory_s"]) / 0.5)
    assert meas["mfu"] == pytest.approx(
        6 * get_config("qwen2-1.5b").active_param_count() * 4096
        / (0.5 * 989e12))


def test_every_cell_is_costed_or_skipped_as_the_reference_says(tmp_path):
    """All arch x shape cells on both production layouts: costed (no
    failure) or skipped where the reference's ``cell_applicable`` skips;
    the per-device parameter bytes shrink from one device to 32x8."""
    for arch in ARCHS:
        for name in SHAPES:
            want_ok, _ = j_cell_applicable(j_get_config(arch),
                                           J_SHAPES[name])
            for mp in (False, True):
                r = dryrun.run_cell(arch, name, mp)
                assert r.skipped == (not want_ok), (arch, name)
                assert r.ok == want_ok, (arch, name, r.reason[-300:])
                if r.ok:
                    assert r.roofline["bottleneck"] in (
                        "compute", "memory", "collective")
                    one = dryrun.run_cell(arch, name, layout=make_layout(
                        (1, 1)))
                    assert r.memory["param_bytes"] < \
                        one.memory["param_bytes"]
    dryrun.main(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                 "--mesh", "both", "--out", str(tmp_path)])
    for name in ("32x8", "2x32x8"):
        d = json.loads((tmp_path / f"qwen2-1.5b__decode_32k__{name}.json")
                       .read_text())
        assert d["ok"] and d["mesh"] == name and d["cost"]["flops"] > 0


def test_gradient_all_reduce_crosses_nodes_at_the_internode_rate():
    """A (32, 8) train cell: "model"'s collectives stay in the node
    (NVLink), the gradient all-reduce over "data" crosses nodes at 50
    GB/s; at (2, 32, 8) it is also the pod axis's.  A (4, 2) layout fits
    one node: no inter-node bytes."""
    res = dryrun.run_cell("qwen2-1.5b", "train_4k")
    colls, rl = res.collectives, res.roofline
    inter = colls["internode_bytes"]
    assert 0 < inter < sum(colls["operand_bytes"].values())
    intra = sum(colls["operand_bytes"].values()) - inter
    assert rl["collective_s"] == pytest.approx(
        intra / t_an.NVLINK_BW + inter / t_an.INTERNODE_BW)
    assert colls["cross_pod_bytes"] == 0
    pod = dryrun.run_cell("qwen2-1.5b", "train_4k", multi_pod=True)
    assert pod.collectives["cross_pod_bytes"] == \
        pod.collectives["internode_bytes"] > 0
    one_node = dryrun.run_cell("qwen2-1.5b", "train_4k",
                               layout=make_layout((4, 2)))
    assert one_node.collectives["internode_bytes"] == 0
    assert one_node.roofline["collective_s"] == pytest.approx(
        sum(one_node.collectives["operand_bytes"].values())
        / t_an.NVLINK_BW)


def test_cli_costs_a_cut_cell_on_a_layout(tmp_path):
    """``--layout``, ``--batch`` and ``--seq`` cut a cell; ``main``
    returns the results it wrote.  ``--measure`` needs a card."""
    argv = ["--arch", "qwen2-1.5b", "--shape", "prefill_32k", "--layout",
            "1x1", "--batch", "1", "--seq", "1024", "--out", str(tmp_path)]
    res, = dryrun.main(argv)
    want = dryrun.run_cell("qwen2-1.5b", "prefill_32k",
                           layout=make_layout((1, 1)),
                           shape=ShapeCell("prefill_32k", 1024, 1, "prefill"))
    d = json.loads((tmp_path / "qwen2-1.5b__prefill_32k__1x1.json")
                   .read_text())
    assert d["ok"] and d["mesh"] == "1x1"
    assert d["cost"] == want.cost == res.cost
    assert res.roofline["model_flops"] == 2.0 * 1024 * \
        get_config("qwen2-1.5b").active_param_count()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.main(argv + ["--measure"])
