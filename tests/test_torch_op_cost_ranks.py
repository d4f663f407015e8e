"""The count's collectives against real ranks, and split training of the
MoE and hybrid families, on CPU ``gloo`` ranks (``launch/ranks.py``).

* A recording layout (``launch/mesh.py make_recording_layout``) traces
  rank 0's program on ``meta`` tensors (``launch/dryrun.py trace_cell``);
  its ``CollectiveCounter`` must equal the one that rank 0 of a real run
  of the same program fills, op by op: the calls, the operand bytes, the
  ring model's wire bytes, the cross-pod and the inter-node bytes.  The
  programs are the reduced qwen2-1.5b's prefill, first decode step and
  training step (one microbatch), and the reduced granite-moe-3b-a800m's
  and zamba2-2.7b's prefill, under the layouts (1, 2), (2, 1) and (2, 2).
  The real prefill runs the whole batch on every rank, so the trace's
  cell holds one batch per data rank.
* Split training of a MoE config (granite-moe-3b-a800m, experts split
  over "model") and of a hybrid one (zamba2-2.7b: Mamba2 split by head,
  the shared attention by the dense rules) under (1, 2) and (2, 1), two
  steps, against the port's whole model with
  ``tests/test_torch_tp_train.py``'s bars: losses within 1e-5
  (relative), the first step's gradient within 1e-4 of each leaf's max
  |g|, the masters within 1e-5 of the largest master.

The rendezvous is a ``file://`` in ``tmp_path``, the process group's
timeout 60 s and the ranks' deadline 120 s, so a hang fails the test.
"""
import dataclasses

import pytest

from repro_torch.configs import ShapeCell, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.ranks import run_ranks

DENSE, MOE, HYBRID = "qwen2-1.5b", "granite-moe-3b-a800m", "zamba2-2.7b"
B, S = 2, 32
FAMILIES = dict(archs=[DENSE, MOE, HYBRID], reduced=True, shape=[B, S],
                decode=1, tol=1e-5, tie=1e-5)
TRAIN = dict(arch=DENSE, reduced=True, seed=0, steps=1, batch=[4, S],
             microbatches=[1], oracle=False)
SPLIT = dict(reduced=True, seed=0, steps=2, batch=[4, S],
             microbatches=[1], lr=3e-3, warmup=2, total=50, clip_norm=0.5,
             tol_loss=1e-5, tol_grad=1e-4, tol_master=1e-5,
             layouts=[[1, 2], [2, 1]])
BASE = dict(device="cpu", threads=1, pg_timeout=60.0,
            oracle_in_rank=True)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(2, dict(
        BASE, layout=[1, 2],
        tasks=["train", "train_moe", "train_hybrid", "moe_prefill",
               "ssm_prefill"],
        train=dict(TRAIN, layouts=[[1, 2], [2, 1]]),
        train_moe=dict(SPLIT, arch=MOE), train_hybrid=dict(SPLIT, arch=HYBRID),
        moe_prefill=dict(FAMILIES, layout=[1, 2]),
        ssm_prefill=dict(FAMILIES, layout=[2, 1])),
        tmp_path_factory.mktemp("op_cost_ranks2"), timeout_s=120)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_ranks(4, dict(
        BASE, layout=[2, 2], tasks=["train", "moe_prefill"],
        train=dict(TRAIN, layouts=[[2, 2]]),
        moe_prefill=dict(FAMILIES, layout=[2, 2])),
        tmp_path_factory.mktemp("op_cost_ranks4"), timeout_s=120)


def _real(ranks, layout, program, arch):
    """Rank 0's collectives of ``program`` in the real run."""
    res = ranks[0]
    if program == "train":
        return res["train"][f"{layout[0]}x{layout[1]}_mb1"]["collectives"]
    key = "ssm_prefill" if tuple(layout) == (2, 1) else "moe_prefill"
    fam = res[key][arch]
    return fam["collectives"] if program == "prefill" else \
        fam["decode_collectives"]


def _traced(layout, program, arch):
    cfg = get_config(arch, reduced=True)
    lay = dryrun.make_layout(tuple(layout))
    dp = lay.size(("pod", "data"))
    if program == "train":
        shape = ShapeCell("train", S, TRAIN["batch"][0], "train")
        t = dryrun.trace_cell(cfg, shape, lay, microbatches=1, remat=False)
    elif program == "prefill":
        t = dryrun.trace_cell(cfg, ShapeCell("prefill", S, B * dp,
                                             "prefill"), lay)
    else:               # the first decode step, against a one-deep cache
        t = dryrun.trace_cell(cfg, ShapeCell("decode", 1, B * dp,
                                             "decode"), lay)
    return dataclasses.asdict(t.collectives)


PROGRAMS = [("prefill", DENSE), ("decode", DENSE), ("train", DENSE),
            ("prefill", MOE), ("prefill", HYBRID)]


@pytest.mark.parametrize("program,arch", PROGRAMS,
                         ids=[f"{p}-{a}" for p, a in PROGRAMS])
@pytest.mark.parametrize("layout", [(1, 2), (2, 1), (2, 2)],
                         ids=["1x2", "2x1", "2x2"])
def test_traced_collectives_equal_a_real_run(layout, program, arch,
                                             request):
    ranks = request.getfixturevalue(
        "four_ranks" if layout == (2, 2) else "two_ranks")
    real = _real(ranks, layout, program, arch)
    assert _traced(layout, program, arch) == real
    if layout != (2, 1) or program == "train":
        assert sum(real["counts"].values()) > 0


@pytest.mark.parametrize("case", ["1x2_mb1", "2x1_mb1"])
@pytest.mark.parametrize("task", ["train_moe", "train_hybrid"])
def test_split_training_of_moe_and_hybrid_matches_whole(two_ranks, task,
                                                        case):
    losses = set()
    for res in two_ranks:
        run = res[task][case]
        assert len(run["losses"]) == 2
        cmp, = run["vs"]                 # the port's whole model
        assert cmp["loss_rel_err"] <= 1e-5
        assert cmp["grad_err"] <= 1e-4
        assert cmp["master_err"] <= 1e-5
        losses.add(run["digest"])
    assert len(losses) == 1              # every rank the same losses
