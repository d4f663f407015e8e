"""Training split over ranks (tensor, data and ZeRO parallelism,
fake-quant) and static serving under a layout, on CPU ``gloo`` ranks,
each its own process (``launch/ranks.py``), against the port's whole
model and the reference's unsharded functions.

Reduced qwen2-1.5b (4 query heads, 2 KV heads), float32, the
reference's weights carried across (``load_reference_params``).  Every
rank takes the same three global batches (4 x 32, seeded numpy) and
runs its share:

  * layouts (1, 2) (model), (2, 1) (data, AdamW's masters and moments
    ZeRO-split over "data") and (2, 2) on four ranks, each at 1 and 2
    microbatches: the losses within 1e-5 (relative) of the whole
    model's and of the reference's ``make_train_step``; the first
    step's gradient before AdamW within 1e-4 of each leaf's max |g|
    (the reference's from ``jax.grad`` of its loss); the masters after
    three steps within 1e-5 of the largest master; the global-norm
    clip active (clip 0.5, gradient norms near 7);
  * fake-quant (``QuantSpec(bits=8)``) under (1, 2) and (2, 1): the
    first step's loss within 1e-5 of the reference's quantized loss;
    int8 gradients with error feedback (``compress=True``): two steps'
    losses within 1e-5 of the whole model's;
  * static serving (``ServingConfig(mode="static", mesh=layout)``,
    ``decode_step`` and ``init_cache`` of the split model; ``wo`` and
    ``w_down`` x64 so that greedy streams move): streams equal the
    reference's static engine's.

The rendezvous is a ``file://`` in ``tmp_path``, the process group's
timeout 60 s and the ranks' deadline 120 s, so a hang fails the test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.optim import AdamW as JAdamW
from repro.quant.quantizer import QuantSpec as JQuantSpec
from repro.serve import Request as JRequest
from repro.serve import ServingConfig as JServingConfig
from repro.serve import ServingEngine as JServingEngine
from repro.train import (init_train_state as j_init_train_state,
                         make_train_step as j_make_train_step)
from repro_torch.configs import get_config
from repro_torch.launch import ranks as t_ranks
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import load_reference_params
from repro_torch.models.convert import unflatten

ARCH = "qwen2-1.5b"
CLIP = 0.5
TRAIN = dict(arch=ARCH, reduced=True, seed=0, steps=3, batch=[4, 32],
             microbatches=[1, 2], lr=3e-3, warmup=2, total=50,
             clip_norm=CLIP, tol_loss=1e-5, tol_grad=1e-4, tol_master=1e-5)
QUANT = dict(TRAIN, steps=1, microbatches=[1], quant_bits=8,
             tol_grad=None, tol_master=None)
# int8 gradients with error feedback: each per-tensor scale the whole
# gradient's (a max over the ranks' blocks)
COMPRESS = dict(TRAIN, steps=2, microbatches=[1], compress=True,
                tol_grad=None, tol_master=None)
STATIC = dict(archs=[ARCH], reduced=True, layout=[1, 2],
              requests=[[10, 6], [10, 8]], max_seq=32, exact=True)
BASE = dict(device="cpu", threads=1, pg_timeout=60.0)
GAIN = 64.0


def _tree(cfg, jtree):
    """A reference tree (params, grads, masters) as the port's tree."""
    return unflatten(load_reference_params(
        cfg, jax.tree.map(np.asarray, jtree)))


def _leaf_max(tree):
    return t_ranks._leaf_max(tree)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's weights as a port tree file, and its runs of the
    train and fake-quant tasks and of the static engine, as an oracle
    file of ``launch/ranks.py``'s layout."""
    work = tmp_path_factory.mktemp("tp_train_ref")
    cfg = get_config(ARCH, reduced=True)
    jcfg = j_get_config(ARCH, reduced=True)
    jm = j_get_model(jcfg)
    j_opt = JAdamW(lr=TRAIN["lr"], warmup_steps=TRAIN["warmup"],
                   total_steps=TRAIN["total"], clip_norm=CLIP)
    js0 = j_init_train_state(jm, j_opt, jax.random.PRNGKey(0))
    params = js0.params
    torch.save(_tree(cfg, params), work / "params.pt")
    batches = t_ranks.train_batches(TRAIN, cfg.vocab)
    oracle = {"train": {}, "train_quant": {}}
    for mb in TRAIN["microbatches"]:
        def loss(p, b):
            return jm.loss(p, b["tokens"], b["labels"])
        b0 = {k: jnp.asarray(v).reshape((mb, -1) + v.shape[1:])
              for k, v in batches[0].items()}
        grads = jax.tree.map(lambda *g: sum(g) / mb, *[
            jax.grad(loss)(params, {k: v[i] for k, v in b0.items()})
            for i in range(mb)])
        js = js0
        step = jax.jit(j_make_train_step(jm, j_opt, microbatches=mb,
                                         remat=False))
        losses, gnorms = [], []
        for b in batches:
            js, met = step(js, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
        g = _tree(cfg, grads)
        masters = _tree(cfg, js.opt.master)
        oracle["train"][f"mb{mb}"] = dict(
            losses=losses, gnorms=gnorms, grads=g, gmax=_leaf_max(g),
            masters=masters, mmax=_leaf_max(masters))
    b = batches[0]
    oracle["train_quant"]["mb1"] = dict(losses=[float(jm.loss(
        params, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]),
        quant=JQuantSpec(bits=8)))])
    # static serving, the residual branches x64
    gained = dict(params, layers=dict(params["layers"]))
    lay = gained["layers"]
    lay["attn"] = dict(lay["attn"], wo=lay["attn"]["wo"] * GAIN)
    lay["mlp"] = dict(lay["mlp"], w_down=lay["mlp"]["w_down"] * GAIN)
    torch.save(_tree(cfg, gained), work / "params_gain.pt")
    reqs = t_ranks._static_requests(cfg, STATIC)
    eng = JServingEngine(jm, gained, JServingConfig(
        batch_slots=len(reqs), max_seq=STATIC["max_seq"], mode="static"))
    streams = eng.generate([JRequest(prompt=r.prompt,
                                     max_new_tokens=r.max_new_tokens,
                                     request_id=r.request_id)
                            for r in reqs])
    oracle["static_serve"] = {ARCH: dict(streams=[list(map(int, s))
                                                  for s in streams])}
    torch.save(oracle, work / "oracle.pt")
    return dict(params=str(work / "params.pt"),
                params_gain=str(work / "params_gain.pt"),
                oracle=str(work / "oracle.pt"), oracle_tree=oracle)


@pytest.fixture(scope="module")
def two_ranks(reference, tmp_path_factory):
    p = reference["params"]
    return run_ranks(2, dict(
        BASE, layout=[1, 2], oracles=[reference["oracle"]],
        oracle_in_rank=True,
        tasks=["train", "train_quant", "train_compress", "static_serve"],
        train=dict(TRAIN, params=p, layouts=[[1, 2], [2, 1]]),
        train_quant=dict(QUANT, params=p, layouts=[[1, 2], [2, 1]]),
        train_compress=dict(COMPRESS, params=p, layouts=[[1, 2], [2, 1]]),
        static_serve=dict(STATIC, params=reference["params_gain"])),
        tmp_path_factory.mktemp("tp_train2"), timeout_s=120)


@pytest.fixture(scope="module")
def four_ranks(reference, tmp_path_factory):
    return run_ranks(4, dict(
        BASE, layout=[2, 2], oracles=[reference["oracle"]],
        oracle_in_rank=True, tasks=["train"],
        train=dict(TRAIN, params=reference["params"], layouts=[[2, 2]])),
        tmp_path_factory.mktemp("tp_train4"), timeout_s=120)


def _check_case(ranks, name):
    digests = set()
    for res in ranks:
        run = res["train"][name]
        assert len(run["vs"]) == 2          # the port's whole, the reference
        for cmp in run["vs"]:
            assert cmp["loss_rel_err"] <= 1e-5
            assert cmp["grad_err"] <= 1e-4
            assert cmp["master_err"] <= 1e-5
        # the clip is active: every step's norm is above it
        assert min(run["gnorms"]) > CLIP
        np.testing.assert_allclose(run["gnorms"], run["vs"][1]
                                   ["whole_gnorms"], rtol=1e-5)
        digests.add(run["digest"])
    assert len(digests) == 1                # every rank the same losses


@pytest.mark.parametrize("case", ["1x2_mb1", "1x2_mb2", "2x1_mb1",
                                  "2x1_mb2"])
def test_split_training_matches_whole_and_reference(two_ranks, case):
    _check_case(two_ranks, case)


@pytest.mark.parametrize("case", ["2x2_mb1", "2x2_mb2"])
def test_training_on_four_ranks(four_ranks, case):
    _check_case(four_ranks, case)


def test_zero_reduce_scatters_and_gathers_over_data(two_ranks):
    """(2, 1): the gradients of the ZeRO leaves are reduce-scattered
    (an all_reduce and a slice, counted as what crossed) and the new
    params gathered over "data"; (1, 2): nothing moves over "data", and
    the backward's collectives are counted beside the forward's."""
    for res in two_ranks:
        data = res["train"]["2x1_mb1"]["collectives"]["counts"]
        assert data["reduce-scatter"] > 0 and data["all-gather"] > 0
        model = res["train"]["1x2_mb1"]["collectives"]["counts"]
        assert "reduce-scatter" not in model
        n = get_config(ARCH, reduced=True).n_layers
        # forward: 2 per layer + the embedding's all_reduce, 1 gather;
        # backward: the copies' 2 per layer + the head's, the scalar of
        # the norm
        assert model["all-reduce"] == (2 * n + 1) + (2 * n + 1) + 1
        assert model["all-gather"] == 1


def test_fake_quant_under_layouts_matches_reference(two_ranks, reference):
    want = reference["oracle_tree"]["train_quant"]["mb1"]["losses"][0]
    for res in two_ranks:
        for case in ("1x2_mb1", "2x1_mb1"):
            run = res["train_quant"][case]
            for cmp in run["vs"]:
                assert cmp["loss_rel_err"] <= 1e-5
            np.testing.assert_allclose(run["losses"][0], want, rtol=1e-5)
            # not the float loss: the scales moved it
            assert run["losses"][0] != \
                res["train"][case]["losses"][0]


@pytest.mark.parametrize("case", ["1x2_mb1", "2x1_mb1"])
def test_compressed_gradients_under_layouts(two_ranks, case):
    """``compress=True``: the int8 gradient of a block takes the whole
    tensor's scale, so two steps' losses match the whole model's."""
    for res in two_ranks:
        run = res["train_compress"][case]
        cmp, = run["vs"]                    # the port's whole model
        assert cmp["loss_rel_err"] <= 1e-5
        assert run["losses"][1] != res["train"][case]["losses"][1]


def test_static_serving_under_a_layout_matches_reference(two_ranks,
                                                         reference):
    want = reference["oracle_tree"]["static_serve"][ARCH]["streams"]
    for res in two_ranks:
        run = res["static_serve"][ARCH]
        assert run["streams"] == want
        assert all(v["flips"] == [] for v in run["vs"])
        assert sum(run["distinct_tokens"]) > len(want)
    assert len({res["static_serve"][ARCH]["digest"]
                for res in two_ranks}) == 1
