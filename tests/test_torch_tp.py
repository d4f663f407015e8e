"""Tensor parallelism of the port on CPU ``gloo`` ranks, each its own
process (``launch/ranks.py``), against the whole model in the same
process; ``compressed_psum`` against the reference's.

Reduced qwen2-1.5b (4 query heads, 2 KV heads), float32, seeded weights
with the residual branches (``wo``, ``w_down``) x64 so that greedy
streams move.  Two ranks (layout (1, 2): each rank 2 query heads, 1 KV
head, half the vocabulary) and four ((1, 4): "model" a multiple of the
KV heads, each rank the KV head of its query group):

  * ``Model.forward`` and ``decode_paged`` (chunks, then token by token)
    within ``1e-5 · max|logits|`` of the whole model; every rank the
    same logits, bit for bit;
  * ``ServingEngine(ServingConfig(mesh=layout))`` streams (fp pool, the
    SIRA int8 pool, the prefix cache, two sampled requests) equal to the
    whole engine's, on every rank; each rank's pool half the whole
    pool's bytes;
  * ``compressed_psum`` within 2·Σ_r scale_r of the plain sum, and, on one
    device, equal to the reference's under a one-device ``shard_map``;
  * the reduced MoE/SSM/hybrid configs under model = 2 (prefill and
    decode against the whole model), a fake-quant step's loss and
    static serving of qwen2 under (1, 2).

The rendezvous is a ``file://`` in ``tmp_path``, the process group's
timeout 60 s and the ranks' deadline 120 s, so a hang fails the test.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.train import compressed_psum as j_compressed_psum
from repro_torch.configs import get_config
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import get_model
from repro_torch.roofline.cost import local_params
from repro_torch.serve import ServingConfig, ServingEngine
from repro_torch.train.compression import compressed_psum

ARCH = "qwen2-1.5b"
ARGS = dict(device="cpu", arch=ARCH, reduced=True, seed=0, branch_gain=64.0,
            threads=1, pg_timeout=60.0, tol=1e-5, exact=True)


MOE_SSM = ["granite-moe-3b-a800m", "qwen2-moe-a2.7b", "mamba2-780m",
           "zamba2-2.7b"]
FAMILY = dict(reduced=True, seed=0, layout=[1, 2], shape=[1, 64], decode=4,
              tol=1e-5)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return run_ranks(2, dict(
        ARGS, layout=[1, 2], tasks=["prefill", "decode_paged", "serve",
                                    "psum", "moe_prefill", "ssm_prefill",
                                    "train_quant", "static_serve"],
        variants=["fp", "int8", "prefix", "sampled"],
        temperatures=[0.0, 1.0, 0.7, 0.0],
        moe_prefill=dict(FAMILY, archs=MOE_SSM[:2]),
        ssm_prefill=dict(FAMILY, archs=MOE_SSM[2:]),
        train_quant=dict(arch=ARCH, reduced=True, seed=0, layouts=[[1, 2]],
                         steps=1, batch=[2, 16], quant_bits=8,
                         tol_loss=1e-5),
        static_serve=dict(archs=[ARCH], reduced=True, layout=[1, 2],
                          requests=[[8, 6], [8, 5]], max_seq=16,
                          branch_gain=64.0)),
        tmp_path_factory.mktemp("ranks2"), timeout_s=120)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return run_ranks(4, dict(ARGS, layout=[1, 4], variants=["fp"], tasks=[
        "prefill", "decode_paged", "serve"]),
        tmp_path_factory.mktemp("ranks4"), timeout_s=120)


def _check_forward(ranks, layers):
    for r, res in enumerate(ranks):
        assert res["rank"] == r and res["backend"] == "gloo"
        assert res["coords"]["model"] == r
        pre = res["prefill"]
        assert pre["max_abs_err"] <= 1e-5 * pre["logit_scale"]
        # one all_reduce after each wo and w_down product and one of the
        # embedding; one all_gather of the head
        assert pre["collectives"]["counts"] == {
            "all-reduce": 2 * layers + 1, "all-gather": 1}
    assert len({res["prefill"]["digest"] for res in ranks}) == 1


def test_sharded_forward_matches_whole_model(two_ranks):
    _check_forward(two_ranks, get_config(ARCH, reduced=True).n_layers)


def test_sharded_decode_paged_matches_whole_model(two_ranks):
    for res in two_ranks:
        dp = res["decode_paged"]
        assert dp["max_abs_err"] <= 1e-5 * dp["logit_scale"]
    assert len({res["decode_paged"]["digest"] for res in two_ranks}) == 1


@pytest.mark.parametrize("variant", ["fp", "int8", "prefix", "sampled"])
def test_sharded_serving_streams_equal_whole_engine(two_ranks, variant):
    """Every rank takes the same decisions (greedy picks; Gumbel draws
    for the sampled requests, which read the gathered logits), and they
    are the whole engine's; the streams move (more than one token)."""
    runs = [res["serve"][variant] for res in two_ranks]
    for run in runs:
        assert run["streams"] == run["whole_streams"]
        assert run["flips"] == []
    assert runs[0]["streams"] == runs[1]["streams"]
    assert sum(len(set(s)) for s in runs[0]["streams"]) > \
        len(runs[0]["streams"])
    if variant == "int8":
        assert runs[0]["n_int8"] == get_config(ARCH, reduced=True).n_layers
    if variant == "prefix":
        assert runs[0]["prefix_hit_rate"] > 0


def test_each_rank_pool_holds_its_kv_heads(two_ranks):
    """2 KV heads over 2 ranks: each pool is half the whole pool."""
    for res in two_ranks:
        for variant in ("fp", "int8", "prefix"):
            run = res["serve"][variant]
            assert 2 * run["pool_bytes"] == run["whole_pool_bytes"]


def test_sharded_param_bytes_are_the_dry_runs(two_ranks):
    """The weights a rank holds are what ``roofline/cost.py`` predicts
    for one device of the layout, byte for byte."""
    cfg = get_config(ARCH, reduced=True)
    _, local, _ = local_params(cfg, t_mesh.make_layout((1, 2)))
    want = sum(t.numel() * t.element_size()
               for t in torch.utils._pytree.tree_leaves(local))
    for res in two_ranks:
        assert res["param_bytes"] == want


def test_compressed_psum_on_two_ranks(two_ranks):
    """Within 2·Σ_r scale_r of the plain all_reduce sum; the payload
    all_reduce is int32, so it moves what a float32 one does (+ the 4
    bytes of the scales' max)."""
    for res in two_ranks:
        ps = res["psum"]
        assert ps["max_abs_err"] <= ps["bound"]
        assert ps["compressed"]["counts"] == {"all-reduce": 2}
        assert ps["plain"]["counts"] == {"all-reduce": 1}
        assert ps["compressed"]["operand_bytes"]["all-reduce"] == \
            ps["plain"]["operand_bytes"]["all-reduce"] + 4
    assert len({res["psum"]["digest"] for res in two_ranks}) == 1


def test_model_axis_a_multiple_of_the_kv_heads(four_ranks):
    """4 ranks, 2 KV heads: each rank keeps its query group's KV head."""
    _check_forward(four_ranks, get_config(ARCH, reduced=True).n_layers)
    for res in four_ranks:
        assert res["decode_paged"]["max_abs_err"] <= \
            1e-5 * res["decode_paged"]["logit_scale"]
        run = res["serve"]["fp"]
        assert run["streams"] == run["whole_streams"]
        assert 2 * run["pool_bytes"] == run["whole_pool_bytes"]


def test_compressed_psum_matches_reference_on_one_device():
    """A one-rank axis: the port's equals the reference's under a
    one-device ``shard_map`` (as ``tests/test_train.py`` runs it)."""
    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:  # jax < 0.5
        from jax.experimental.shard_map import shard_map
    mesh = jax.make_mesh((1,), ("pod",))
    x = np.random.default_rng(0).normal(size=(4096,)).astype(np.float32)
    want = jax.jit(shard_map(lambda v: j_compressed_psum(v, "pod"),
                             mesh=mesh, in_specs=P(), out_specs=P()))(
        jnp.asarray(x))
    lay = t_mesh.make_layout((1,), ("pod",))
    with t_mesh.use_layout(lay):
        got = compressed_psum(torch.from_numpy(x), "pod")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert lay.stats.stats().counts == {}


# ------------------------------------------- MoE, Mamba2, what A11 left

def _reduced(arch):
    return get_model(get_config(arch, reduced=True), device="cpu").init(
        torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", MOE_SSM)
def test_moe_and_ssm_under_a_model_axis_name_a11b(two_ranks, arch):
    """MoE expert parallelism and Mamba2/Zamba2 tensor parallelism under
    model = 2: the prefill (1 x 64) and four decode steps within 1e-5 of
    the whole model's logit scale, every rank the same logits; with
    model = 1 they shard to themselves."""
    key = "moe_prefill" if arch in MOE_SSM[:2] else "ssm_prefill"
    for res in two_ranks:
        cmp, = res[key][arch]["vs"]
        for part in ("logits", "decode"):
            assert cmp[part]["positions"] == cmp[part]["of"]
            assert cmp[part]["max_abs_err"] <= \
                1e-5 * cmp[part]["logit_scale"]
    assert len({res[key][arch]["digest"] for res in two_ranks}) == 1
    model = _reduced(arch)
    one = model.shard(t_mesh.make_layout((2, 1)))
    toks = torch.randint(0, model.cfg.vocab, (1, 64))
    with torch.inference_mode():
        torch.testing.assert_close(one(toks), model(toks), rtol=0, atol=0)


def test_head_counts_the_axis_does_not_fit_raise():
    """4 query heads, 2 KV heads: model = 3 divides neither; model = 8
    does not divide the query heads; an odd d_ff would leave w_down's
    rows whole, and its all_reduce would sum them once per rank."""
    model = _reduced(ARCH)
    for m in (3, 8):
        with pytest.raises(ValueError, match="model axis"):
            model.shard(t_mesh.make_layout((1, m)))
    cfg = get_config(ARCH, reduced=True)
    odd = get_model(dataclasses.replace(cfg, d_ff=cfg.d_ff + 1),
                    device="cpu").init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="model axis .* d_ff"):
        odd.shard(t_mesh.make_layout((1, 2)))


def test_sharded_model_refuses_what_is_not_sharded(two_ranks):
    """decode_step, init_cache, the loss and fake-quant run under
    (1, 2): a fake-quant step's loss within 1e-5 of the whole model's,
    static streams (decode_step against the split init_cache) equal the
    whole engine's; a static engine under a one-rank layout serves; a
    mesh that is not a Layout is refused as in the reference."""
    for res in two_ranks:
        q = res["train_quant"]["1x2_mb1"]
        assert q["vs"][0]["loss_rel_err"] <= 1e-5
        st = res["static_serve"][ARCH]
        assert st["streams"] == st["vs"][0]["whole_streams"]
        assert sum(st["distinct_tokens"]) > len(st["streams"])
    whole = _reduced("mamba2-780m")
    eng = ServingEngine(whole, ServingConfig(
        batch_slots=1, max_seq=16, mesh=t_mesh.make_layout((1, 1))))
    from repro_torch.serve import Request
    assert eng.mode == "static" and len(eng.generate([Request(
        prompt=np.arange(4), max_new_tokens=3)])[0]) == 3
    with pytest.raises(ValueError, match="mesh"):
        ServingConfig(batch_slots=1, max_seq=16, mesh=(1, 2))
    assert dataclasses.replace(ServingConfig(batch_slots=1, max_seq=16),
                               mesh=t_mesh.make_layout((1, 1))).mesh.bound


def test_a_failing_rank_fails_the_run(tmp_path):
    """A rank whose check fails exits non-zero; the launcher stops the
    other rank and raises with the ranks' logs."""
    with pytest.raises(RuntimeError, match="exited with"):
        run_ranks(2, dict(ARGS, layout=[1, 2], tasks=["prefill"], tol=-1.0),
                  tmp_path, timeout_s=120)
