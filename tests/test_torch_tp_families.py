"""MoE expert parallelism and Mamba2/Zamba2 tensor parallelism on CPU
``gloo`` ranks (``launch/ranks.py``), against the port's whole model
and the reference's unsharded functions, the reference's weights
carried across (``load_reference_params``).

The four reduced MoE/SSM/hybrid configs (float32) under layout (1, 2):

  * granite-moe-3b-a800m and qwen2-moe-a2.7b (8 experts, 4 per rank;
    qwen2-moe's shared expert split as a dense MLP): the routing alike
    on every rank, each rank's experts' weighted outputs summed by one
    all_reduce;
  * mamba2-780m (8 heads, 4 per rank) and zamba2-2.7b (its Mamba2
    layers by head, its shared attention by the dense rules): ``in_proj``
    split by head, B and C whole on every rank, the gated RMSNorm's sum
    of squares summed over "model";

``Model.forward`` (2 x 16) and eight ``decode_step`` calls against the
rank's own cache, within 1e-5 of the logit scale of the whole model's
and of the reference's.  A padded-expert case: granite-moe with 6
experts under model = 4 (its 4 heads allow it; 6 does not divide by 4),
split over the reference's padded count 16, so that the ranks hold 4,
2, 0 and 0 experts; its logits equal the reference's, whose pad experts
are never routed to.  Static serving of mamba2 under (1, 2): streams
equal the reference's static engine's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.serve import Request as JRequest
from repro.serve import ServingConfig as JServingConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.launch import ranks as t_ranks
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import load_reference_params
from repro_torch.models.convert import unflatten

MOE = ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"]
SSM = ["mamba2-780m", "zamba2-2.7b"]
SPEC = dict(reduced=True, seed=0, shape=[2, 16], decode=8, tol=1e-5)
STATIC = dict(archs=["mamba2-780m"], reduced=True, layout=[1, 2],
              requests=[[12, 8], [12, 6]], max_seq=32, exact=True)
BASE = dict(device="cpu", threads=1, pg_timeout=60.0)
PADDED = "granite-moe-3b-a800m"


def _reference_run(jcfg, spec, work, name):
    """The reference's weights as a port tree file, and its prefill and
    decode logits of the task's tokens."""
    jm = j_get_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    cfg = t_ranks._cfg(dict(spec, arch=jcfg.name))
    path = work / f"{name}.pt"
    torch.save(unflatten(load_reference_params(
        cfg, jax.tree.map(np.asarray, params))), path)
    toks = t_ranks._prefill_tokens(cfg, spec)
    V = cfg.vocab
    logits = np.asarray(jm.forward(params, jnp.asarray(toks)))[..., :V]
    dec = jax.jit(jm.decode_step)
    cache = jm.init_cache(toks.shape[0], spec["decode"])
    steps = []
    for t in range(spec["decode"]):
        lg, cache = dec(params, jnp.asarray(toks[:, t:t + 1]), cache,
                        jnp.asarray(t))
        steps.append(np.asarray(lg)[..., :V])
    return jm, params, str(path), dict(
        logits=torch.from_numpy(logits.astype(np.float32)),
        decode=torch.from_numpy(np.concatenate(steps, 1).astype(
            np.float32)))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp_families_ref")
    oracle = {"moe_prefill": {}, "ssm_prefill": {}, "static_serve": {}}
    params = {}
    for key, archs in (("moe_prefill", MOE), ("ssm_prefill", SSM)):
        for arch in archs:
            jm, jp, params[arch], oracle[key][arch] = _reference_run(
                j_get_config(arch, reduced=True), SPEC, work, arch)
            if arch in STATIC["archs"]:
                cfg = t_ranks._cfg(dict(STATIC, arch=arch))
                reqs = t_ranks._static_requests(cfg, STATIC)
                eng = JServingEngine(jm, jp, JServingConfig(
                    batch_slots=len(reqs), max_seq=STATIC["max_seq"],
                    mode="static"))
                streams = eng.generate([
                    JRequest(prompt=r.prompt,
                             max_new_tokens=r.max_new_tokens,
                             request_id=r.request_id) for r in reqs])
                oracle["static_serve"][arch] = dict(
                    streams=[list(map(int, s)) for s in streams])
    padded = {}
    jcfg = j_get_config(PADDED, reduced=True)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, n_experts=6))
    _, _, padded["params"], padded["run"] = _reference_run(
        jcfg, dict(SPEC, n_experts=6), work, "padded")
    torch.save(oracle, work / "oracle.pt")
    torch.save({"moe_prefill": {PADDED: padded["run"]}},
               work / "oracle_padded.pt")
    return dict(params=params, oracle=str(work / "oracle.pt"),
                padded_params=padded["params"],
                padded_oracle=str(work / "oracle_padded.pt"))


@pytest.fixture(scope="module")
def two_ranks(reference, tmp_path_factory):
    p = reference["params"]
    return run_ranks(2, dict(
        BASE, layout=[1, 2], oracles=[reference["oracle"]],
        oracle_in_rank=True,
        tasks=["moe_prefill", "ssm_prefill", "static_serve"],
        moe_prefill=dict(SPEC, archs=MOE, layout=[1, 2], params=p),
        ssm_prefill=dict(SPEC, archs=SSM, layout=[1, 2], params=p),
        static_serve=dict(STATIC, params=p)),
        tmp_path_factory.mktemp("tp_families2"), timeout_s=120)


@pytest.fixture(scope="module")
def padded_ranks(reference, tmp_path_factory):
    return run_ranks(4, dict(
        BASE, layout=[1, 4], oracles=[reference["padded_oracle"]],
        oracle_in_rank=True, tasks=["moe_prefill"],
        moe_prefill=dict(SPEC, archs=[PADDED], layout=[1, 4], n_experts=6,
                         params=reference["padded_params"])),
        tmp_path_factory.mktemp("tp_families4"), timeout_s=120)


def _check(ranks, key, arch):
    digests = set()
    for res in ranks:
        run = res[key][arch]
        assert len(run["vs"]) == 2      # the port's whole, the reference
        for cmp in run["vs"]:
            for part in ("logits", "decode"):
                c = cmp[part]
                assert c["positions"] == c["of"]     # no routing swap
                assert c["max_abs_err"] <= 1e-5 * c["logit_scale"]
        digests.add(run["digest"])
    assert len(digests) == 1            # every rank the same logits


@pytest.mark.parametrize("arch", MOE)
def test_expert_parallel_prefill_and_decode(two_ranks, arch):
    _check(two_ranks, "moe_prefill", arch)
    for res in two_ranks:
        run = res["moe_prefill"][arch]
        # each rank holds half the experts, its attention heads and
        # vocabulary: less than the whole model
        assert run["param_bytes"] < 0.6 * run["whole_param_bytes"]
        # per layer: one all_reduce after wo, one after the experts
        n = t_ranks._cfg(dict(SPEC, arch=arch)).n_layers
        assert run["collectives"]["counts"] == {"all-reduce": 2 * n + 1,
                                                "all-gather": 1}


@pytest.mark.parametrize("arch", SSM)
def test_mamba2_split_by_head(two_ranks, arch):
    _check(two_ranks, "ssm_prefill", arch)
    cfg = t_ranks._cfg(dict(SPEC, arch=arch))
    for res in two_ranks:
        run = res["ssm_prefill"][arch]
        # per Mamba2 layer: the norm's sum of squares and out_proj; per
        # shared attention block: wo and w_down
        n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        assert run["collectives"]["counts"] == {
            "all-reduce": 2 * cfg.n_layers + 2 * n_attn + 1,
            "all-gather": 1}
        assert run["param_bytes"] < 0.6 * run["whole_param_bytes"]


def test_padded_experts_match_reference(padded_ranks):
    """6 experts over model = 4: blocks of the padded 16, so ranks hold
    4, 2, 0 and 0 of them; the logits are the reference's."""
    for res in padded_ranks:
        run = res["moe_prefill"][PADDED]
        assert len(run["vs"]) == 2
        for cmp in run["vs"]:
            for part in ("logits", "decode"):
                c = cmp[part]
                assert c["positions"] == c["of"]
                assert c["max_abs_err"] <= 1e-5 * c["logit_scale"]
    held = [res["moe_prefill"][PADDED]["param_bytes"]
            for res in padded_ranks]
    assert held[0] > held[1] > held[2] == held[3]
    assert len({res["moe_prefill"][PADDED]["digest"]
                for res in padded_ranks}) == 1


def test_mamba2_static_serving_under_a_layout(two_ranks, reference):
    want = torch.load(reference["oracle"])["static_serve"]["mamba2-780m"]
    for res in two_ranks:
        run = res["static_serve"]["mamba2-780m"]
        assert run["streams"] == want["streams"]
        assert all(v["flips"] == [] for v in run["vs"])
        assert sum(run["distinct_tokens"]) > len(run["streams"])


def test_dry_run_costs_the_reference_padded_experts():
    """qwen2-moe-a2.7b's 60 experts do not divide the (32, 8) layout's
    "model" axis: the dry run splits the reference's padded 64, 8 per
    device, the expert bytes the reference's spec gives a device (its
    ``param_pspecs`` on its own shapes); the (32, 8) cell is costed."""
    from repro.launch.shardings import param_pspecs as j_param_pspecs
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_layout
    from repro_torch.roofline.cost import local_params
    arch = "qwen2-moe-a2.7b"
    layout = make_production_layout()
    _, local, note = local_params(get_config(arch), layout)
    got = sum(w.numel() * w.element_size() for p in local["layers"]
              for w in p["moe"]["experts"].values())
    shapes = jax.eval_shape(j_get_model(j_get_config(arch)).init,
                            jax.random.PRNGKey(0))
    specs = j_param_pspecs(shapes)
    want = 0
    for k, w in shapes["layers"]["moe"]["experts"].items():
        spec = tuple(specs["layers"]["moe"]["experts"][k])
        split = layout.size("model") if "model" in spec and \
            w.shape[spec.index("model")] % layout.size("model") == 0 else 1
        want += int(np.prod(w.shape)) * w.dtype.itemsize // split
    assert got == want
    assert "padded 64" in note
    res = dryrun.run_cell(arch, "prefill_32k")
    assert res.ok and "padded 64" in res.note
