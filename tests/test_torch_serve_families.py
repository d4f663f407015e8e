"""Port parity for the serving engine on every registered config besides
qwen2-1.5b (``tests/test_torch_serve.py``): the six other configs the
engine serves in paged mode (MoE, dense, vlm and audio; the vlm and audio
configs token-only, as the reference's ``Request`` carries prompt tokens
alone), with the fp pool and with the SIRA-int8 pool, and the three it
serves in static mode (Mamba2, the Zamba2 hybrid, gemma2-2b's rolling
window).

Both packages take the same numpy weights (the reference's seeded init,
carried across by ``load_reference_params``), and the port's greedy
streams must equal the reference engine's token for token.  With those
seeded weights some configs' greedy streams repeat one token whatever the
engine does, which would make the comparison vacuous; for them the numpy
weights' residual-branch outputs are first multiplied by
``BRANCH_GAIN`` (``scale_branches``), and every case asserts that its
streams move (more distinct tokens than streams).
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.serve import Request as JRequest
from repro.serve import ServingConfig as JServingConfig
from repro.serve import ServingEngine as JServingEngine
from repro.serve import derive_kv_spec as j_derive_kv_spec
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.serve import (Request, ServingConfig, ServingEngine,
                               derive_kv_spec)
from test_torch_kv_cache import _assert_specs_equal

PAGED_ARCHS = ["granite-moe-3b-a800m", "qwen2-moe-a2.7b", "glm4-9b",
               "granite-3-2b", "internvl2-26b", "musicgen-medium"]
STATIC_ARCHS = ["mamba2-780m", "zamba2-2.7b", "gemma2-2b"]
#: the configs whose seeded greedy streams repeat one token, and the one
#: factor their residual-branch outputs are multiplied by
STILL_ARCHS = ("granite-moe-3b-a800m", "granite-3-2b", "gemma2-2b")
BRANCH_GAIN = 256.0
#: (prompt, new tokens) of the paged requests: more than the slots, mixed
#: lengths, two arriving after three steps
PAGED_REQS = [(9, 6), (3, 7), (12, 5), (5, 6), (7, 4), (4, 6)]
#: static mode: equal-length prompts (an SSM cannot mask left padding)
STATIC_REQS, STATIC_PROMPT, STATIC_NEW = 3, 8, 6


def scale_branches(params, cfg, f):
    """The reference's params (numpy, layers stacked on axis 0) with every
    layer's residual-branch outputs multiplied by ``f``: ``wo`` and the MLP's
    or every expert's and the shared expert's ``w_down``; where a post-norm
    rescales each branch (gemma2, its local and global layers stacked
    apart), its gain ``1 + s`` (s -> f s + f - 1)."""
    return dict(params, layers=_scale_stack(params["layers"], cfg, f))


def _scale_stack(layers, cfg, f):
    if "local" in layers:
        return {k: _scale_stack(v, cfg, f) for k, v in layers.items()}
    layers = dict(layers)
    if cfg.post_norms:
        for k in ("post_ln1", "post_ln2"):
            layers[k] = layers[k] * f + (f - 1.0)
    else:
        layers["attn"] = dict(layers["attn"], wo=layers["attn"]["wo"] * f)
        if "moe" in layers:
            moe = dict(layers["moe"])
            for part in ("experts", "shared"):
                if part in moe:
                    moe[part] = dict(moe[part],
                                     w_down=moe[part]["w_down"] * f)
            layers["moe"] = moe
        else:
            layers["mlp"] = dict(layers["mlp"],
                                 w_down=layers["mlp"]["w_down"] * f)
    return layers


_PAIRS = {}


def _pair(arch):
    """(the port's model, the reference's model and its params), both on
    the same numpy weights; cached per arch."""
    if arch not in _PAIRS:
        jcfg = j_get_config(arch, reduced=True)
        jm = j_get_model(jcfg)
        params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        if arch in STILL_ARCHS:
            params = scale_branches(params, jcfg, BRANCH_GAIN)
        tm = get_model(get_config(arch, reduced=True), device="cpu")
        tm.load_reference_params(params)
        _PAIRS[arch] = (tm, jm, jax.tree.map(jax.numpy.asarray, params))
    return _PAIRS[arch]


def _as_ref(reqs):
    return [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                     request_id=r.request_id) for r in reqs]


def _midstream(engine, reqs):
    """Four requests, three steps, then the rest: the streams in order."""
    handles = [engine.submit(r) for r in reqs[:4]]
    for _ in range(3):
        engine.step()
    handles += [engine.submit(r) for r in reqs[4:]]
    engine.run()
    return [engine.scheduler.outputs[h] for h in handles]


def _assert_streams_move(outs):
    assert sum(len(set(o)) for o in outs) > len(outs), \
        f"every stream repeats one token: {outs}"


@pytest.mark.parametrize("kv", ["fp", "int8"])
@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_paged_streams_equal_the_reference(arch, kv):
    """Continuous batching over two slots, requests arriving mid-stream:
    every greedy stream equals the reference engine's, with the fp pool
    and with the int8 pool, whose spec each package derives from the
    weights (the two specs equal)."""
    tm, jm, params = _pair(arch)
    assert tm.supports_paged
    t_spec = j_spec = "fp"
    if kv == "int8":
        t_spec, j_spec = derive_kv_spec(tm), j_derive_kv_spec(jm, params)
        _assert_specs_equal(t_spec, j_spec)
        assert t_spec.n_int8 > 0
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, tm.cfg.vocab,
                                        size=(n,)).astype(np.int32),
                    max_new_tokens=m, request_id=i)
            for i, (n, m) in enumerate(PAGED_REQS)]
    kw = dict(batch_slots=2, max_seq=32, page_size=4)
    eng = ServingEngine(tm, ServingConfig(**kw, kv_cache=t_spec))
    assert eng.mode == "paged"
    outs = _midstream(eng, reqs)
    want = _midstream(JServingEngine(jm, params, JServingConfig(
        **kw, kv_cache=j_spec)), _as_ref(reqs))
    assert outs == want
    assert [len(o) for o in outs] == [m for _, m in PAGED_REQS]
    _assert_streams_move(outs)


@pytest.mark.parametrize("arch", STATIC_ARCHS)
def test_static_streams_equal_the_reference(arch):
    """Static mode: equal-length prompts batched, and each served alone,
    equal the reference static engine's streams; gemma2-2b on its reduced
    window, which the prompt and the new tokens pass."""
    tm, jm, params = _pair(arch)
    cfg = tm.cfg
    P = STATIC_PROMPT
    if cfg.sliding_window:
        P = cfg.sliding_window + 2
    rng = np.random.default_rng(6)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                        size=(P,)).astype(np.int32),
                    max_new_tokens=STATIC_NEW, request_id=i)
            for i in range(STATIC_REQS)]
    kw = dict(batch_slots=STATIC_REQS, max_seq=P + STATIC_NEW)
    eng = ServingEngine(tm, ServingConfig(**kw))
    assert eng.mode == "static"
    outs = eng.generate(reqs)
    want = JServingEngine(jm, params, JServingConfig(**kw)).generate(
        _as_ref(reqs))
    assert outs == want
    solo = ServingEngine(tm, ServingConfig(**dict(kw, batch_slots=1)))
    assert [solo.generate([r])[0] for r in reqs] == outs
    _assert_streams_move(outs)


@pytest.mark.parametrize("max_step", [1e-6, 0.32, 0.5])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "glm4-9b"])
def test_spec_at_max_step_equals_the_reference_derivation(arch, max_step):
    """``KVCacheSpec.at_max_step`` decides each layer anew from the default
    spec's proven bounds: it equals the reference's ``derive_kv_spec`` run
    at that ``max_step`` (all fp, mixed: the reduced layers' steps are
    0.33 and 0.30, all int8)."""
    tm, jm, params = _pair(arch)
    got = derive_kv_spec(tm).at_max_step(max_step)
    _assert_specs_equal(got, j_derive_kv_spec(jm, params,
                                              max_step=max_step))
    assert got.n_int8 == {1e-6: 0, 0.32: 1, 0.5: 2}[max_step]
