"""Port parity for speculative decoding and copy-on-write prefix caching
(``repro_torch.serve``) on the scenarios of ``tests/test_spec_decode.py``
and ``tests/test_prefix_cache.py`` (the sharded ones excepted: sharded
serving waits for ROADMAP A11, and the reference's own sharded decode is
broken under this JAX, reference fault 3).

Greedy streams equal the reference engine's, fp and int8, and the port
holds the reference's invariants on its own: speculative output equals
per-token output, shared-prefix output equals cold solo serving, under
page pressure, preemption and rollback.  Sampled streams are held to the
invariants only (the port re-keys its sampler).
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import get_model as j_get_model
from repro.serve import Request as JRequest
from repro.serve import ServingConfig as JServingConfig
from repro.serve import ServingEngine as JServingEngine
from repro.serve import derive_kv_spec as j_derive_kv_spec
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.serve import (FixedDrafter, NgramDrafter, Request,
                               ServingConfig, ServingEngine, derive_kv_spec,
                               get_drafter)

ARCH = "qwen2-1.5b"


@pytest.fixture(scope="module")
def setup():
    jm = j_get_model(j_get_config(ARCH, reduced=True))
    params = jm.init(jax.random.PRNGKey(0))
    tm = get_model(get_config(ARCH, reduced=True), device="cpu")
    tm.load_reference_params(jax.tree.map(np.asarray, params))
    return tm.cfg, tm, jm, params


@pytest.fixture(scope="module")
def specs(setup):
    cfg, tm, jm, params = setup
    return {"fp": ("fp", "fp"),
            "int8": (derive_kv_spec(tm), j_derive_kv_spec(jm, params))}


def _port(tm, **kw):
    return ServingEngine(tm, ServingConfig(**kw))


def _ref(setup, **kw):
    _, _, jm, params = setup
    return JServingEngine(jm, params, JServingConfig(**kw))


def _as_ref(reqs):
    return [JRequest(prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                     temperature=r.temperature, eos_id=r.eos_id,
                     request_id=r.request_id) for r in reqs]


def _mixed_requests(cfg, temperature=0.0):
    """Mixed queue: repetitive prompts (the drafter accepts) and random
    ones (it mostly rejects), varying lengths and budgets."""
    rng = np.random.default_rng(3)
    pat = rng.integers(0, cfg.vocab, size=(4,)).astype(np.int32)
    prompts = [np.tile(pat, 3),
               rng.integers(0, cfg.vocab, size=(5,)).astype(np.int32),
               np.tile(pat, 2),
               rng.integers(0, cfg.vocab, size=(9,)).astype(np.int32),
               np.tile(rng.integers(0, cfg.vocab, size=(3,)), 4),
               rng.integers(0, cfg.vocab, size=(2,)).astype(np.int32)]
    budgets = (10, 7, 8, 5, 9, 6)
    return [Request(prompt=p.copy(), max_new_tokens=m,
                    temperature=temperature)
            for p, m in zip(prompts, budgets)]


def _prefix_requests(cfg, n, sys_len=18, suffix_len=2, max_new=4, seed=0):
    """Shared system prompt + unique per-request suffix, request_id
    pinned so sampled streams reproduce under solo serving."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, cfg.vocab, size=(sys_len,))
    return [Request(prompt=np.concatenate(
                        [system, rng.integers(0, cfg.vocab,
                                              size=(suffix_len,))]),
                    max_new_tokens=max_new, request_id=i)
            for i in range(n)]


def _midstream(engine, reqs):
    handles = [engine.submit(r) for r in reqs[:4]]
    for _ in range(3):
        engine.step()                              # mid-stream...
    handles += [engine.submit(r) for r in reqs[4:]]   # ...late arrivals
    engine.run()
    return [engine.scheduler.outputs[h] for h in handles]


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

def test_ngram_drafter_prompt_lookup():
    d = NgramDrafter(max_ngram=3)
    assert d.propose([1, 2, 3, 1, 2], k=2) == [3, 1]
    assert d.propose([1, 2, 3, 9, 2, 3], k=1) == [9]
    assert d.propose([7], k=4) == []
    assert d.propose([1, 2, 3], k=0) == []
    with pytest.raises(ValueError):
        NgramDrafter(max_ngram=0)


def test_drafter_registry():
    assert isinstance(get_drafter("ngram"), NgramDrafter)
    with pytest.raises(ValueError, match="unknown drafter"):
        get_drafter("tiny-model")


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_spec_greedy_equals_reference_and_per_token(setup, specs, kv):
    """Mixed repetitive/random prompts, requests arriving mid-stream:
    the speculative streams equal the reference's speculative engine's
    and the port's per-token engine's, on both cache dtypes."""
    cfg, tm, _, _ = setup
    t_spec, j_spec = specs[kv]
    kw = dict(batch_slots=2, max_seq=64)
    base = _midstream(_port(tm, kv_cache=t_spec, **kw),
                      _mixed_requests(cfg))
    eng = _port(tm, kv_cache=t_spec, spec_decode="ngram", spec_k=4, **kw)
    outs = _midstream(eng, _mixed_requests(cfg))
    assert outs == base
    ref = _ref(setup, kv_cache=j_spec, spec_decode="ngram", spec_k=4, **kw)
    assert outs == _midstream(ref, _as_ref(_mixed_requests(cfg)))
    m = eng.metrics.summary()
    assert m["spec_proposed"] > 0
    assert m["spec_accepted"] > 0, "repetitive prompts must accept"
    assert m["tokens_per_decode_step"] > 1.0
    rm = ref.metrics.summary()
    for key in ("spec_steps", "spec_proposed", "spec_accepted",
                "decode_steps"):
        assert m[key] == rm[key], key


def test_spec_sampled_identical(setup):
    """Deterministic sampling makes verification exact at temperature:
    the sampled speculative stream equals the per-token one."""
    cfg, tm, _, _ = setup
    reqs = lambda: _mixed_requests(cfg, temperature=30.0)[:4]
    base = _port(tm, batch_slots=2, max_seq=64, seed=7).generate(reqs())
    outs = _port(tm, batch_slots=2, max_seq=64, seed=7,
                 spec_decode="ngram", spec_k=3).generate(reqs())
    assert outs == base
    assert any(len(set(o)) > 1 for o in base), "temperature visible"


def test_spec_under_page_pressure(setup):
    """A pool too small for full verify windows: proposals are dropped
    and, when the pool is dry, the newest request is preempted and
    replayed; output equals the per-token engine's and the reference's."""
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(11)
    pat = rng.integers(0, cfg.vocab, size=(3,))
    reqs = lambda: [Request(prompt=np.tile(pat, 3), max_new_tokens=10),
                    Request(prompt=np.tile(pat, 2), max_new_tokens=10)]
    kw = dict(batch_slots=2, max_seq=24, page_size=4, num_pages=7)
    base = _port(tm, **kw).generate(reqs())
    eng = _port(tm, spec_decode="ngram", spec_k=4, **kw)
    outs = eng.generate(reqs())
    assert outs == base
    assert eng.cache.used_pages == 0
    assert outs == _ref(setup, spec_decode="ngram", spec_k=4,
                        **kw).generate(_as_ref(reqs()))


def test_rejected_window_leaves_cache_state_exact(setup):
    """Write-then-reject: a speculative window scattered into the pools
    (in place) and rolled back leaves the next decode's logits equal and
    does not churn the page pool."""
    cfg, tm, _, _ = setup
    eng = _port(tm, batch_slots=2, max_seq=64)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab, size=(6,))
    eng.submit(Request(prompt=prompt, max_new_tokens=8))
    eng.step()                              # prefill + one decode step
    st = eng.scheduler.slots[0]
    B, L = eng.B, st.length

    def probe_logits():
        # rewrites the pending token at L (scatter before gather): the
        # same value the next decode step writes
        toks = np.zeros((B, 1), np.int64)
        toks[0, 0] = st.entry.seq[-1]
        lens = np.zeros((B,), np.int64)
        lens[0] = L
        return eng._step(toks, eng.cache.device_table(), lens)[0, 0]

    before = probe_logits()
    assert eng.cache.reserve(0, L + 4)
    free_after_reserve = len(eng.cache.free)
    toks = np.zeros((B, 4), np.int64)
    toks[0] = (np.asarray(st.entry.seq[-1]) + np.arange(4) + 1) % cfg.vocab
    lens = np.zeros((B,), np.int64)
    lens[0] = L
    eng._step(toks, eng.cache.device_table(), lens)   # garbage written...
    eng.cache.rollback(0, L)                          # ...then rolled back
    assert len(eng.cache.free) == free_after_reserve, "no pool churn"
    assert torch.equal(before, probe_logits())
    eng.run()                               # the engine still completes


class _OracleDrafter(FixedDrafter):
    """Proposes the exact continuation stream: every draft is accepted,
    pinning EOS inside an accepted window."""

    def __init__(self, prompt_len: int, stream):
        super().__init__(stream)
        self.prompt_len = prompt_len

    def propose(self, seq, k, request_id=0):
        n_gen = len(seq) - self.prompt_len
        return self.tokens[n_gen:n_gen + k]


def test_eos_inside_accepted_window_terminates_and_frees(setup):
    """EOS accepted mid-window ends the request there: later emitted
    tokens are discarded, the slot and its pages free (a sampled stream,
    exact under speculation, with an oracle drafter)."""
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab, size=(6,))
    mk = lambda eos=None: [Request(prompt=prompt, max_new_tokens=10,
                                   temperature=25.0, eos_id=eos)]
    base = _port(tm, batch_slots=1, max_seq=64, seed=7).generate(mk())[0]
    idx, eos = next((i, t) for i, t in enumerate(base)
                    if 1 <= i <= 4 and t not in base[:i])
    eng = _port(tm, batch_slots=1, max_seq=64, seed=7,
                spec_decode=_OracleDrafter(len(prompt), base), spec_k=4)
    outs = eng.generate(mk(eos))
    assert outs[0] == base[:idx + 1]
    assert eng.metrics.spec_accepted >= idx, "EOS was an accepted draft"
    assert eng.cache.used_pages == 0
    assert eng.scheduler.active_slots() == []
    assert not eng.scheduler.has_work()


def test_zero_proposals_degrade_to_per_token_path(setup):
    cfg, tm, _, _ = setup
    reqs = lambda: _mixed_requests(cfg)[:3]
    base_eng = _port(tm, batch_slots=2, max_seq=64)
    base = base_eng.generate(reqs())
    eng = _port(tm, batch_slots=2, max_seq=64,
                spec_decode=FixedDrafter([]), spec_k=4)
    assert eng.generate(reqs()) == base
    m = eng.metrics.summary()
    assert m["spec_steps"] == 0 and m["spec_proposed"] == 0
    assert m["decode_steps"] == base_eng.metrics.summary()["decode_steps"]
    assert m["tokens_per_decode_step"] == 1.0


def test_acceptance_metrics_sanity(setup):
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(13)
    pat = rng.integers(0, cfg.vocab, size=(4,))
    eng = _port(tm, batch_slots=2, max_seq=64, spec_decode="ngram",
                spec_k=3)
    outs = eng.generate([Request(prompt=np.tile(pat, 3), max_new_tokens=9),
                         Request(prompt=np.tile(pat, 2), max_new_tokens=7)])
    m = eng.metrics.summary()
    assert m["total_tokens"] == sum(len(o) for o in outs) == 16
    assert m["spec_steps"] >= 1
    assert m["spec_accepted"] <= m["spec_proposed"]
    assert 0.0 <= m["acceptance_rate"] <= 1.0
    assert 1.0 <= m["tokens_per_decode_step"] <= 1.0 + eng.spec_k
    plain = _port(tm, batch_slots=1, max_seq=32)
    plain.generate([Request(prompt=pat, max_new_tokens=2)])
    s = plain.metrics.summary()
    assert s["spec_steps"] == 0 and np.isnan(s["acceptance_rate"])
    assert s["tokens_per_decode_step"] == 1.0


def test_spec_decode_guards(setup):
    _, tm, _, _ = setup
    with pytest.raises(NotImplementedError, match="paged"):
        _port(tm, batch_slots=1, max_seq=32, mode="static",
              spec_decode="ngram")
    with pytest.raises(ValueError, match="spec_k"):
        _port(tm, batch_slots=1, max_seq=32, spec_decode="ngram", spec_k=0)


# ---------------------------------------------------------------------------
# prefix caching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_shared_prefix_equals_reference_and_solo(setup, specs, kv):
    """Shared-prefix batch == the reference's shared-prefix batch ==
    unshared solo serving, fp AND int8 (a shared int8 page holds the
    quantized KV the attaching request would have written)."""
    cfg, tm, _, _ = setup
    t_spec, j_spec = specs[kv]
    reqs = _prefix_requests(cfg, 4)
    eng = _port(tm, batch_slots=2, max_seq=32, kv_cache=t_spec,
                prefix_cache=True)
    outs = eng.generate(reqs)
    solo = _port(tm, batch_slots=1, max_seq=32, kv_cache=t_spec)
    for i, r in enumerate(reqs):
        assert outs[i] == solo.generate([r])[0], \
            f"request {i} diverged under sharing ({kv})"
    ref = _ref(setup, batch_slots=2, max_seq=32, kv_cache=j_spec,
               prefix_cache=True)
    assert outs == ref.generate(_as_ref(reqs))
    assert eng.metrics.prefix_hit_rate == ref.metrics.prefix_hit_rate > 0
    assert eng.cache.cached_pages == ref.cache.cached_pages > 0
    assert eng.cache.used_pages == 0


def test_repeat_prompt_skips_prefill_chunks(setup):
    cfg, tm, _, _ = setup
    req = _prefix_requests(cfg, 1, sys_len=22)[0]
    eng = _port(tm, batch_slots=2, max_seq=32, prefix_cache=True)
    eng.generate([req])
    cold_chunks = eng.metrics.summary()["prefill_chunks"]
    eng.reset_metrics()
    out_warm = eng.generate([req])[0]
    m = eng.metrics
    assert m.summary()["prefill_chunks"] < cold_chunks
    assert m.prefix_hit_rate == pytest.approx(23 / 24)
    assert out_warm == _port(tm, batch_slots=1, max_seq=32).generate(
        [req])[0]


def test_preemption_under_sharing_equals_reference_and_solo(setup):
    cfg, tm, _, _ = setup
    reqs = _prefix_requests(cfg, 3, sys_len=10, suffix_len=2, max_new=12)
    kw = dict(batch_slots=2, max_seq=24, page_size=4, num_pages=9,
              prefix_cache=True)
    eng = _port(tm, **kw)
    outs = eng.generate(reqs)
    assert eng.metrics.preemptions >= 1
    solo = _port(tm, batch_slots=1, max_seq=24, page_size=4)
    for i, r in enumerate(reqs):
        assert outs[i] == solo.generate([r])[0], \
            f"request {i} diverged under preemption + sharing"
    ref = _ref(setup, **kw)
    assert outs == ref.generate(_as_ref(reqs))
    assert eng.metrics.preemptions == ref.metrics.preemptions


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_spec_decode_under_sharing(setup, specs, kv):
    """Speculation + prefix sharing: rollback garbage lands only in pages
    no other request maps, so the streams equal the per-token unshared
    ones and the reference's, fp and int8."""
    cfg, tm, _, _ = setup
    t_spec, j_spec = specs[kv]
    rng = np.random.default_rng(3)
    pat = rng.integers(0, cfg.vocab, size=(4,)).astype(np.int32)
    system = np.tile(pat, 3)
    reqs = [Request(prompt=np.concatenate(
                        [system, rng.integers(0, cfg.vocab, size=(2,))]),
                    max_new_tokens=8, request_id=i) for i in range(3)]
    kw = dict(batch_slots=2, max_seq=32, prefix_cache=True,
              spec_decode="ngram", spec_k=4)
    eng = _port(tm, kv_cache=t_spec, **kw)
    outs = eng.generate(reqs)
    base = _port(tm, batch_slots=1, max_seq=32, kv_cache=t_spec)
    for i, r in enumerate(reqs):
        assert outs[i] == base.generate([r])[0], \
            f"request {i} diverged under speculation + sharing ({kv})"
    assert outs == _ref(setup, kv_cache=j_spec, **kw).generate(
        _as_ref(reqs))
    assert eng.metrics.summary()["acceptance_rate"] > 0
    assert eng.metrics.prefix_hit_rate > 0


# ---------------------------------------------------------------------------
# the engine's constructor
# ---------------------------------------------------------------------------

def test_legacy_kwargs_equal_config_and_warn_once(setup):
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=(6,)),
                    max_new_tokens=4, request_id=i) for i in range(2)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy = ServingEngine(tm, batch_slots=2, max_seq=32, page_size=4,
                               seed=7)
    assert sum(issubclass(w.category, DeprecationWarning)
               for w in caught) == 1
    assert "ServingConfig" in str(caught[0].message)
    new = _port(tm, batch_slots=2, max_seq=32, page_size=4, seed=7)
    assert legacy.generate(reqs) == new.generate(reqs)
    assert legacy.config == new.config
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("ignore")
        pos = ServingEngine(tm, 2, 32, page_size=4, seed=7)
    assert pos.config == new.config


def test_config_plus_loose_kwargs_rejected(setup):
    _, tm, _, _ = setup
    sc = ServingConfig(batch_slots=1, max_seq=16)
    with pytest.raises(TypeError, match="ambiguous"):
        ServingEngine(tm, sc, page_size=4)
    with pytest.raises(TypeError, match="ambiguous"):
        ServingEngine(tm, sc, max_seq=16)
    with pytest.raises(TypeError, match="ServingConfig"):
        ServingEngine(tm, "paged")
    with pytest.raises(TypeError, match="batch_slots"):
        ServingEngine(tm)
