"""Port parity for the serving engine (``repro_torch.serve``) on the
scenarios of ``tests/test_serving.py``: continuous batching, per-request
termination, EOS, preemption, the static fallback and its pad masking.

The reference engine serves the same requests with the same weights
(carried across by ``load_reference_params``), once per scenario; the
port's greedy streams must equal its streams token for token, with the fp
cache and with the SIRA-int8 cache (each package derives its own spec from
the same weights; ``tests/test_torch_kv_cache.py`` holds the two specs
equal).  The port must also hold its own invariant: a request's stream is
the same served alone as packed into a busy batch.

Sampled streams (temperature > 0) are held to that invariant only: the
reference keys its sampler on ``jax.random``, which the port cannot
reproduce, so it re-keys (``serve.engine.gumbel_noise``).
"""
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
from repro_torch.models.transformer import Model
from repro_torch.quant.quantizer import QuantSpec
from repro_torch.serve import (Request, ServingConfig, ServingEngine,
                               derive_kv_spec)
from repro_torch.serve.engine import gumbel_noise

ARCH = "qwen2-1.5b"


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config(ARCH, reduced=True)
    jm = j_get_model(jcfg)
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


def _solo(tm, req: Request, max_seq=32, **kw):
    eng = _port(tm, batch_slots=1, max_seq=max_seq, **kw)
    return eng.generate([Request(prompt=req.prompt,
                                 max_new_tokens=req.max_new_tokens)])[0]


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def test_batched_generation(setup):
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=(5,)),
                    max_new_tokens=4) for _ in range(3)]
    outs = _port(tm, batch_slots=3, max_seq=64).generate(reqs)
    assert len(outs) == 3
    assert all(len(o) == 4 for o in outs)
    assert all(0 <= t < cfg.vocab_padded for o in outs for t in o)
    assert outs == _ref(setup, batch_slots=3,
                        max_seq=64).generate(_as_ref(reqs))


def test_generation_deterministic_greedy(setup):
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab, size=(6,))
    outs = [_port(tm, batch_slots=1, max_seq=32).generate(
        [Request(prompt=prompt, max_new_tokens=5)])[0] for _ in range(2)]
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

def _continuous(engine, reqs):
    handles = [engine.submit(r) for r in reqs[:4]]
    for _ in range(3):
        engine.step()                              # mid-stream...
    handles += [engine.submit(r) for r in reqs[4:]]   # ...late arrivals
    engine.run()
    return [engine.scheduler.outputs[h] for h in handles]


@pytest.mark.parametrize("kv", ["fp", "int8"])
def test_continuous_batching_equals_reference_and_solo(setup, specs, kv):
    """Queue deeper than the slot count, mixed lengths, requests arriving
    mid-stream: every greedy stream equals the reference engine's, and
    equals the port serving that request alone — for the fp cache AND
    the int8 cache."""
    cfg, tm, _, _ = setup
    t_spec, j_spec = specs[kv]
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab,
                                        size=(int(n),)).astype(np.int32),
                    max_new_tokens=int(m))
            for n, m in [(9, 4), (3, 6), (5, 3), (2, 5), (7, 4), (4, 2)]]
    outs = _continuous(_port(tm, batch_slots=2, max_seq=32,
                             kv_cache=t_spec), reqs)
    want = _continuous(_ref(setup, batch_slots=2, max_seq=32,
                            kv_cache=j_spec), _as_ref(reqs))
    assert outs == want
    for i, r in enumerate(reqs):
        assert len(outs[i]) == r.max_new_tokens
        assert outs[i] == _solo(tm, r, kv_cache=t_spec), \
            f"request {i} diverged from solo serving"


def test_per_request_termination_and_slot_reuse(setup):
    """More requests than slots with different max_new_tokens: each stops
    at its own limit, finished slots are reused, FIFO admission starves
    nobody, and the streams equal the reference engine's."""
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(5)
    lens = [2, 9, 3, 7, 1, 5]
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=(4,)),
                    max_new_tokens=m) for m in lens]
    eng = _port(tm, batch_slots=2, max_seq=32)
    outs = eng.generate(reqs)
    assert [len(o) for o in outs] == lens
    assert eng.scheduler._admit_counter == 6
    assert not eng.scheduler.has_work()
    assert eng.cache.used_pages == 0
    assert outs == _ref(setup, batch_slots=2,
                        max_seq=32).generate(_as_ref(reqs))


def test_eos_stops_request(setup):
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, size=(5,))
    base = _port(tm, batch_slots=1, max_seq=32).generate(
        [Request(prompt=prompt, max_new_tokens=8)])[0]
    eos = base[2]
    reqs = [Request(prompt=prompt, max_new_tokens=8, eos_id=eos),
            Request(prompt=prompt, max_new_tokens=8)]
    outs = _port(tm, batch_slots=2, max_seq=32).generate(reqs)
    assert outs[0] == base[:base.index(eos) + 1]   # EOS included
    assert outs[1] == base                         # batchmate unaffected
    assert outs == _ref(setup, batch_slots=2,
                        max_seq=32).generate(_as_ref(reqs))


def test_preemption_requeues_and_completes(setup):
    """A page pool too small for both requests forces the scheduler to
    preempt the newest one; it is replayed, completes, and both streams
    equal the reference engine's under the same pressure."""
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(11)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=(6,)),
                    max_new_tokens=10) for _ in range(2)]
    kw = dict(batch_slots=2, max_seq=24, page_size=4, num_pages=7)
    eng = _port(tm, **kw)
    outs = eng.generate(reqs)
    assert eng.metrics.preemptions >= 1
    assert all(len(o) == 10 for o in outs)
    ref = _ref(setup, **kw)
    assert outs == ref.generate(_as_ref(reqs))
    assert eng.metrics.preemptions == ref.metrics.preemptions


def test_metrics_sanity(setup):
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(13)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=(4,)),
                    max_new_tokens=m) for m in (3, 6, 4)]
    eng = _port(tm, batch_slots=2, max_seq=32)
    outs = eng.generate(reqs)
    m = eng.metrics.summary()
    assert m["requests"] == 3
    assert m["total_tokens"] == sum(len(o) for o in outs) == 13
    assert m["prefill_chunks"] >= 3
    assert m["tokens_per_s"] > 0
    assert 0 < m["slot_occupancy"] <= 1
    ttfts = [r.ttft for r in eng.metrics.requests.values()]
    assert all(t is not None and t >= 0 for t in ttfts)
    assert m["mean_token_latency_s"] >= 0
    ref = _ref(setup, batch_slots=2, max_seq=32)
    ref.generate(_as_ref(reqs))
    assert set(m) == set(ref.metrics.summary())
    for key in ("requests", "total_tokens", "decode_steps",
                "prefill_chunks", "slot_occupancy"):
        assert m[key] == ref.metrics.summary()[key], key


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_sampling_is_deterministic_per_request(setup):
    """Temperature sampling depends on (seed, request_id, token index)
    alone: the same request packed with others or served alone draws the
    same stream; another engine seed draws another."""
    _, tm, _, _ = setup
    mk = lambda: Request(prompt=np.asarray([5, 9, 2]), max_new_tokens=6,
                         temperature=50.0, request_id=99)
    other = lambda: Request(prompt=np.asarray([1, 2, 3, 4]),
                            max_new_tokens=9, temperature=30.0)
    packed = _port(tm, batch_slots=3, max_seq=32,
                   seed=7).generate([other(), mk(), other()])
    alone = _port(tm, batch_slots=1, max_seq=32, seed=7).generate([mk()])
    assert packed[1] == alone[0]
    assert len(set(alone[0])) > 1, "temperature high enough that keys matter"
    reseed = _port(tm, batch_slots=1, max_seq=32, seed=8).generate([mk()])
    assert reseed[0] != alone[0]


def test_gumbel_noise_is_a_function_of_its_key():
    a = gumbel_noise(7, 99, 3, 1000)
    assert a.dtype == torch.float32 and a.shape == (1000,)
    assert torch.equal(a, gumbel_noise(7, 99, 3, 1000))
    for key in ((8, 99, 3), (7, 98, 3), (7, 99, 4)):
        assert not torch.equal(a, gumbel_noise(*key, 1000))
    # standard Gumbel: mean = Euler's constant, variance = pi^2 / 6
    big = gumbel_noise(0, 0, 0, 200000).double()
    assert abs(float(big.mean()) - 0.5772) < 0.01
    assert abs(float(big.var()) - np.pi ** 2 / 6) < 0.03


def test_sampler_rows_are_independent_of_their_batch(setup):
    """A row's sampled token depends on its own key and logits only: the
    same row sampled alone or among others gives the same token, and a
    greedy row is the argmax."""
    _, tm, _, _ = setup
    eng = _port(tm, batch_slots=1, max_seq=32, seed=3)
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(4, 50)).astype(np.float32))
    temps = np.array([0.0, 2.0, 0.5, 2.0], np.float32)
    rids = np.array([1, 2, 3, 2])
    steps = np.array([0, 5, 1, 6])
    together = eng._sample(logits, temps, rids, steps)
    for i in range(4):
        assert eng._sample(logits[i:i + 1], temps[i:i + 1], rids[i:i + 1],
                           steps[i:i + 1])[0] == together[i]
    assert together[0] == int(logits[0].argmax())


# ---------------------------------------------------------------------------
# static fallback path + left-pad masking
# ---------------------------------------------------------------------------

def test_padded_batch_matches_solo(setup):
    """The twin of the reference's pad-masking regression, with its
    tolerance relative to the logit scale (``atol = 1e-5 · max|logits|``;
    the reference's absolute 1e-5 is missed by one element on logits of
    about 12, reference fault 4): a short prompt left-padded into a batch
    computes what it computes served alone."""
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(3)
    long_p = rng.integers(0, cfg.vocab, size=(9,)).astype(np.int32)
    short_p = rng.integers(0, cfg.vocab, size=(3,)).astype(np.int32)

    def prefill(toks, valid_from, B, S=32):
        cache = tm.init_cache(B, S)
        logits = None
        with torch.inference_mode():
            for t in range(toks.shape[1]):
                logits, cache = tm.decode_step(
                    torch.as_tensor(toks[:, t:t + 1], dtype=torch.long),
                    cache, t, valid_from=valid_from)
        return logits[:, -1].float().numpy()

    solo = prefill(short_p[None, :], torch.zeros((1,), dtype=torch.long), 1)
    L = len(long_p)
    toks = np.zeros((2, L), np.int32)
    toks[0] = long_p
    toks[1, L - len(short_p):] = short_p            # left-pad
    valid_from = torch.tensor([0, L - len(short_p)])
    fixed = prefill(toks, valid_from, 2)
    scale = np.abs(solo[0][:cfg.vocab]).max()
    np.testing.assert_allclose(fixed[1], solo[0], rtol=0, atol=1e-5 * scale)
    # without masking the pad garbage visibly corrupts the logits
    buggy = prefill(toks, None, 2)
    assert np.abs(buggy[1] - solo[0]).max() > 1e-3

    # end to end on the static engine: batched mixed-length == solo, and
    # both streams equal the reference static engine's
    reqs = [Request(prompt=long_p, max_new_tokens=4),
            Request(prompt=short_p, max_new_tokens=4)]
    outs = _port(tm, batch_slots=2, max_seq=32, mode="static").generate(
        reqs)
    solo_short = _port(tm, batch_slots=1, max_seq=32,
                       mode="static").generate([reqs[1]])[0]
    assert outs[1] == solo_short
    assert outs == _ref(setup, batch_slots=2, max_seq=32,
                        mode="static").generate(_as_ref(reqs))


def test_static_mode_matches_paged_greedy(setup):
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, cfg.vocab, size=(6,))
    req = [Request(prompt=prompt, max_new_tokens=8)]
    o_s = _port(tm, batch_slots=1, max_seq=32, mode="static").generate(req)
    o_p = _port(tm, batch_slots=1, max_seq=32).generate(req)
    assert o_s == o_p


def test_static_mode_eos_and_per_slot_stop(setup):
    """The static path honours eos_id and per-request max_new_tokens: a
    finished row stops accumulating and the loop exits when every row is
    done; the streams equal the reference static engine's."""
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(19)
    prompt = rng.integers(0, cfg.vocab, size=(5,))
    base = _port(tm, batch_slots=1, max_seq=32, mode="static").generate(
        [Request(prompt=prompt, max_new_tokens=6)])[0]
    eos = base[1]
    reqs = [Request(prompt=prompt, max_new_tokens=6, eos_id=eos),
            Request(prompt=prompt, max_new_tokens=3)]
    outs = _port(tm, batch_slots=2, max_seq=32, mode="static").generate(
        reqs)
    assert outs[0] == base[:base.index(eos) + 1]
    assert outs[1] == base[:3]
    assert outs == _ref(setup, batch_slots=2, max_seq=32,
                        mode="static").generate(_as_ref(reqs))


def test_static_mode_rejects_overlong_requests(setup):
    _, tm, _, _ = setup
    eng = _port(tm, batch_slots=1, max_seq=16, mode="static")
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate([Request(prompt=np.arange(10), max_new_tokens=10)])


def test_mixed_length_rejected_for_unmaskable_families():
    """SSM state updates cannot mask pad tokens retroactively: the static
    engine refuses mixed-length batches, and paged mode refuses the
    family (before any weight is touched)."""
    model = get_model(get_config("mamba2-780m", reduced=True), device="cpu")
    eng = ServingEngine(model, ServingConfig(batch_slots=2, max_seq=32))
    assert eng.mode == "static"
    with pytest.raises(NotImplementedError, match="mixed-length"):
        eng.generate([Request(prompt=np.arange(5), max_new_tokens=1),
                      Request(prompt=np.arange(2), max_new_tokens=1)])
    with pytest.raises(NotImplementedError, match="full-context"):
        ServingEngine(model, ServingConfig(batch_slots=2, max_seq=32,
                                           mode="paged"))


def test_quantized_serving_close_to_fp(setup):
    """w8a8 fake-quant serving agrees with fp on most greedy tokens."""
    cfg, tm, _, _ = setup
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab, size=(6,))
    req = [Request(prompt=prompt, max_new_tokens=6)]
    o_fp = _port(tm, batch_slots=1, max_seq=32).generate(req)[0]
    o_q8 = _port(tm, batch_slots=1, max_seq=32,
                 quant=QuantSpec(bits=8)).generate(req)[0]
    agree = sum(a == b for a, b in zip(o_fp, o_q8)) / len(o_fp)
    assert agree >= 0.5, (o_fp, o_q8)


# ---------------------------------------------------------------------------
# no quiet CPU path
# ---------------------------------------------------------------------------

def test_cuda_model_without_a_card_raises(monkeypatch):
    """A model placed on the card serves there or raises: with no card
    the engine refuses at construction (no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Model(get_config(ARCH, reduced=True), torch.device("cuda"))
    for mode in ("paged", "static"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServingEngine(model, ServingConfig(batch_slots=1, max_seq=16,
                                               mode=mode))
