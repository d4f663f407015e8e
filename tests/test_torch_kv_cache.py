"""Port parity for the serving path's model half and its cache:
``paged_attention``, ``Model.decode_paged``, ``derive_kv_spec``,
``PrefixIndex``, ``PagedKVCache`` and ``ServingConfig`` against the JAX
package, on the same numpy inputs and the same weights (initialised by
the reference, carried across by ``load_reference_params``), on the CPU.

Tolerances, float32:
  * ``paged_attention`` outputs: ``1e-5 · max|y|`` (float32 products
    summed in another order); the pools after the write: the fp pools'
    written rows within ``1e-6`` of their scale (each package rounds its
    own K/V projection), every other row equal; int8 pools equal (a ±1
    step at a rounding tie would be counted; it is 0 on these seeds);
  * ``decode_paged`` logits: ``1e-4 · max|logits|``, the bar of the
    port's other whole-model tests;
  * SIRA scales and bounds: ``rtol=1e-6`` (the analysis is numpy in both
    packages);
  * cache bookkeeping: equal, operation by operation.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import get_model as j_get_model
from repro.serve import kv_cache as j_kv
from repro.serve import ServingConfig as JServingConfig
from repro_torch.configs import get_config, list_archs
from repro_torch.models import attention as t_attn
from repro_torch.models import get_model
from repro_torch.serve import (KVCacheSpec, PagedKVCache, PrefixIndex,
                               ServingConfig, derive_kv_spec,
                               observe_block_inputs)

_MODELS = {}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch):
    """(reference model, its params, the port's model with the same
    weights) of the reduced ``arch``, cached."""
    if arch not in _MODELS:
        jm = j_get_model(j_get_config(arch, reduced=True))
        params = jm.init(jax.random.PRNGKey(0))
        tm = get_model(get_config(arch, reduced=True), device="cpu")
        tm.load_reference_params(_np_tree(params))
        _MODELS[arch] = (jm, params, tm)
    return _MODELS[arch]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# --------------------------------------------------------------------------
# paged_attention
# --------------------------------------------------------------------------

PAGE = 4
N_PAGES = 3                   # logical pages per slot: S_v = 12
POOL = 10                     # physical pages, page 0 the trash page


def _paged_inputs(cfg, T, int8, seed):
    """B = 3 slots: slot 0 at length 2, slot 1 idle (length 0, its table
    all trash), slot 2 at length S_v - 2, so a chunk of T > 2 runs past
    the table into the trash page."""
    rng = np.random.default_rng(seed)
    KV, hd = cfg.n_kv_heads, cfg.hd
    shape = (POOL, PAGE, KV, hd)
    if int8:
        kp = rng.integers(-127, 128, size=shape).astype(np.int8)
        vp = rng.integers(-127, 128, size=shape).astype(np.int8)
    else:
        kp = rng.normal(size=shape).astype(np.float32)
        vp = rng.normal(size=shape).astype(np.float32)
    table = np.array([[1, 2, 3], [0, 0, 0], [4, 5, 6]], np.int32)
    lengths = np.array([2, 0, N_PAGES * PAGE - 2], np.int32)
    x = rng.normal(size=(3, T, cfg.d_model)).astype(np.float32)
    ks = vs = None
    if int8:
        ks = rng.uniform(0.02, 0.05, size=(KV,))
        vs = rng.uniform(0.02, 0.05, size=(KV,))
    return x, kp, vp, table, lengths, ks, vs


def jp_unwritten(table, lengths, T):
    """(POOL, PAGE) mask of the pool rows a call at ``lengths`` with T
    tokens per slot does not write."""
    mask = np.ones((POOL, PAGE), bool)
    for b in range(len(lengths)):
        for pos in lengths[b] + np.arange(T):
            if pos < N_PAGES * PAGE:
                mask[table[b, pos // PAGE], pos % PAGE] = False
            else:
                mask[0, 0] = False
    return mask


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("T", [1, 5, 8])
def test_paged_attention_matches_reference(T, int8):
    jm, params, tm = _pair("qwen2-1.5b")
    cfg = tm.cfg
    x, kp, vp, table, lengths, ks, vs = _paged_inputs(cfg, T, int8,
                                                      seed=T)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, hd=cfg.hd,
              theta=cfg.rope_theta, page_size=PAGE, k_scale=ks,
              v_scale=vs)
    jp = jax.tree.map(lambda a: a[0], params["layers"])["attn"]
    jy, jk, jv = j_attn.paged_attention(
        jp, jnp.asarray(x), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths), **kw)
    tk, tv = _t(kp), _t(vp)
    ty, rk, rv = t_attn.paged_attention(
        tm.params["layers"][0]["attn"], _t(x), tk, tv, _t(table),
        _t(lengths), **kw)
    assert rk is tk and rv is tv, "the pools are written in place"
    # the idle slot reads the trash page, whose content depends on which
    # of several writes landed: compare the live slots, and every page
    # but the trash page
    live = [0, 2]
    jy = np.asarray(jy)[live]
    scale = np.abs(jy).max()
    np.testing.assert_allclose(ty.numpy()[live], jy, rtol=0,
                               atol=1e-5 * scale)
    for got, want in ((tk, jk), (tv, jv)):
        got, want = got.numpy()[1:], np.asarray(want)[1:]
        if int8:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max(initial=0) <= 1
            assert int((diff == 1).sum()) == 0, \
                f"{int((diff == 1).sum())} int8 entries one step apart"
        else:
            # the written K/V are float32 projections of the same inputs,
            # each package's own rounding; every other entry is equal
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
            same = np.asarray(jp_unwritten(table, lengths, T))
            np.testing.assert_array_equal(got[same[1:]], want[same[1:]])
    # the chunk was written where the table says, and only there
    pos = lengths[0] + np.arange(T)
    k_written = tk.numpy()[table[0, pos // PAGE], pos % PAGE]
    assert not np.array_equal(k_written, kp[table[0, pos // PAGE],
                                            pos % PAGE])
    untouched = [p for p in range(1, POOL) if p not in table]
    np.testing.assert_array_equal(tk.numpy()[untouched], kp[untouched])


def test_paged_attention_past_the_table_goes_to_the_trash_page():
    """A chunk that runs past the table writes its tail to page 0, row 0,
    never onto the last live page (a clamped gather would)."""
    _, _, tm = _pair("qwen2-1.5b")
    cfg = tm.cfg
    x, kp, vp, table, lengths, _, _ = _paged_inputs(cfg, 8, False, seed=0)
    tk = _t(kp)
    t_attn.paged_attention(
        tm.params["layers"][0]["attn"], _t(x)[2:], tk, _t(vp),
        _t(table)[2:], _t(lengths)[2:], n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, hd=cfg.hd, theta=cfg.rope_theta,
        page_size=PAGE)
    # positions 10, 11 land on page 6 rows 2, 3; 12..17 on page 0 row 0
    last = table[2, -1]
    np.testing.assert_array_equal(tk.numpy()[last, :2], kp[last, :2])
    assert not np.array_equal(tk.numpy()[last, 2:], kp[last, 2:])
    np.testing.assert_array_equal(tk.numpy()[0, 1:], kp[0, 1:])
    assert not np.array_equal(tk.numpy()[0, 0], kp[0, 0])


# --------------------------------------------------------------------------
# Model.decode_paged
# --------------------------------------------------------------------------

def _j_cache(jm, spec, slots, max_seq):
    return j_kv.PagedKVCache(jm.cfg, spec, slots, max_seq, page_size=PAGE)


def _spec_pair(jm, params, int8):
    """(reference spec, the port's): fp, or the reference's SIRA-int8
    spec carried across."""
    if not int8:
        return (j_kv.KVCacheSpec.all_fp(jm.cfg.n_layers),
                KVCacheSpec.all_fp(jm.cfg.n_layers))
    js = j_kv.derive_kv_spec(jm, params)
    assert js.n_int8 == jm.cfg.n_layers
    return js, KVCacheSpec(tuple(
        dataclasses.replace(l) for l in js.layers))


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_decode_paged_matches_reference(arch, int8):
    """Chunked prefill of two slots (B=1 chunks of 4), then three batched
    decode steps (B=2, T=1) and one verify window (B=2, T=3), teacher
    forced: every call's logits within 1e-4 of the logit scale."""
    jm, params, tm = _pair(arch)
    cfg = tm.cfg
    js, ts = _spec_pair(jm, params, int8)
    jc = _j_cache(jm, js, 2, 32)
    tc = PagedKVCache(cfg, ts, 2, 32, page_size=PAGE, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)) for n in (10, 6)]
    scales = js.scales()
    for c in (jc, tc):
        for slot, p in enumerate(prompts):
            assert c.grow(slot, len(p) + 6)

    def both(toks, table_of, lens):
        jl, jc.pages = jm.decode_paged(
            params, jnp.asarray(toks, jnp.int32), jc.pages,
            jnp.asarray(table_of(jc)), jnp.asarray(lens, jnp.int32),
            page_size=PAGE, kv_scales=scales)
        with torch.inference_mode():
            tl, _ = tm.decode_paged(
                torch.as_tensor(toks, dtype=torch.long), tc.pages,
                torch.as_tensor(table_of(tc)), torch.as_tensor(lens),
                page_size=PAGE, kv_scales=scales)
        jl = np.asarray(jl)[..., :cfg.vocab]
        tl = tl.numpy()[..., :cfg.vocab]
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=1e-4 * np.abs(jl).max())

    for slot, p in enumerate(prompts):
        for start in range(0, len(p), 4):
            toks = np.zeros((1, 4), np.int64)
            chunk = p[start:start + 4]
            toks[0, :len(chunk)] = chunk
            both(toks, lambda c, s=slot: c.table[s:s + 1], [start])
    lens = np.array([len(p) for p in prompts])
    for _ in range(3):
        both(rng.integers(0, cfg.vocab, size=(2, 1)), lambda c: c.table,
             lens)
        lens = lens + 1
    both(rng.integers(0, cfg.vocab, size=(2, 3)), lambda c: c.table, lens)


@pytest.mark.parametrize("arch", list_archs())
def test_supports_paged_and_refusal(arch):
    """Every config: the same ``supports_paged`` as the reference, and a
    config that does not support it refuses ``decode_paged`` with the
    reference's error (before touching any weight)."""
    jm = j_get_model(j_get_config(arch, reduced=True))
    tm = get_model(get_config(arch, reduced=True), device="cpu")
    assert tm.supports_paged == jm.supports_paged
    if tm.supports_paged:
        return
    toks = torch.zeros((1, 1), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="full-context"):
        tm.decode_paged(toks, [], torch.zeros((1, 1), dtype=torch.int32),
                        torch.zeros((1,), dtype=torch.long), page_size=4)
    with pytest.raises(NotImplementedError, match="full-context"):
        jm.decode_paged(None, jnp.zeros((1, 1), jnp.int32), [],
                        jnp.zeros((1, 1), jnp.int32),
                        jnp.zeros((1,), jnp.int32), page_size=4)


# --------------------------------------------------------------------------
# derive_kv_spec
# --------------------------------------------------------------------------

def _assert_specs_equal(ts, js):
    assert len(ts.layers) == len(js.layers)
    assert ts.n_int8 == js.n_int8
    for tl, jl in zip(ts.layers, js.layers):
        assert tl.int8 == jl.int8
        assert tl.reason == jl.reason
        for name in ("k_scale", "v_scale", "k_amax", "v_amax"):
            a, b = getattr(tl, name), getattr(jl, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("kw", [
    dict(), dict(domain="affine"), dict(max_step=1e-6),
    dict(x_range=(-2.0, 3.0), a_bits=6), dict(calibrated=True)],
    ids=["interval", "affine", "fp_fallback", "x_range", "calibrated"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_derive_kv_spec_matches_reference(arch, kw):
    jm, params, tm = _pair(arch)
    kw = dict(kw)
    if kw.pop("calibrated", False):
        rng = np.random.default_rng(0)
        kw["calib_token_batches"] = [
            rng.integers(0, tm.cfg.vocab, size=(2, 16))]
    js = j_kv.derive_kv_spec(jm, params, **kw)
    ts = derive_kv_spec(tm, **kw)
    _assert_specs_equal(ts, js)
    if kw.get("max_step") == 1e-6:
        assert ts.n_int8 == 0
        assert all("max_step" in l.reason for l in ts.layers)
        assert ts.scales() == [None] * tm.cfg.n_layers


def test_observe_block_inputs_matches_reference():
    jm, params, tm = _pair("qwen2-1.5b")
    toks = [np.random.default_rng(1).integers(0, 256, size=(2, 12))]
    want = j_kv.observe_block_inputs(jm, params, toks)
    got = observe_block_inputs(tm, toks)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5)


def test_int8_pool_sizes():
    """The int8 pool is a quarter of the float32 pool and half of the
    bfloat16 one; ``hbm_bytes`` counts the pools on their device."""
    jm, params, tm = _pair("qwen2-1.5b")
    cfg = tm.cfg
    spec = derive_kv_spec(tm)
    fp = PagedKVCache(cfg, KVCacheSpec.all_fp(cfg.n_layers), 2, 32,
                      device="cpu")
    i8 = PagedKVCache(cfg, spec, 2, 32, device="cpu")
    bf = PagedKVCache(cfg, KVCacheSpec.all_fp(cfg.n_layers), 2, 32,
                      fp_dtype=torch.bfloat16, device="cpu")
    assert i8.hbm_bytes() * 4 == fp.hbm_bytes() == 2 * bf.hbm_bytes()
    assert fp.hbm_bytes() == j_kv.PagedKVCache(
        jm.cfg, j_kv.KVCacheSpec.all_fp(cfg.n_layers), 2, 32).hbm_bytes()
    assert all(p["k"].dtype == torch.int8 for p in i8.pages)


# --------------------------------------------------------------------------
# PrefixIndex and PagedKVCache: the same operations, the same state
# --------------------------------------------------------------------------

class _TinyJ:
    n_layers = 2
    n_kv_heads = 2
    hd = 4
    dtype = jnp.float32


class _TinyT(_TinyJ):
    dtype = torch.float32


def _caches(**kw):
    kw.setdefault("page_size", 4)
    kw.setdefault("max_seq", 16)
    kw.setdefault("batch_slots", 2)
    kw.setdefault("prefix_cache", True)
    slots, max_seq = kw.pop("batch_slots"), kw.pop("max_seq")
    jc = j_kv.PagedKVCache(_TinyJ, j_kv.KVCacheSpec.all_fp(2), slots,
                           max_seq, **kw)
    tc = PagedKVCache(_TinyT, KVCacheSpec.all_fp(2), slots, max_seq,
                      device="cpu", **kw)
    # stamp every page with its own values so copies are visible
    stamp = np.arange(tc.num_pages, dtype=np.float32)[:, None, None, None]
    stamp = np.broadcast_to(stamp, tc.pages[0]["k"].shape).copy()
    for layer, (jp, tp) in enumerate(zip(jc.pages, tc.pages)):
        for name in ("k", "v"):
            vals = stamp + 100 * layer + (name == "v") * 1000
            jp[name] = jnp.asarray(vals)
            tp[name].copy_(torch.from_numpy(vals))
    return jc, tc


def _assert_same_state(jc, tc):
    np.testing.assert_array_equal(tc.table, jc.table)
    np.testing.assert_array_equal(tc.ref, jc.ref)
    assert tc.free == jc.free
    assert list(tc.lru) == list(jc.lru)
    assert tc.owned == jc.owned
    assert tc.forks == jc.forks
    assert (tc.used_pages, tc.cached_pages, tc.shared_pool_occupancy) == \
        (jc.used_pages, jc.cached_pages, jc.shared_pool_occupancy)
    if tc.index is not None:
        assert tc.index._page_of == jc.index._page_of
        assert tc.index._kids == jc.index._kids
    for jp, tp in zip(jc.pages, tc.pages):
        for name in ("k", "v"):
            np.testing.assert_array_equal(tp[name].numpy(),
                                          np.asarray(jp[name]))


def _random_ops(seed, n_ops=60):
    """A random sequence of the cache's operations, prompts drawn from a
    few shared heads so prefixes match."""
    rng = np.random.default_rng(seed)
    heads = [list(rng.integers(0, 5, size=8)) for _ in range(2)]
    ops = []
    for _ in range(n_ops):
        slot = int(rng.integers(0, 2))
        kind = rng.choice(["grow", "release", "attach", "register",
                           "prepare", "reserve"],
                          p=[0.3, 0.15, 0.2, 0.15, 0.1, 0.1])
        toks = heads[int(rng.integers(0, 2))][:int(rng.integers(2, 9))] + \
            list(rng.integers(0, 5, size=int(rng.integers(0, 6))))
        ops.append((str(kind), slot, toks, int(rng.integers(0, 16))))
    return ops


def _apply(cache, op):
    kind, slot, toks, n = op
    if kind == "grow":
        return cache.grow(slot, min(n + 1, 16))
    if kind == "release":
        return cache.release(slot)
    if kind == "attach":
        # as after admission: the slot maps private pages only
        if not cache.grow(slot, len(toks) + 1) or any(
                cache.ref[p] > 1 or cache.index.is_registered(p)
                for p in cache.owned[slot]):
            return None
        return cache.attach_prefix(slot, toks)
    if kind == "register":
        if cache.pages_for(len(toks)) > len(cache.owned[slot]):
            return None
        return cache.register_prefix(slot, toks)
    if kind == "prepare":
        return cache.prepare_write(slot, n)
    return cache.reserve(slot, n)


@pytest.mark.parametrize("seed", range(8))
def test_cache_operations_match_reference(seed):
    """The same random sequence of grow / release / attach_prefix /
    register_prefix / prepare_write / reserve leaves equal tables,
    refcounts, free lists, LRU order, prefix indexes, fork counts and
    page contents after every operation.  Odd seeds run a pool too small
    for both slots, so grow refuses and cached-free pages are reclaimed."""
    jc, tc = _caches(num_pages=7 if seed % 2 else 9)
    for op in _random_ops(seed):
        assert _apply(tc, op) == _apply(jc, op), op
        _assert_same_state(jc, tc)


def test_prefix_index_matches_reference():
    ji, ti = j_kv.PrefixIndex(), PrefixIndex()
    a, b, c = (1, 2, 3, 4), (5, 6, 7, 8), (5, 6, 0, 0)
    for idx in (ji, ti):
        idx.register([a, b], [10, 11])
        idx.register([a, c], [10, 12])
    for q in ([a, b], [a], [b], [b, a], [a, c]):
        assert ti.lookup(q) == ji.lookup(q)
    for n, chunks, tail in ((1, [a], (5, 6, 99)), (1, [a], (42,)),
                            (0, [], (1, 2, 9))):
        assert ti.partial_lookup(n, chunks, tail) == \
            ji.partial_lookup(n, chunks, tail)
    assert ti.register([a, (9,) * 4], [77, 13]) == \
        ji.register([a, (9,) * 4], [77, 13])
    assert ti.evict(10) == ji.evict(10)
    assert len(ti) == len(ji) == 0


def test_page_pool_refusal_and_sizing():
    jc, tc = _caches(prefix_cache=False, num_pages=7, max_seq=16)
    for c in (jc, tc):
        assert c.max_pages == 4 and 0 not in c.free
        assert c.grow(0, 8) and c.grow(1, 16)
        assert not c.grow(0, 16)                # the pool is dry
    _assert_same_state(jc, tc)
    with pytest.raises(AssertionError):
        PagedKVCache(_TinyT, KVCacheSpec.all_fp(2), 1, 16, page_size=4,
                     num_pages=4, device="cpu")
    assert PagedKVCache(_TinyT, KVCacheSpec.all_fp(2), 2, 16, page_size=4,
                        device="cpu").num_pages == 2 * 4 + 1


def test_device_tables_are_int32_copies():
    _, tc = _caches()
    tc.grow(0, 9)
    t = tc.device_table()
    assert t.dtype == torch.int32 and t.device.type == "cpu"
    tc.release(0)
    assert int(t[0, 0]) != 0, "a copy, not a view of the host table"
    assert tuple(tc.slot_table(1).shape) == (1, tc.max_pages)


def test_cuda_pool_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedKVCache(_TinyT, KVCacheSpec.all_fp(2), 1, 16)


# --------------------------------------------------------------------------
# ServingConfig
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw, match", [
    (dict(batch_slots=0, max_seq=16), "batch_slots"),
    (dict(batch_slots=1, max_seq=0), "max_seq"),
    (dict(batch_slots=1, max_seq=16, page_size=0), "page_size"),
    (dict(batch_slots=1, max_seq=16, prefill_chunk=0), "prefill_chunk"),
    (dict(batch_slots=1, max_seq=16, spec_k=0), "spec_k"),
    (dict(batch_slots=1, max_seq=16, kv_cache="int4"), "kv_cache"),
    (dict(batch_slots=1, max_seq=16, mode="pageless"), "mode"),
    (dict(batch_slots=1, max_seq=16, num_pages=1), "num_pages"),
    (dict(batch_slots=1, max_seq=16, mode="static",
          kv_cache="sira-int8"), "full-precision"),
    (dict(batch_slots=1, max_seq=16, mode="static", prefix_cache=True),
     "prefix_cache"),
])
def test_config_validation_matches_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        JServingConfig(**kw)
    with pytest.raises(ValueError, match=match):
        ServingConfig(**kw)


def test_config_mesh_waits_for_launch():
    """The reference takes a jax Mesh, the port a ``launch.mesh.Layout``;
    both raise ValueError naming ``mesh`` for anything else."""
    from repro_torch.launch.mesh import make_layout
    for mesh in ("tpu", object()):
        with pytest.raises(ValueError, match="mesh"):
            JServingConfig(batch_slots=1, max_seq=16, mesh=mesh)
        with pytest.raises(ValueError, match="mesh"):
            ServingConfig(batch_slots=1, max_seq=16, mesh=mesh)
    layout = make_layout((1, 1))
    assert ServingConfig(batch_slots=1, max_seq=16,
                         mesh=layout).mesh is layout
    sc = ServingConfig(batch_slots=2, max_seq=32)
    assert sc.replace(prefix_cache=True).prefix_cache
    with pytest.raises(ValueError, match="page_size"):
        sc.replace(page_size=0)
    assert dataclasses.asdict(sc) == dataclasses.asdict(
        JServingConfig(batch_slots=2, max_seq=32))
