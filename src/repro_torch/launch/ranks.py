"""Run checks of the tensor-parallel path on several ranks, each its own
process: the launcher (:func:`run_ranks`) and the rank program
(``python -m repro_torch.launch.ranks``).

:func:`run_ranks` starts one process per rank (:class:`Procs`, the
launcher ``chip_smoke.py``'s worker processes also use) with a ``file://``
rendezvous in its work directory, waits for all of them under one
deadline, kills the rest as soon as one fails or the deadline passes, and
raises then; otherwise it returns each rank's result (``rank<r>.json``).
A rank runs its tasks in order on a layout of ``args["layout"]``, on
``args["device"]`` (absent: the card, raising without one; "cpu" for
the plain versions), and exits non-zero on any failed check.  The rank
processes import this module only (never the caller's), so a test file
or a script that imports JAX is not re-imported by them.

Tasks (``args["tasks"]``), each comparing the sharded model with the
whole one, which every rank also builds from the same seed:

* ``prefill``      ``Model.forward`` of a seeded prompt: logits within
                   ``tol`` of the logit scale; flash-attention launches
                   and the collectives one sharded forward counts;
* ``decode_paged`` a prompt through ``decode_paged`` in chunks, then one
                   token at a time, against the whole model's
                   ``decode_paged`` on a pool of all KV heads;
* ``serve``        ``ServingEngine`` with ``ServingConfig(mesh=layout)``
                   against the whole model's engine: streams equal
                   (``exact``) or equal but for one flip at a near-tie,
                   pool bytes, per variant: "fp", "int8" (the SIRA spec),
                   "prefix" (the prefix cache), "sampled" (fp pool, the
                   requests' ``temperatures``); ``serve_branch_gain``
                   scales the residual branches first, and reshards;
* ``psum``         ``train/compression.py compressed_psum`` against the
                   plain ``all_reduce`` sum: error, bound, bytes counted.

Tasks with an argument dict of their own (``args[task]``), each holding
the split run to whole-model results (``oracle``): computed in one
process before the ranks start (``run_oracle``/``start_oracle``, or
``--oracle``: so that
the whole model and the ranks' blocks never share a card) and read from
the files ``args["oracles"]`` names, or computed in the rank:

* ``train``, ``train_quant``, ``train_compress``, ``train_timed``,
  ``train_moe``, ``train_hybrid``  the
                   train step of a model split over each layout of
                   ``layouts`` (tensor, data and ZeRO parallelism,
                   fake-quant with ``quant_bits``, int8 gradients with
                   ``compress``): losses, the first step's gradient and
                   the masters after the last step against the whole
                   model's; ms per step, tokens/s, peak memory, the
                   collectives and the kernel launches of one step;
* ``moe_prefill``, ``ssm_prefill``  the prefill and ``decode`` decode
                   steps of each arch of ``archs`` split over ``layout``
                   (MoE expert parallel, Mamba2 by head), with MoE's
                   near-tie routing rule, and the collectives of the
                   prefill and of the first decode step;
* ``static_serve`` the static engine under ``layout`` against the whole
                   engine's streams, with the near-tie rule.

Every rank must end with the same logits and streams: each returns a
digest of them, and the caller compares them across ranks.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

SRC = pathlib.Path(__file__).resolve().parents[2]


# ------------------------------------------------------------- launcher

class Procs:
    """Commands (name → argv), each in a process of its own that writes
    its output to ``<logdir>/<name>.log``, at most ``max_parallel`` at a
    time (default: all) in the order given.  :meth:`wait` returns once
    all have exited 0 and raises ``RuntimeError`` (with the end of the
    failed one's log) as soon as one exits non-zero or the deadline
    passes, after killing the rest; :meth:`stop` kills what still
    runs."""

    def __init__(self, cmds: Dict[str, List[str]], logdir, *,
                 max_parallel: Optional[int] = None,
                 env: Optional[Dict[str, str]] = None, cwd=None):
        self.queue = list(cmds.items())
        self.logdir = pathlib.Path(logdir)
        self.max_parallel = max_parallel or len(self.queue)
        self.env, self.cwd = env, cwd
        self.procs: Dict[str, subprocess.Popen] = {}
        self.t0 = time.perf_counter()
        self._fill()

    def log(self, name: str) -> pathlib.Path:
        return self.logdir / f"{name}.log"

    def _fill(self) -> None:
        while self.queue and sum(p.poll() is None for p in
                                 self.procs.values()) < self.max_parallel:
            name, cmd = self.queue.pop(0)
            with open(self.log(name), "w") as log:
                self.procs[name] = subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT,
                    env=self.env, cwd=self.cwd)

    def wait(self, timeout_s: Optional[float] = None) -> float:
        """Wait for every command; the wall seconds since the first
        started."""
        deadline = None if timeout_s is None else \
            time.monotonic() + timeout_s
        while True:
            codes = {n: p.poll() for n, p in self.procs.items()}
            bad = [n for n, c in codes.items() if c not in (None, 0)]
            running = [n for n, c in codes.items() if c is None]
            if bad:
                self._fail(f"{bad[0]} exited with {codes[bad[0]]}", bad[:1])
            if not running and not self.queue:
                return time.perf_counter() - self.t0
            if deadline is not None and time.monotonic() > deadline:
                self._fail(f"{', '.join(running)} still running after "
                           f"{timeout_s} s", running)
            self._fill()
            time.sleep(0.05)

    def _fail(self, what: str, names: List[str]) -> None:
        self.stop()
        tails = "\n".join(f"--- {n} ---\n" + self.log(n).read_text()[-3000:]
                          for n in names)
        raise RuntimeError(f"{what}\n{tails}")

    def stop(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()


def run_ranks(world: int, args: Dict[str, Any], workdir, *,
              timeout_s: float = 300.0) -> List[Dict[str, Any]]:
    """Run ``args`` (``layout``, ``device``, ``tasks`` and theirs) on
    ``world`` rank processes; their results in rank order.  Raises if a
    rank fails (its output's end in the message) or the deadline
    passes."""
    work = pathlib.Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    (work / "args.json").write_text(json.dumps(args))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    procs = Procs({f"rank{r}": [sys.executable, "-m",
                                "repro_torch.launch.ranks", "--rank", str(r),
                                "--world", str(world), "--workdir", str(work)]
                   for r in range(world)}, work, env=env)
    try:
        procs.wait(timeout_s)
    finally:
        procs.stop()
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(world)]


def start_oracle(args: Dict[str, Any], workdir) -> Procs:
    """Start computing the whole-model results of ``args``' oracle tasks
    (:func:`oracle`) in a process of its own, to be waited for before
    their ranks start (so that the whole model and the ranks' blocks
    never share the card); they are saved to ``<workdir>/oracle.pt``,
    which ``args["oracles"]`` then names."""
    work = pathlib.Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    (work / "args.json").write_text(json.dumps(args))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    return Procs({"oracle": [sys.executable, "-m",
                             "repro_torch.launch.ranks", "--oracle",
                             "--workdir", str(work)]}, work, env=env)


def run_oracle(args: Dict[str, Any], workdir, *,
               timeout_s: float = 600.0) -> pathlib.Path:
    """:func:`start_oracle` and wait for it; the file of the results."""
    procs = start_oracle(args, workdir)
    try:
        procs.wait(timeout_s)
    finally:
        procs.stop()
    return pathlib.Path(workdir) / "oracle.pt"


# ---------------------------------------------------------------- tasks

def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()[:16]


def _model(args, device):
    from ..configs import get_config
    from ..models import get_model
    cfg = get_config(args["arch"], reduced=args.get("reduced", False))
    if args.get("dtype"):
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, args["dtype"]))
    gen = torch.Generator(device=device).manual_seed(args.get("seed", 0))
    model = get_model(cfg, device=device).init(gen)
    _gain(model, args.get("branch_gain"))
    return model


def _gain(model, gain) -> None:
    """Residual branches (``wo``, ``w_down``) scaled by ``gain``, a power
    of two (exact), so that greedy streams move: the seeded init with
    tied embeddings makes each position predict its own input token."""
    if gain:
        with torch.no_grad():
            for p in model.params["layers"]:
                p["attn"]["wo"].mul_(gain)
                p["mlp"]["w_down"].mul_(gain)


def _tokens(cfg, B, S, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)


def task_prefill(layout, args, model, sharded, device) -> Dict[str, Any]:
    from ..kernels import _build
    cfg, V = model.cfg, model.cfg.vocab
    B, S = args.get("prefill_shape", (1, 64))
    toks = _tokens(cfg, B, S, args.get("seed", 0) + 1, device)
    with torch.inference_mode():
        t0 = _clock(device)
        want = model(toks)[..., :V]
        whole_first_s = _clock(device) - t0
        layout.stats.reset()
        before = _build.LAUNCH_COUNTS["flash_attention"]
        t0 = _clock(device)
        got = sharded(toks)
        sharded_first_s = _clock(device) - t0
        launches = _build.LAUNCH_COUNTS["flash_attention"] - before
        colls = layout.stats.stats()
    check(got.shape == (B, S, cfg.vocab_padded), f"logits {got.shape}")
    scale = float(want.abs().max())
    err = float((got[..., :V] - want).abs().max())
    tol = args.get("tol", 1e-5)
    check(err <= tol * scale, f"sharded forward vs whole: {err} > "
                              f"{tol} * {scale}")
    check(bool(torch.isfinite(got[..., :V]).all()), "logits not finite")
    return dict(B=B, S=S, max_abs_err=err, logit_scale=scale, tol=tol,
                flash_launches=launches, collectives=dataclasses.asdict(
                    colls), whole_first_s=whole_first_s,
                sharded_first_s=sharded_first_s,
                digest=digest(got))


def _clock(device) -> float:
    """Host seconds, after the card (if any) has finished its work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def _paged_run(model, spec, toks, chunk, page, device, n_kv=None):
    """Logits (S, V) of ``toks`` (S,) through ``decode_paged`` on a fresh
    pool of ``spec`` (``n_kv`` KV heads): the first three quarters in
    chunks of ``chunk``, the last quarter one token at a time."""
    from ..serve import PagedKVCache
    from ..serve.engine import local_kv_scales
    cfg, S = model.cfg, toks.shape[0]
    cache = PagedKVCache(cfg, spec, 1, S, page_size=page, device=device,
                         n_kv=n_kv)
    check(cache.grow(0, S), "paged run: pool too small")
    table = cache.slot_table(0)
    scales = local_kv_scales(spec, model, device)
    n_prefill = S - S // 4
    starts = list(range(0, n_prefill, chunk)) + list(range(n_prefill, S))
    out = []
    with torch.inference_mode():
        for i, start in enumerate(starts):
            end = starts[i + 1] if i + 1 < len(starts) else S
            lg, _ = model.decode_paged(
                toks[None, start:end], cache.pages, table,
                torch.tensor([start], device=device), page_size=page,
                kv_scales=scales)
            out.append(lg[0, :, :cfg.vocab].float())
    return torch.cat(out)


def task_decode_paged(layout, args, model, sharded, device):
    from ..launch.shardings import tp_heads
    from ..serve import KVCacheSpec
    cfg = model.cfg
    S = args.get("paged_len", 48)
    toks = _tokens(cfg, 1, S, args.get("seed", 0) + 2, device)[0]
    spec = KVCacheSpec.all_fp(cfg.n_layers)
    chunk, page = args.get("chunk", 8), args.get("page", 4)
    want = _paged_run(model, spec, toks, chunk, page, device)
    got = _paged_run(sharded, spec, toks, chunk, page, device,
                     n_kv=tp_heads(cfg, layout)[1])
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    tol = args.get("tol", 1e-5)
    check(err <= tol * scale, f"sharded decode_paged vs whole: {err} > "
                              f"{tol} * {scale}")
    return dict(S=S, max_abs_err=err, logit_scale=scale, tol=tol,
                digest=digest(got))


def _requests(cfg, lens, seed, prefix_len=0, temps=None):
    from ..serve import Request
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, cfg.vocab, size=(prefix_len,))
    temps = temps or [0.0] * len(lens)
    return [Request(prompt=np.concatenate(
                        [prefix, rng.integers(0, cfg.vocab, size=(int(n),))]),
                    max_new_tokens=int(m), request_id=i,
                    temperature=float(t))
            for i, ((n, m), t) in enumerate(zip(lens, temps))]


def _stream_check(prompt, got, want, logits_of, exact, tie):
    """Equal streams, or (unless ``exact``) equal up to one flip at a
    near-tie of the whole model's logits, which ends the comparison."""
    n = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             None)
    if n is None:
        check(len(got) == len(want), "stream lengths differ")
        return dict(equal=len(want))
    check(not exact, f"streams differ at token {n}: {got[n]} vs {want[n]}")
    lg = logits_of(np.concatenate([prompt, want[:n]]))
    top = torch.topk(lg, 2)
    margin, scale = float(top.values[0] - top.values[1]), \
        float(lg.abs().max())
    check(set(top.indices.tolist()) == {got[n], want[n]}
          and margin < tie * scale,
          f"streams differ at token {n} ({got[n]} vs {want[n]}) where the "
          f"top-2 logits are {margin} apart of {scale}: not a near-tie")
    return dict(equal=n, flip=dict(position=n, margin=margin,
                                   logit_scale=scale))


def task_serve(layout, args, model, sharded, device):
    from ..serve import KVCacheSpec, ServingConfig, ServingEngine, \
        derive_kv_spec
    cfg = model.cfg
    kw = dict(batch_slots=args.get("slots", 2),
              max_seq=args.get("max_seq", 64),
              page_size=args.get("page", 4),
              prefill_chunk=args.get("chunk", 8))
    exact, tie = args.get("exact", True), args.get("tie", 1e-5)
    lens = args.get("requests", [(12, 6), (7, 8), (20, 5), (3, 7)])
    out = {}
    for variant in args.get("variants", ["fp", "int8", "prefix"]):
        if variant == "int8":
            kv = derive_kv_spec(model, max_step=args.get("max_step", 0.5))
        else:
            kv = KVCacheSpec.all_fp(cfg.n_layers)
        prefix = args.get("prefix_len", 8) if variant == "prefix" else 0
        temps = args.get("temperatures") if variant == "sampled" else None
        reqs = _requests(cfg, lens, args.get("seed", 0) + 3, prefix, temps)
        extra = dict(prefix_cache=True) if variant == "prefix" else {}
        whole = ServingEngine(model, ServingConfig(**kw, kv_cache=kv,
                                                   **extra))
        want = whole.generate(reqs)
        layout.stats.reset()
        eng = ServingEngine(model, ServingConfig(**kw, kv_cache=kv,
                                                 mesh=layout, **extra))
        t0 = time.perf_counter()
        got = eng.generate(reqs)
        seconds = time.perf_counter() - t0
        colls = layout.stats.stats()

        def logits_of(seq, kv=kv):
            toks = torch.as_tensor(seq, device=device)
            return _paged_run_last(model, kv, toks, device)
        checks = [_stream_check(r.prompt, g, w, logits_of, exact, tie)
                  for r, g, w in zip(reqs, got, want)]
        res = dict(streams=got, whole_streams=want,
                   tokens_compared=sum(c["equal"] for c in checks),
                   flips=[dict(request=i, **c["flip"])
                          for i, c in enumerate(checks) if "flip" in c],
                   distinct_tokens=[len(set(g)) for g in got],
                   pool_bytes=eng.cache.hbm_bytes(),
                   whole_pool_bytes=whole.cache.hbm_bytes(),
                   n_int8=kv.n_int8, seconds=seconds,
                   collectives=dataclasses.asdict(colls),
                   decode_steps=eng.metrics.decode_steps,
                   prefill_chunks=eng.metrics.prefill_chunks)
        if variant == "prefix":
            res["prefix_hit_rate"] = eng.metrics.summary()[
                "prefix_hit_rate"]
        out[variant] = res
        del whole, eng
    return out


def _paged_run_last(model, spec, toks, device):
    """The whole model's last-position logits of ``toks`` through
    ``decode_paged`` on a fresh pool of ``spec`` (what a stream saw)."""
    from ..serve import PagedKVCache
    cfg, S = model.cfg, toks.shape[0]
    cache = PagedKVCache(cfg, spec, 1, S, page_size=4, device=device)
    check(cache.grow(0, S), "pool too small")
    with torch.inference_mode():
        lg, _ = model.decode_paged(
            toks[None], cache.pages, cache.slot_table(0),
            torch.tensor([0], device=device), page_size=4,
            kv_scales=spec.scales(device))
    return lg[0, -1, :cfg.vocab].float()


def task_psum(layout, args, device):
    from ..launch.mesh import use_layout
    from ..train.compression import compressed_psum, quantize_tensor
    n = int(args.get("psum_n", 4096))
    r = layout.index("model")
    rng = np.random.default_rng(args.get("seed", 0) + 10 + r)
    x = torch.as_tensor((rng.standard_normal(n) * (1 + r)).astype(
        np.float32), device=device)
    with use_layout(layout):
        layout.stats.reset()
        got = compressed_psum(x, "model")
        comp = layout.stats.stats()
        layout.stats.reset()
        want = layout.all_reduce(x, "model")
        plain = layout.stats.stats()
        scale_sum = float(layout.all_reduce(quantize_tensor(x)[1]
                                            .reshape(1), "model"))
    err = (got - want).abs()
    bound = 2.0 * scale_sum
    check(float(err.max()) <= bound, f"compressed_psum: {float(err.max())} "
                                     f"> 2 * sum of scales {scale_sum}")
    return dict(n=n, max_abs_err=float(err.max()),
                mean_abs_err=float(err.mean()), bound=bound,
                compressed=dataclasses.asdict(comp),
                plain=dataclasses.asdict(plain), digest=digest(got))


# ------------------------------------- training, families, static serving
#
# Each of these tasks has an argument dict of its own (``args[task]``)
# and compares the split run with whole-model results (``oracle``): read
# from the files ``args["oracles"]`` names (each compared, each with the
# task's bars; the whole model then never shares a card with the ranks),
# and computed in the rank itself when there are none, or when
# ``args["oracle_in_rank"]``.

ORACLE_TASKS = ("train", "train_quant", "train_compress", "train_timed",
                "train_moe", "train_hybrid", "moe_prefill", "ssm_prefill",
                "static_serve")


def _cfg(spec: Dict[str, Any], arch: Optional[str] = None):
    """A task's config: ``arch``, ``reduced``, ``dtype``, ``layers`` (a
    depth cut: an int, or {arch: int}) and ``n_experts`` (a MoE config's
    expert count replaced)."""
    from ..configs import get_config
    arch = arch or spec["arch"]
    cfg = get_config(arch, reduced=spec.get("reduced", False))
    if spec.get("dtype"):
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, spec["dtype"]))
    layers = spec.get("layers")
    if isinstance(layers, dict):
        layers = layers.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
    if spec.get("n_experts"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=int(spec["n_experts"])))
    return cfg


def _whole(spec: Dict[str, Any], device, arch: Optional[str] = None):
    """The whole model of a task: ``params`` (a file of the port's param
    tree, e.g. the reference's weights carried across), or drawn from
    ``seed`` on ``device``'s generator (every process draws the same)."""
    from ..models import get_model
    from ..models.convert import ParamTree
    arch = arch or spec["arch"]
    cfg = _cfg(spec, arch)
    model = get_model(cfg, device=device)
    params = spec.get("params")
    if isinstance(params, dict):
        params = params.get(arch)
    if params:
        model.params = ParamTree(torch.load(params, map_location=device))
    else:
        model.init(torch.Generator(device=device).manual_seed(
            spec.get("seed", 0)))
    return model


def train_batches(spec: Dict[str, Any], vocab: int) -> List[Dict[str, Any]]:
    """``steps`` global batches (B, S) of seeded tokens and their next
    tokens, numpy int64 (what the tests hand the reference too)."""
    B, S = spec["batch"]
    toks = np.random.default_rng(spec.get("seed", 0) + 100).integers(
        0, vocab, size=(spec.get("steps", 1), B, S + 1))
    return [dict(tokens=t[:, :-1], labels=t[:, 1:]) for t in toks]


def train_optimizer(spec: Dict[str, Any]):
    from ..optim import AdamW
    return AdamW(lr=spec.get("lr", 3e-3),
                 warmup_steps=spec.get("warmup", 2),
                 total_steps=spec.get("total", 50),
                 clip_norm=spec.get("clip_norm", 1.0))


def _quant(spec):
    from ..quant.quantizer import QuantSpec
    return QuantSpec(bits=spec["quant_bits"]) if spec.get("quant_bits") \
        else None


def _leaf_max(tree) -> Any:
    from ..tree import tree_map
    return tree_map(lambda t: t.detach().abs().max().to(torch.float32)
                    .cpu() if t.numel() else torch.zeros(()), tree)


def _cpu(tree) -> Any:
    from ..tree import tree_map
    return tree_map(lambda t: t.detach().to(torch.float32).cpu(), tree)


def oracle_train(spec: Dict[str, Any], device) -> Dict[str, Any]:
    """The whole model's run of a train task (``compress``: int8
    gradients with error feedback), per microbatch count: the
    losses and gradient norms of every step, and, where the task has a
    bar for them, the first step's gradient (and each leaf's max |g|)
    and the masters after the last step (and each leaf's max)."""
    from ..train import init_train_state, make_train_step
    out = {}
    for mb in spec.get("microbatches", [1]):
        model = _whole(spec, device)
        opt = train_optimizer(spec)
        state = init_train_state(model, opt, 0,
                                 compress=spec.get("compress", False),
                                 params=model.param_tree())
        step = make_train_step(model, opt, microbatches=mb,
                               quant=_quant(spec),
                               remat=spec.get("remat", False),
                               compress=spec.get("compress", False),
                               return_grads=True)
        losses, gnorms, res = [], [], {}
        for i, batch in enumerate(train_batches(spec, model.cfg.vocab)):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
            if i == 0 and spec.get("tol_grad"):
                res["grads"] = _cpu(met["grads"])
                res["gmax"] = _leaf_max(res["grads"])
            del met
        if spec.get("tol_master"):
            res["masters"] = _cpu(state.opt.master)
            res["mmax"] = _leaf_max(res["masters"])
        out[f"mb{mb}"] = dict(losses=losses, gnorms=gnorms, **res)
        del model, state, step
        _free(device)
    return out


def _free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _errs(got_tree, want_tree, scale_tree, device) -> List[float]:
    """Per leaf: max|got - want| / the whole leaf's scale (a 0-d tensor
    per leaf); an empty block counts 0."""
    from ..tree import leaves
    out = []
    for g, w, sc in zip(leaves(got_tree), leaves(want_tree),
                        leaves(scale_tree)):
        err = float((g.to(torch.float32) - w.to(device, torch.float32))
                    .abs().max()) if g.numel() else 0.0
        out.append(err / max(float(sc), 1e-30))
    return out


def _rank_block(tree, model, layout) -> Any:
    """A whole tree like the params → this rank's blocks, as its
    optimizer state holds them."""
    from ..train.train_step import zero_slices
    from .shardings import shard_params
    if layout.size("model") > 1:
        tree = shard_params(tree, layout, model.cfg)
    return zero_slices(tree, model)


def task_train(key: str, args, device, oracles) -> Dict[str, Any]:
    """``args[key]``: the split train step on each layout of ``layouts``
    and each microbatch count, against every oracle: losses (relative
    ``tol_loss``), the first step's gradient (each leaf within
    ``tol_grad`` of its max |g|, when ``tol_grad``) and the masters after
    the last step (``tol_master`` of the largest master, when given);
    with
    ``timed``, ms per step, tokens/s, the peak memory, the collectives and
    the backward launches of one step, per rank."""
    from ..kernels import _build
    from ..train import init_train_state, make_train_step
    from ..tree import leaves
    from .mesh import make_layout
    spec = args[key]
    out = {}
    for shape in spec["layouts"]:
        layout = make_layout(shape)
        for mb in spec.get("microbatches", [1]):
            whole = _whole(spec, device)
            model = whole.shard(layout)
            del whole
            _free(device)
            opt = train_optimizer(spec)
            state = init_train_state(model, opt, 0,
                                     compress=spec.get("compress", False),
                                     params=model.param_tree())
            step = make_train_step(model, opt, microbatches=mb,
                                   quant=_quant(spec),
                                   remat=spec.get("remat", False),
                                   compress=spec.get("compress", False),
                                   return_grads=True)
            batches = train_batches(spec, model.cfg.vocab)
            res = dict(layout=list(shape), microbatches=mb, losses=[],
                       gnorms=[], step_s=[])
            cuda = torch.device(device).type == "cuda"
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            grads = None
            for i, batch in enumerate(batches):
                layout.stats.reset()
                before = dict(_build.LAUNCH_COUNTS)
                t0 = _clock(device)
                state, met = step(state, batch)
                res["step_s"].append(_clock(device) - t0)
                res["losses"].append(float(met["loss"]))
                res["gnorms"].append(float(met["grad_norm"]))
                if i == 0:
                    grads = met["grads"]
                    res["collectives"] = dataclasses.asdict(
                        layout.stats.stats())
                    res["launches"] = {
                        k: v - before.get(k, 0)
                        for k, v in _build.LAUNCH_COUNTS.items()
                        if k.startswith("flash_attention")
                        and v != before.get(k, 0)}
                del met
            if cuda:
                res["peak_bytes"] = torch.cuda.max_memory_allocated()
            B, S = spec["batch"]
            warm = min(spec.get("warm", 1), len(res["step_s"]) - 1)
            step_s = sorted(res["step_s"][warm:])[
                len(res["step_s"][warm:]) // 2]
            res.update(median_step_s=step_s, tokens_per_s=B * S / step_s)
            res["vs"] = []
            for o in oracles:
                if key not in o:
                    continue
                want = o[key][f"mb{mb}"]
                loss_err = max(abs(a - b) / abs(b) for a, b in
                               zip(res["losses"], want["losses"]))
                cmp = dict(whole_losses=want["losses"],
                           whole_gnorms=want.get("gnorms"),
                           loss_rel_err=loss_err)
                check(loss_err <= spec.get("tol_loss", 1e-5),
                      f"{key} {shape} mb{mb}: losses {res['losses']} vs "
                      f"{want['losses']}")
                if spec.get("tol_grad"):
                    cmp["grad_err"] = max(_errs(
                        grads, _rank_block(want["grads"], model, layout),
                        want["gmax"], device))
                    check(cmp["grad_err"] <= spec["tol_grad"],
                          f"{key} {shape} mb{mb}: gradient "
                          f"{cmp['grad_err']} of the leaf's max")
                if spec.get("tol_master"):
                    # of each leaf's max (reported), and of the largest
                    # master (the bar): AdamW's first steps map a gradient
                    # near its eps to any step in [-lr, lr], so a leaf of
                    # small weights can differ by more than its own scale
                    # allows where the gradients agree to rounding
                    per_leaf = _errs(
                        state.opt.master,
                        _rank_block(want["masters"], model, layout),
                        want["mmax"], device)
                    top = max(float(v) for v in leaves(want["mmax"]))
                    cmp["master_leaf_err"] = max(per_leaf)
                    cmp["master_err"] = max(
                        e * float(v) / top for e, v in
                        zip(per_leaf, leaves(want["mmax"])))
                    check(cmp["master_err"] <= spec["tol_master"],
                          f"{key} {shape} mb{mb}: masters "
                          f"{cmp['master_err']} of the largest master")
                res["vs"].append(cmp)
            res["digest"] = digest(torch.tensor(res["losses"]))
            out[f"{layout.name}_mb{mb}"] = res
            del model, state, step, grads
            _free(device)
    return out


def _prefill_tokens(cfg, spec) -> np.ndarray:
    B, S = spec["shape"]
    return np.random.default_rng(spec.get("seed", 0) + 1).integers(
        0, cfg.vocab, size=(B, S))


@contextlib.contextmanager
def routing_log():
    """Record every MoE layer's routing, in call order: its expert ids
    (sorted per token) and the top-(k+1) router probabilities."""
    from ..models import moe
    log, route = [], moe.route

    def recorded(params, x, **kw):
        r = route(params, x, **kw)
        k = r.gate_idx.shape[-1]
        log.append((r.gate_idx.sort(dim=-1).values.cpu(),
                    r.probs.topk(k + 1, dim=-1).values.cpu()))
        return r
    moe.route = recorded
    try:
        yield log
    finally:
        moe.route = route


def _by_layer(log, n_layers):
    """One (B, S, .) entry per layer, or one (B, 1, .) per decode step
    and layer → (ids, top) stacked (n_layers, B, S, .)."""
    steps = len(log) // n_layers
    return tuple(torch.stack([torch.cat([log[t * n_layers + i][j]
                                         for t in range(steps)], dim=1)
                              for i in range(n_layers)]) for j in (0, 1))


def first_routing_flip(whole, split, tie: float) -> int:
    """The first position whose routing differs between the whole run's
    ``(ids, top)`` and the split run's in any layer (S when none).  Two
    float32 runs that sum in other orders may swap the k-th and (k+1)-th
    expert of a token whose probabilities tie to rounding; every such
    difference must be a near-tie (margin < ``tie``), and positions from
    the first one on are not compared (a swap changes that token's
    output and, through attention, every later position's)."""
    ids_a, top_a = whole
    ids_b = split[0]
    diff = (ids_a != ids_b).any(dim=-1)                # (layers, B, S)
    if not bool(diff.any()):
        return ids_a.shape[2]
    margin = float((top_a[..., -2] - top_a[..., -1])[diff].max())
    check(margin < tie, f"routing differs where the k-th and (k+1)-th "
                        f"probabilities are {margin} apart: not a near-tie")
    return int(diff.any(dim=0).any(dim=0).nonzero()[0])


def _family_run(model, toks, n_decode, device, layout=None):
    """float32 logits [..., :vocab] of a prefill of ``toks`` and of
    ``n_decode`` decode steps over its first tokens, with the routing
    of each (and the collectives of the prefill under ``layout``)."""
    from ..kernels import _build
    cfg, V = model.cfg, model.cfg.vocab
    t = torch.as_tensor(toks, device=device)
    with torch.inference_mode():
        with routing_log() as log:
            if layout is not None:
                layout.stats.reset()
            before = _build.LAUNCH_COUNTS["flash_attention"]
            t0 = _clock(device)
            logits = model(t)[..., :V].float()
            seconds = _clock(device) - t0
            launches = _build.LAUNCH_COUNTS["flash_attention"] - before
        out = dict(logits=logits.cpu(), seconds=seconds,
                   flash_launches=launches)
        del logits
        if layout is not None:
            out["collectives"] = dataclasses.asdict(layout.stats.stats())
        if cfg.family == "moe":
            out["routing"] = _by_layer(log, cfg.n_layers)
        if n_decode:
            cache = model.init_cache(t.shape[0], n_decode)
            steps = []
            with routing_log() as dlog:
                for i in range(n_decode):
                    if layout is not None and i == 0:
                        layout.stats.reset()
                    lg, cache = model.decode_step(t[:, i:i + 1], cache, i)
                    if layout is not None and i == 0:
                        out["decode_collectives"] = dataclasses.asdict(
                            layout.stats.stats())
                    steps.append(lg[..., :V].float().cpu())
            out["decode"] = torch.cat(steps, dim=1)
            if cfg.family == "moe":
                out["decode_routing"] = _by_layer(dlog, cfg.n_layers)
            out["cache_bytes"] = sum(
                v.numel() * v.element_size() for v in _tensors(cache))
    return out


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def oracle_families(key: str, args, device) -> Dict[str, Any]:
    spec = args[key]
    out = {}
    for arch in spec["archs"]:
        model = _whole(spec, device, arch)
        toks = _prefill_tokens(model.cfg, spec)
        out[arch] = _family_run(model, toks, spec.get("decode", 0), device)
        del model
        _free(device)
    return out


def task_families(key: str, args, device, oracles) -> Dict[str, Any]:
    """``args[key]``: each arch of ``archs`` split over ``layout``: the
    prefill's logits, and ``decode`` decode steps', within ``tol`` of the
    whole model's logit scale (MoE: up to the first near-tie routing
    swap, ``tie``); flash-attention launches per split forward, the
    collectives, the weights and the cache this rank holds."""
    from .mesh import make_layout
    spec = args[key]
    layout = make_layout(spec["layout"])
    tol, tie = spec.get("tol", 1e-5), spec.get("tie", 1e-5)
    out = {}
    for arch in spec["archs"]:
        whole = _whole(spec, device, arch)
        whole_bytes = sum(t.numel() * t.element_size()
                          for t in whole.params.parameters())
        model = whole.shard(layout)
        del whole
        _free(device)
        toks = _prefill_tokens(model.cfg, spec)
        got = _family_run(model, toks, spec.get("decode", 0), device,
                          layout)
        res = dict(flash_launches=got["flash_launches"],
                   seconds=got["seconds"], collectives=got["collectives"],
                   decode_collectives=got.get("decode_collectives"),
                   param_bytes=sum(t.numel() * t.element_size()
                                   for t in model.params.parameters()),
                   whole_param_bytes=whole_bytes,
                   cache_bytes=got.get("cache_bytes"), vs=[],
                   digest=digest(got["logits"]))
        for o in oracles:
            want = o[key][arch]
            cmp = {}
            for part in ("logits",) + (("decode",) if spec.get("decode")
                                       else ()):
                n = want[part].shape[1]
                route = "routing" if part == "logits" else "decode_routing"
                if route in want:
                    n = first_routing_flip(want[route], got[route], tie)
                scale = float(want[part].abs().max())
                err = float((got[part][:, :n] - want[part][:, :n])
                            .abs().max()) if n else 0.0
                check(err <= tol * scale, f"{key} {arch} {part}: {err} > "
                                          f"{tol} * {scale}")
                cmp[part] = dict(max_abs_err=err, logit_scale=scale,
                                 positions=n, of=want[part].shape[1])
            res["vs"].append(cmp)
        out[arch] = res
        del model, got
        _free(device)
    return out


def _static_requests(cfg, spec):
    from ..serve import Request
    rng = np.random.default_rng(spec.get("seed", 0) + 3)
    return [Request(prompt=rng.integers(0, cfg.vocab, size=(int(n),)),
                    max_new_tokens=int(m), request_id=i)
            for i, (n, m) in enumerate(spec["requests"])]


def _static_engine(model, spec, layout=None):
    from ..serve import ServingConfig, ServingEngine
    return ServingEngine(model, ServingConfig(
        batch_slots=spec.get("slots", len(spec["requests"])),
        max_seq=spec["max_seq"], mode="static", mesh=layout))


def oracle_static(args, device) -> Dict[str, Any]:
    """Per arch: the whole engine's static streams, and the top-2 logits
    and the scale of the logits each emitted token was picked from (what
    the near-tie rule reads), recorded as the engine samples."""
    spec = args["static_serve"]
    out = {}
    for arch in spec["archs"]:
        model = _whole(spec, device, arch)
        _gain(model, spec.get("branch_gain"))
        reqs = _static_requests(model.cfg, spec)
        eng = _static_engine(model, spec)
        V, calls, sample = model.cfg.vocab, [], eng._sample

        def recorded(logits, *a, **kw):
            lg = logits[:, :V].float()
            top = torch.topk(lg, 2)
            calls.append((top.indices.cpu(), top.values.cpu(),
                          lg.abs().amax(dim=-1).cpu()))
            return sample(logits, *a, **kw)
        eng._sample = recorded
        streams = eng.generate(reqs)
        tops = [dict(ids=torch.stack([c[0][i] for c in calls]),
                     vals=torch.stack([c[1][i] for c in calls]),
                     scale=torch.stack([c[2][i] for c in calls]))
                for i in range(len(reqs))]
        out[arch] = dict(streams=streams, tops=tops)
        del model, eng
        _free(device)
    return out


def task_static_serve(args, device, oracles) -> Dict[str, Any]:
    """``args["static_serve"]``: per arch of ``archs``, the static engine
    under ``layout`` (``decode_step`` and ``init_cache`` of the split
    model) against the whole engine's streams: equal, or (unless
    ``exact``) equal up to one swap where the whole model's top two
    logits are within ``tie`` of its scale, which ends the comparison."""
    from .mesh import make_layout
    spec = args["static_serve"]
    layout = make_layout(spec["layout"])
    exact, tie = spec.get("exact", True), spec.get("tie", 1e-5)
    out = {}
    for arch in spec["archs"]:
        whole = _whole(spec, device, arch)
        _gain(whole, spec.get("branch_gain"))
        reqs = _static_requests(whole.cfg, spec)
        layout.stats.reset()
        eng = _static_engine(whole, spec, layout)
        del whole
        _free(device)
        t0 = _clock(device)
        streams = eng.generate(reqs)
        seconds = _clock(device) - t0
        res = dict(streams=streams, seconds=seconds,
                   collectives=dataclasses.asdict(layout.stats.stats()),
                   distinct_tokens=[len(set(s)) for s in streams], vs=[])
        del eng
        _free(device)
        for o in oracles:
            want = o["static_serve"][arch]
            compared, flips = 0, []
            for i, (got, w) in enumerate(zip(streams, want["streams"])):
                n = next((j for j, (a, b) in enumerate(zip(got, w))
                          if a != b), None)
                if n is None:
                    check(len(got) == len(w), f"{arch} request {i}: "
                                              f"stream lengths differ")
                    compared += len(w)
                    continue
                check(not exact, f"{arch} request {i}: streams differ at "
                                  f"token {n}")
                top = want.get("tops")
                check(top is not None, f"{arch} request {i}: streams "
                                       f"differ at token {n}")
                top = top[i]
                margin = float(top["vals"][n, 0] - top["vals"][n, 1])
                scale = float(top["scale"][n])
                check(set(top["ids"][n].tolist()) == {got[n], w[n]} and
                      margin < tie * scale,
                      f"{arch} request {i}: streams differ at token {n} "
                      f"where the top-2 logits are {margin} apart of "
                      f"{scale}")
                compared += n
                flips.append(dict(request=i, position=n, margin=margin,
                                  logit_scale=scale))
            res["vs"].append(dict(whole_streams=want["streams"],
                                  tokens_compared=compared, flips=flips))
        res["digest"] = hashlib.sha256(json.dumps(streams).encode()
                                       ).hexdigest()[:16]
        out[arch] = res
    return out


def oracle(args, device) -> Dict[str, Any]:
    """The whole-model results of every oracle task in ``args["tasks"]``
    (what :func:`main` with ``--oracle`` saves)."""
    device = torch.device(device)
    out: Dict[str, Any] = {}
    for task in args["tasks"]:
        if task.startswith("train") and args[task].get("oracle", True):
            out[task] = oracle_train(args[task], device)
        elif task in ("moe_prefill", "ssm_prefill"):
            out[task] = oracle_families(task, args, device)
        elif task == "static_serve":
            out[task] = oracle_static(args, device)
    return out


# ---------------------------------------------------------- rank program

def main(argv=None) -> None:
    from .mesh import init_ranks, make_layout, rank_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--oracle", action="store_true",
                    help="compute the whole-model results of the args' "
                         "tasks in this one process and save them to "
                         "<workdir>/oracle.pt")
    a = ap.parse_args(argv)
    work = pathlib.Path(a.workdir)
    args = json.loads((work / "args.json").read_text())
    if args.get("threads"):
        torch.set_num_threads(int(args["threads"]))
    device = args.get("device")       # None: the card, as everywhere
    if a.oracle:
        from ..core.lower import resolve_device
        t0 = time.perf_counter()
        torch.save(oracle(args, resolve_device(device)), work / "oracle.pt")
        (work / "oracle.json").write_text(json.dumps(
            dict(seconds=time.perf_counter() - t0)))
        return
    backend = init_ranks(a.rank, a.world, f"file://{work}/rendezvous",
                         device=device,
                         timeout_s=args.get("pg_timeout", 60.0))
    device = rank_device(device, a.rank, backend)
    import torch.distributed as dist
    layout = make_layout(args["layout"])
    t0 = time.perf_counter()
    result: Dict[str, Any] = dict(rank=a.rank, backend=backend,
                                  device=str(device),
                                  coords=layout.coords())
    tasks = args["tasks"]
    oracles = [torch.load(p, map_location="cpu", mmap=True)
               for p in args.get("oracles", [])]
    if any(t in ORACLE_TASKS for t in tasks) and \
            args.get("oracle_in_rank", not oracles):
        oracles.insert(0, oracle(args, device))
    if any(t in ("prefill", "decode_paged", "serve") for t in tasks):
        model = _model(args, device)
        t1 = time.perf_counter()
        sharded = model.shard(layout)
        result["shard_s"] = time.perf_counter() - t1
        result["param_bytes"] = sum(
            t.numel() * t.element_size() for t in sharded.params.parameters())
        result["whole_param_bytes"] = sum(
            t.numel() * t.element_size() for t in model.params.parameters())
    for task in tasks:
        t1 = time.perf_counter()
        if task == "psum":
            res = task_psum(layout, args, device)
        elif task.startswith("train"):
            res = task_train(task, args, device, oracles)
        elif task in ("moe_prefill", "ssm_prefill"):
            res = task_families(task, args, device, oracles)
        elif task == "static_serve":
            res = task_static_serve(args, device, oracles)
        else:
            if task == "serve" and args.get("serve_branch_gain"):
                _gain(model, args["serve_branch_gain"])
                del sharded
                sharded = model.shard(layout)
            fn = {"prefill": task_prefill,
                  "decode_paged": task_decode_paged,
                  "serve": task_serve}[task]
            res = fn(layout, args, model, sharded, device)
        res["seconds_task"] = time.perf_counter() - t1
        result[task] = res
    result["seconds"] = time.perf_counter() - t0
    (work / f"rank{a.rank}.json").write_text(json.dumps(result))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
