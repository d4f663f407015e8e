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

Every rank must end with the same logits and streams: each returns a
digest of them, and the caller compares them across ranks.
"""
from __future__ import annotations

import argparse
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


# ---------------------------------------------------------- rank program

def main(argv=None) -> None:
    from .mesh import init_ranks, make_layout, rank_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--workdir", required=True)
    a = ap.parse_args(argv)
    work = pathlib.Path(a.workdir)
    args = json.loads((work / "args.json").read_text())
    if args.get("threads"):
        torch.set_num_threads(int(args["threads"]))
    device = args.get("device")       # None: the card, as everywhere
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
    if any(t != "psum" for t in tasks):
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
