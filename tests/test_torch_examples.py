"""The port's entry points, ``examples_torch/``, against the reference's
``examples/`` run in this process (``runpy``, ``sys.argv`` patched,
stdout captured), the twins with ``--torch-device cpu``.

Every printed line must be the reference's but for wall-clock times, the
kernel-count line (the port prints its own plan per kind; the kinds the
two plans share must count the same) and the reference's TPU line, which
the port replaces by the H100's routes.  Generated names come from a
process-global counter in each package (reference fault 5), so lines are
compared up to them.  ``train_qat`` and ``serve_quantized`` start from
the reference's weights carried across (its QAT init, its LM params):
the losses within 1e-5 relative (``tests/test_torch_qat.py``'s bar),
proven bits, budgets, LUT/DSP, greedy streams and KV bytes equal.  Each
twin's default torch device is the card, which a CPU-only machine does
not have: there the default raises.
"""
import ast
import contextlib
import io
import itertools
import json
import pathlib
import re
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core.affine as j_affine
import repro.core.graph as j_graph
import repro.core.propagate as j_propagate
import repro.obs as j_obs
import repro_torch.core.affine as t_affine
import repro_torch.core.graph as t_graph
import repro_torch.core.propagate as t_propagate
import repro_torch.obs as t_obs
import repro_torch.qat as tq
from examples_torch import quickstart, serve_quantized, sira_report, \
    train_qat
from repro_torch.kernels.int_matmul import CUDA_CORES, TENSOR_CORES
from repro_torch.kernels.multithreshold import COMPARE_COUNT, SEARCH
from repro_torch.obs.trace import validate_chrome_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--torch-device", "cpu"]
TWINS = {"quickstart": quickstart, "sira_report": sira_report,
         "serve_quantized": serve_quantized, "train_qat": train_qat}


#: (module, name) of the process-global counters the analyses advance:
#: generated tensor and node names, affine noise symbols
COUNTERS = [(j_graph, "_counter"), (t_graph, "_counter"),
            (j_affine, "_sym_counter"), (t_affine, "_sym_counter")]


def _take(mod, name):
    """The next value of ``mod.name`` (an ``itertools.count``), left
    where it was."""
    n = next(getattr(mod, name))
    setattr(mod, name, itertools.count(n))
    return n


@pytest.fixture(autouse=True)
def process_state():
    """Put back what an example may change in this worker process: both
    packages' global tracers, name and symbol counters and analysis-call
    counts, JAX's x64 flag, torch's default dtype, deterministic
    algorithms and float32 matmul precision.  Other files' tests in the
    same worker then see the counters as if this file had not run."""
    counters = [_take(mod, name) for mod, name in COUNTERS]
    calls = (j_propagate.ANALYSIS_CALLS, t_propagate.ANALYSIS_CALLS)
    saved = (j_obs.get_tracer(), t_obs.get_tracer(),
             jax.config.jax_enable_x64, torch.get_default_dtype(),
             torch.are_deterministic_algorithms_enabled(),
             torch.get_float32_matmul_precision())
    yield
    for (mod, name), n in zip(COUNTERS, counters):
        setattr(mod, name, itertools.count(n))
    j_propagate.ANALYSIS_CALLS, t_propagate.ANALYSIS_CALLS = calls
    j_obs.set_tracer(saved[0])
    t_obs.set_tracer(saved[1])
    jax.config.update("jax_enable_x64", saved[2])
    torch.set_default_dtype(saved[3])
    torch.use_deterministic_algorithms(saved[4])
    torch.set_float32_matmul_precision(saved[5])


def run_reference(name, argv=(), patch=None):
    """Run ``examples/<name>.py``'s ``main`` in this process with
    ``argv``; ``patch`` maps names of its globals to replacements (put
    back afterwards).  Returns its stdout."""
    path = str(ROOT / "examples" / f"{name}.py")
    ns = runpy.run_path(path)
    globs = ns["main"].__globals__
    saved = {k: globs[k] for k in patch or {}}
    globs.update(patch or {})
    argv0, buf = sys.argv, io.StringIO()
    sys.argv = [path, *argv]
    try:
        with contextlib.redirect_stdout(buf):
            ns["main"]()
    finally:
        sys.argv = argv0
        globs.update(saved)
    return buf.getvalue()


def run_twin(fn, *args, **kwargs):
    """Call a twin's function; returns (its result, its stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


_GENERATED = re.compile(r"\b([A-Za-z][A-Za-z0-9]*(?:_[A-Za-z]+)*)_\d+\b")


def up_to_names(text):
    """Lines with each generated ``<name>_<n>`` blanked and whitespace
    runs collapsed (a padded column shifts with the digits)."""
    return [re.sub(r"\s+", " ", _GENERATED.sub(r"\1_#", line)).strip()
            for line in text.splitlines()]


# ---------------------------------------------------------------- quickstart

_MS = re.compile(r"\s+[\d.]+ ms$")


def test_quickstart_lines_and_plan_match_reference():
    want = run_reference("quickstart").splitlines()
    out, text = run_twin(quickstart.main, CPU)
    got = text.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got[:-1], want[:-1]):          # times stripped
        assert _MS.sub("", g) == _MS.sub("", w)
    assert got[-1].startswith("compiled backend on cpu: ")
    assert got[-1].endswith("matches the interpreter on a batch of 32")
    # the plan: every kind both plans name counts the same; what the
    # reference leaves to jnp the port leaves to plain torch
    ref_calls = ast.literal_eval(want[-1][want[-1].index("{"):
                                          want[-1].index("}") + 1])
    port_calls = out["kernel_calls"]
    shared = set(ref_calls) & set(port_calls)
    assert {"quantize", "int_matmul", "multithreshold",
            "fused:int_matmul+epilogue"} <= shared
    assert {k: port_calls[k] for k in shared} == \
        {k: ref_calls[k] for k in shared}
    assert set(ref_calls) - shared == {"jnp"}
    assert set(port_calls) - shared == {"torch"}
    assert port_calls["torch"] == ref_calls["jnp"]
    assert out["accumulators"] == [["MatMul", 49, 13, 20],
                                   ["MatMul", 64, 7, 11],
                                   ["MatMul", 64, 6, 11]]
    assert out["contained"] and out["batch"] == 32


# --------------------------------------------------------------- sira_report

def _report_pair(argv):
    want = run_reference("sira_report", argv)
    out, got = run_twin(sira_report.main, list(argv) + CPU)
    return out, up_to_names(got), up_to_names(want)


def test_sira_report_arch_matches_reference():
    out, got, want = _report_pair([])
    tpu = [i for i, line in enumerate(want) if line.startswith("TPU mapping")]
    assert len(tpu) == 1 and got[tpu[0]].startswith("H100 mapping")
    del got[tpu[0]], want[tpu[0]]
    assert got == want
    assert len(out["accumulators"]) == 6
    assert out["accumulator_dtype"] == "int16"


@pytest.mark.parametrize("domain", ["interval", "affine"])
@pytest.mark.parametrize("workload", ["TFC-w2a2", "CNV-w2a2"])
def test_sira_report_workload_matches_reference(workload, domain):
    """The per-node table, FIFO line, totals, folding search and the
    range verification of the dataflow DSE report, in both domains."""
    out, got, want = _report_pair(["--workload", workload, "--domain",
                                   domain, "--verify"])
    assert got == want
    assert any(line.startswith("(stream FIFOs)") for line in got)
    assert out["verification"]["contained"]
    assert out["feasible"] and len(out["nodes"]) > 5


def test_sira_report_explain_matches_reference():
    _, got, want = _report_pair(["--workload", "TFC", "--explain",
                                 "fc1_mm"])
    assert "=== range provenance: fc1_mm ===" in got
    assert got == want


@pytest.mark.parametrize("w_bits, a_bits, products, tail", [
    (4, 4, {TENSOR_CORES: 6}, COMPARE_COUNT),
    (4, 8, {TENSOR_CORES: 6}, SEARCH),         # 255 thresholds
    (10, 4, {CUDA_CORES: 6}, COMPARE_COUNT),   # weights past int8
])
def test_sira_report_h100_mapping(w_bits, a_bits, products, tail):
    """The line that replaces the TPU's names the route ``route_for``
    picks: int8 operands on the tensor cores, int32 on the CUDA cores;
    a tail of 2^a_bits - 1 thresholds on the count or the search."""
    out, text = run_twin(sira_report.main, ["--w-bits", str(w_bits),
                                            "--a-bits", str(a_bits)] + CPU)
    assert out["h100"] == dict(int_matmul=products, multithreshold=tail,
                               thresholds=2 ** a_bits - 1)
    (line,) = [s for s in text.splitlines() if s.startswith("H100 mapping")]
    assert tail in line and "TPU" not in line and " ms" not in line


def test_sira_report_trace_loads_and_tracer_is_restored(tmp_path):
    before = t_obs.get_tracer()
    path = tmp_path / "trace.json"
    out, text = run_twin(sira_report.main, ["--workload", "TFC",
                                            "--trace", str(path)] + CPU)
    assert t_obs.get_tracer() is before
    payload = json.loads(path.read_text())
    validate_chrome_trace(payload)
    names = {e["name"] for e in payload["traceEvents"]}
    assert any(n.startswith("flow") for n in names)
    assert any(n.startswith("lower") or n.startswith("compile")
               for n in names), sorted(names)
    assert out["trace_spans"] > 0
    assert f"wrote {path} ({out['trace_spans']} spans" in text


# ------------------------------------------------------------------ devices

@pytest.mark.parametrize("name", sorted(TWINS))
def test_default_torch_device_is_the_card(name):
    """Without ``--torch-device`` a twin asks for the card; on a machine
    without one that raises (no fall-back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TWINS[name].main([])


# ----------------------------------------------------------------- train_qat

QAT_ARGV = ["--steps", "20", "--budget", "12"]


def test_train_qat_matches_reference():
    """The reference trains from its own init; the twin trains the port's
    model built from that init and the reference's frozen scales.  Step
    1's loss is held to 1e-5 relative.  Later losses drift (2e-3 by step
    20): float32 sums of quantized products that cancel land ~1e-9 on
    either side of a ReLU's kink in the two packages, which zeroes one
    gradient and not the other, and AdamW turns that into a whole
    learning-rate step.  So the proof and the pricing run on the
    reference's trained weights carried across: every line of the
    report (proven bits, budgets, the invariant, LUT/DSP) equal."""
    runs = []

    def recording_run_qat(cfg):
        runs.append(ref_run_qat(cfg))
        return runs[-1]
    ref_run_qat = runpy.run_path(
        str(ROOT / "examples" / "train_qat.py"))["run_qat"]
    want = run_reference("train_qat", QAT_ARGV,
                         patch={"run_qat": recording_run_qat}).splitlines()
    (ref,) = runs
    jm = ref.model
    raw = jax.tree.map(np.asarray, jm._raw_init(jax.random.PRNGKey(0)))
    tm = tq.qat_model_from_reference(jm, raw, device="cpu")
    args = train_qat.parse_args(QAT_ARGV + CPU)
    res, head = run_twin(train_qat.train, args, model=tm)
    assert len(res.losses) == len(ref.losses) == 20
    np.testing.assert_allclose(res.losses[0], ref.losses[0], rtol=1e-5)
    assert np.isfinite(res.losses).all()
    head = head.splitlines()
    assert head[0] == want[0] and len(head) == 2
    assert head[1].startswith("task loss ")
    # the twin's own weights: proven within the budget on every layer
    own, _ = run_twin(train_qat.report, args, res.model, res.state.params)
    assert own["budgets"] == [12, 12, 12]
    assert max(own["proven_bits"]) <= 12 and own["invariant_checked"]
    # the reference's trained weights: the reference's report, line for line
    params = tq.params_from_reference(
        jax.tree.map(np.asarray, ref.state.params), "cpu")
    out, got = run_twin(train_qat.report, args, tm, params)
    assert got.splitlines() == want[2:]
    assert out["budgets"] == own["budgets"]


def test_train_qat_resumes_from_its_checkpoint(tmp_path):
    """``--ckpt-dir``: the same command run again resumes from the last
    checkpoint (the run's end) and reports the same losses, weights and
    proof, as the reference's example does."""
    argv = ["--budget", "12", "--hidden", "8", "--steps", "6",
            "--ckpt-dir", str(tmp_path)] + CPU
    first, _ = run_twin(train_qat.main, argv)
    again, text = run_twin(train_qat.main, argv)
    assert first["resumed_from"] == 0 and len(first["losses"]) == 6
    assert "resumed from step 6" in text.splitlines()
    assert again == dict(first, resumed_from=6)


# ----------------------------------------------------------- serve_quantized

_TIMES = re.compile(r"\d+\.\d+s|ttft=\d+\.\d+ms")


def test_serve_quantized_matches_reference():
    """The reference's weights and requests served by the twin: the fp
    and int8 greedy streams, int8 layers and pool bytes are the
    reference's."""
    engines = []
    ref_engine = runpy.run_path(
        str(ROOT / "examples" / "serve_quantized.py"))["ServingEngine"]

    class Recording(ref_engine):
        def generate(self, reqs):
            engines.append((self, super().generate(reqs)))
            return engines[-1][1]
    want = run_reference("serve_quantized",
                         patch={"ServingEngine": Recording})
    (fp, streams_fp), (_, streams_q) = engines
    cfg = serve_quantized.get_config(serve_quantized.ARCH, reduced=True)
    model = serve_quantized.get_model(cfg, device="cpu")
    model.load_reference_params(jax.tree.map(np.asarray, fp.params))
    out, got = run_twin(serve_quantized.serve, model,
                        serve_quantized.make_requests(cfg))
    assert out["streams_fp"] == streams_fp
    assert out["streams_int8"] == streams_q
    assert (out["n_int8"], out["layers"]) == (2, 2)
    assert _TIMES.sub("", got).splitlines() == \
        _TIMES.sub("", want).splitlines()
