"""The port's twin of ``tests/test_backend.py``: the PyTorch backend
(``repro_torch.core.lower``) against the numpy interpreter and against the
JAX package's compiled backend, on the four QNN workloads, on the CPU
(``device="cpu"``: the kernels' plain PyTorch versions).

Tolerances, as the reference's own test sets them: every tensor the
lowering marks integer is compared **exactly**; float64 outputs to
``rtol=atol=1e-12`` (reduction order of float matmuls/means); the float32
fast path with fused epilogues to ``rtol=1e-5, atol=1e-5·max|want|``.

The reference's float64 / Pallas-interpret path runs under
``jax.enable_x64(True)``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.workloads import ALL_WORKLOADS as J_ALL, WORKLOADS as J_WL
import repro_torch.core as tcore
from repro_torch.core import (CompileBackend, Graph, LoweringError,
                              ScaledIntRange, SiraModel, build_flow, lower,
                              model_from_reference)
from repro_torch.core.workloads import ALL_WORKLOADS as T_ALL, \
    WORKLOADS as T_WL
from repro_torch.obs.trace import Tracer, get_tracer, set_tracer

WL_NAMES = list(T_WL)
CPU = dict(device="cpu")


@functools.lru_cache(maxsize=None)
def _optimized(name):
    return build_flow(T_WL[name]()).model


@functools.lru_cache(maxsize=None)
def _ref_optimized(name):
    return jcore.build_flow(J_WL[name]()).model


def _feeds(model, batch=2, seed=0):
    shape = (batch,) + tuple(model.metadata["input_shape"][1:])
    (inp,) = model.graph.inputs
    r = model.input_ranges[inp]
    rng = np.random.default_rng(seed)
    lo = np.broadcast_to(np.asarray(r.lo, np.float64), shape)
    hi = np.broadcast_to(np.asarray(r.hi, np.float64), shape)
    return {inp: rng.uniform(lo, hi, size=shape)}


def _kinds(calls, frm, to):
    return {(to if k == frm else k): v for k, v in calls.items()}


# ---------------------------------------------------------------- (a)
@pytest.mark.parametrize("name", WL_NAMES)
def test_backend_bitexact_vs_interpreter(name):
    """float64, plain versions: the integer core is bit-exact and the float
    outputs match the numpy interpreter to 1e-12."""
    model = _optimized(name)
    compiled = model.compile(dtype=torch.float64, **CPU)
    assert compiled.int_tensors, "no integer tensors lowered"
    compiled = model.compile(dtype=torch.float64,
                             extra_outputs=compiled.int_tensors, **CPU)
    feeds = _feeds(model)
    want = model.execute(feeds, record_all=True)
    got = compiled(feeds)
    for t in compiled.int_tensors:
        assert got[t].dtype == np.int32
        np.testing.assert_array_equal(
            got[t].astype(np.float64), want[t],
            err_msg=f"integer tensor {t} not bit-exact")
    for o in model.graph.outputs:
        assert got[o].dtype == np.float64
        np.testing.assert_allclose(got[o], want[o], rtol=1e-12, atol=1e-12)
    kinds = compiled.kernel_calls
    assert kinds.get("int_matmul", 0) + kinds.get("int_conv", 0) >= 1
    assert kinds.get("multithreshold", 0) >= 1
    assert kinds.get("quantize", 0) >= 1


# ---------------------------------------------------------- (b) and (e)
@pytest.mark.parametrize("name", WL_NAMES)
def test_backend_matches_reference_pallas_interpret(name):
    """The reference's optimized model, carried across with
    ``model_from_reference``, lowers to the same plan here, and every
    integer tensor equals the reference's Pallas-interpret float64 run."""
    ref_model = _ref_optimized(name)
    model = model_from_reference(ref_model)
    feeds = _feeds(model)
    with jax.enable_x64(True):
        ref_c = ref_model.compile(use_pallas=True, interpret=True)
        ref_c = ref_model.compile(use_pallas=True, interpret=True,
                                  extra_outputs=ref_c.int_tensors)
        want = ref_c(feeds)
    compiled = model.compile(dtype=torch.float64, **CPU)
    assert compiled.int_tensors == ref_c.int_tensors
    assert [(p.node_name, p.op_type, p.kind.replace("torch", "jnp"),
             p.acc_bits) for p in compiled.plan] == \
        [(p.node_name, p.op_type, p.kind, p.acc_bits) for p in ref_c.plan]
    assert compiled.step_labels == ref_c.step_labels
    compiled = model.compile(dtype=torch.float64,
                             extra_outputs=compiled.int_tensors, **CPU)
    got = compiled(feeds)
    for t in compiled.int_tensors:
        assert got[t].dtype == want[t].dtype
        np.testing.assert_array_equal(got[t], want[t],
                                      err_msg=f"integer tensor {t}")
    for o in model.graph.outputs:
        np.testing.assert_allclose(got[o], want[o], rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------- (c) and (d)
@pytest.mark.parametrize("name", WL_NAMES)
def test_backend_fast_path_matches_reference(name):
    """float32 with fused epilogues, each package on its own flow: outputs
    agree with the interpreter and with the reference's default
    ``compile()`` to f32 precision; the plans hit the same routes."""
    model, ref_model = _optimized(name), _ref_optimized(name)
    compiled = model.compile(**CPU)
    ref_c = ref_model.compile()
    assert compiled.dtype == torch.float32
    assert compiled.kernel_calls == _kinds(ref_c.kernel_calls,
                                           "jnp", "torch")
    assert [p.acc_bits for p in compiled.plan] == \
        [p.acc_bits for p in ref_c.plan]
    feeds = _feeds(model, batch=4)
    want = model.execute(feeds)
    got = compiled(feeds)
    ref_got = ref_c(feeds)
    for o, ro in zip(model.graph.outputs, ref_model.graph.outputs):
        assert got[o].dtype == np.float32
        scale = max(float(np.abs(want[o]).max()), 1.0)
        np.testing.assert_allclose(got[o].astype(np.float64), want[o],
                                   rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(got[o], ref_got[ro],
                                   rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("name", WL_NAMES)
def test_float64_plan_matches_reference(name):
    """Exact mode: no fusion in either package, same route counts."""
    with jax.enable_x64(True):
        ref_calls = _ref_optimized(name).compile().kernel_calls
    calls = _optimized(name).compile(dtype=torch.float64, **CPU).kernel_calls
    assert not any(k.startswith("fused:") for k in calls)
    assert calls == _kinds(ref_calls, "jnp", "torch")


# ---------------------------------------------------------------- (f)
def test_hsw_is_not_lowerable_in_either_package():
    with pytest.raises(jcore.LoweringError, match="HardSwish"):
        jcore.build_flow(J_ALL["HSW-w3a4"]()).model.compile()
    with pytest.raises(LoweringError, match="HardSwish"):
        build_flow(T_ALL["HSW-w3a4"]()).model.compile(**CPU)


# ---------------------------------------------------------------- (g)
@pytest.mark.parametrize("how", ["lower", "compile", "flow_step"])
def test_no_device_means_the_card_and_raises_without_one(how):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    model = _optimized("TFC-w2a2")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if how == "lower":
            lower(model)
        elif how == "compile":
            model.compile()
        else:
            build_flow(T_WL["TFC-w2a2"](),
                       steps=list(tcore.DEFAULT_STEPS) + ["step_compile"])


def test_use_kernel_on_cpu_device_raises():
    with pytest.raises(RuntimeError, match="use_kernel=True"):
        lower(_optimized("TFC-w2a2"), device="cpu", use_kernel=True)


def test_dtype_must_be_a_float_mode():
    with pytest.raises(TypeError, match="float32 or torch.float64"):
        lower(_optimized("TFC-w2a2"), device="cpu", dtype=torch.float16)


# ---------------------------------------------------------------- (h)
def test_sira_acc_bits_reach_the_kernel():
    """acc_bits come from the SIRA accumulator bound — the low-bit
    workloads select narrow (≤15-bit → int16) accumulators."""
    compiled = _optimized("TFC-w2a2").compile(**CPU)
    acc = [op.acc_bits for op in compiled.plan
           if op.kind.startswith(("int_", "fused:int_"))]
    assert acc and all(b is not None and b <= 31 for b in acc)
    assert min(acc) <= 15, f"expected a SIRA-narrowed accumulator, got {acc}"


def test_operands_outside_int8_take_the_int32_route():
    """An unsigned 8-bit activation (0..255) does not fit int8: the matmul
    must reach the kernel with int32 operands, and stay exact; the four
    workloads themselves (inputs 0..127 or signed) go with int8."""
    from repro_torch.kernels import ops as kops
    rng = np.random.default_rng(0)
    g = Graph(inputs=["X"], outputs=["Y"])
    one = g.add_initializer(1.0)
    zero = g.add_initializer(0.0)
    b8 = g.add_initializer(8.0)
    g.add_node("Quant", ["X", one, zero, b8], ["Xq"], dict(signed=0))
    w = g.add_initializer(rng.integers(-3, 4, size=(16, 6)).astype(
        np.float64), "W")
    g.add_node("MatMul", ["Xq", w], ["Y"])
    wide = SiraModel(g, {"X": ScaledIntRange(lo=np.zeros(()),
                                             hi=np.full((), 255.0))})
    seen = []
    real = kops.int_matmul

    def spy(x, w, *a, **kw):
        seen.append((x.dtype, w.dtype))
        return real(x, w, *a, **kw)
    kops.int_matmul = spy
    try:
        feeds = {"X": rng.uniform(0, 255, size=(5, 16))}
        got = lower(wide, **CPU)(feeds)["Y"]
        tfc = _optimized("TFC-w2a2")
        tfc.compile(**CPU)(_feeds(tfc))
    finally:
        kops.int_matmul = real
    np.testing.assert_array_equal(got.astype(np.float64),
                                  wide.execute(feeds)["Y"])
    assert seen[0] == (torch.int32, torch.int32)
    assert set(seen[1:]) == {(torch.int8, torch.int8)}


def test_fused_epilogue_in_f32_mode():
    model = _optimized("TFC-w2a2")
    fused = model.compile(dtype=torch.float32, **CPU)
    assert any(op.kind.startswith("fused:") for op in fused.plan)
    unfused = model.compile(dtype=torch.float32, fuse_epilogue=False, **CPU)
    assert not any(op.kind.startswith("fused:") for op in unfused.plan)
    feeds = _feeds(model)
    for o in model.graph.outputs:
        np.testing.assert_allclose(fused(feeds)[o], unfused(feeds)[o],
                                   rtol=1e-5, atol=1e-5)


def _biased_conv_model():
    rng = np.random.default_rng(0)
    g = Graph(inputs=["X"], outputs=["out"])
    one = g.add_initializer(1.0)
    zero = g.add_initializer(0.0)
    b8 = g.add_initializer(8.0)
    g.add_node("Quant", ["X", one, zero, b8], ["Xq"], dict(signed=1))
    w = g.add_initializer(rng.integers(-3, 4, size=(4, 3, 3, 3)).astype(
        np.float64), "W")
    cb = g.add_initializer(rng.integers(-5, 6, size=(4,)).astype(
        np.float64), "Cb")
    g.add_node("Conv", ["Xq", w, cb], ["conv"], dict(stride=1, pad=1))
    s = g.add_initializer(rng.uniform(0.1, 0.5, size=(4, 1, 1)), "S")
    a = g.add_initializer(rng.normal(size=(4, 1, 1)), "A")
    g.add_node("Mul", ["conv", s], ["scaled"])
    g.add_node("Add", ["scaled", a], ["out"])
    return SiraModel(g, {"X": ScaledIntRange(lo=np.full((), -5.0),
                                             hi=np.full((), 5.0))},
                     metadata=dict(input_shape=(1, 3, 8, 8)))


def test_biased_conv_not_epilogue_fused():
    """Conv-with-bias followed by Mul/Add must add the bias *before* the
    scale chain, so the lowering keeps them separate."""
    model = _biased_conv_model()
    compiled = lower(model, dtype=torch.float32, **CPU)
    assert not any(op.kind.startswith("fused:") for op in compiled.plan)
    assert compiled.kernel_calls.get("int_conv") == 1
    feeds = {"X": np.random.default_rng(1).uniform(-5, 5,
                                                   size=(2, 3, 8, 8))}
    got = compiled(feeds)["out"]
    want = model.execute(feeds)["out"]
    np.testing.assert_allclose(got.astype(np.float64), want,
                               rtol=1e-5, atol=1e-5)


def test_integer_gemm_gets_int_matmul_route():
    rng = np.random.default_rng(0)
    g = Graph(inputs=["X"], outputs=["Y"])
    one = g.add_initializer(1.0)
    zero = g.add_initializer(0.0)
    b4 = g.add_initializer(4.0)
    g.add_node("Quant", ["X", one, zero, b4], ["Xq"], dict(signed=1))
    w = g.add_initializer(rng.integers(-3, 4, size=(16, 6)).astype(
        np.float64), "W")
    c = g.add_initializer(rng.integers(-9, 9, size=(6,)).astype(
        np.float64), "C")
    g.add_node("Gemm", ["Xq", w, c], ["Y"])
    model = SiraModel(g, {"X": ScaledIntRange(lo=np.full((), -7.0),
                                              hi=np.full((), 7.0))})
    compiled = lower(model, dtype=torch.float32, **CPU)
    mm = [op for op in compiled.plan if op.kind == "int_matmul"]
    assert mm and mm[0].acc_bits is not None and mm[0].acc_bits <= 15
    feeds = {"X": np.random.default_rng(1).uniform(-7, 7, size=(3, 16))}
    np.testing.assert_array_equal(compiled(feeds)["Y"].astype(np.float64),
                                  model.execute(feeds)["Y"])
    # the synthetic matmul sub-tensor must not leak into int_tensors, nor
    # its synthetic range into the model's cached analysis
    assert not any(t.endswith("_mm_tmp") for t in compiled.int_tensors)
    assert not any(t.endswith("_mm_tmp") for t in model.ranges)
    compiled2 = lower(model, dtype=torch.float32,
                      extra_outputs=compiled.int_tensors, **CPU)
    got = compiled2(feeds)
    assert all(t in got for t in compiled.int_tensors)


@pytest.mark.parametrize("extra,match", [
    (["no_such_tensor"], "extra output"),
    (["fc3_out"], None),
])
def test_extra_outputs_validated_at_lower_time(extra, match):
    model = _optimized("TFC-w2a2")
    if match is None:
        # a tensor eliminated by epilogue fusion is refused too, with the hint
        fused_away = [t for t in lower(
            model, fuse_epilogue=False, **CPU).int_tensors
            if t not in lower(model, **CPU).int_tensors]
        assert fused_away, "expected fusion to eliminate an integer tensor"
        extra, match = fused_away[:1], "fuse_epilogue=False"
    with pytest.raises(LoweringError, match=match):
        model.compile(extra_outputs=extra, **CPU)


def test_unsupported_op_raises_lowering_error():
    g = Graph(inputs=["X"], outputs=["Y"])
    g.add_node("Gather", ["T", "X"], ["Y"])
    g.add_initializer(np.arange(8.0), "T")
    model = SiraModel(g, {"X": ScaledIntRange(lo=np.zeros(()),
                                              hi=np.ones(()))})
    with pytest.raises(LoweringError):
        lower(model, **CPU)


def test_step_compile_flow_step():
    """``CompileBackend`` as a flow step stores the executable under
    metadata['compiled'] without modifying the graph."""
    wl = T_WL["TFC-w2a2"]()
    res = build_flow(wl, steps=list(tcore.DEFAULT_STEPS)
                     + [CompileBackend(device="cpu")])
    compiled = res.model.metadata["compiled"]
    step = res.steps[-1]
    assert step.name == "step_compile" and not step.modified
    feeds = _feeds(res.model)
    got = compiled(feeds)
    want = res.model.execute(feeds)
    for o in res.model.graph.outputs:
        np.testing.assert_allclose(got[o].astype(np.float64), want[o],
                                   rtol=1e-5, atol=1e-4)


def test_compiled_runs_any_batch_and_drops_analysis_state():
    model = _optimized("TFC-w2a2")
    compiled = model.compile(**CPU)
    for batch in (1, 3, 8):
        out = compiled(_feeds(model, batch=batch))[model.graph.outputs[0]]
        assert out.shape[0] == batch
    assert compiled.device == torch.device("cpu")
    assert not hasattr(compiled, "model")


def test_profile_emits_one_span_per_step():
    model = _optimized("CNV-w2a2")
    compiled = model.compile(**CPU)
    feeds = _feeds(model)
    tracer = Tracer(enabled=True)
    prev = get_tracer()
    set_tracer(tracer)
    try:
        got = compiled.profile(feeds)
    finally:
        set_tracer(prev)
    names = [s.name for s in tracer.spans]
    assert [n for n in names if n.startswith("kernel:")] == \
        [f"kernel:{lab}" for lab in compiled.step_labels]
    want = compiled(feeds)
    for o in model.graph.outputs:
        np.testing.assert_array_equal(got[o], want[o])
