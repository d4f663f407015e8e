"""Compiled execution backend: lower an optimized ``SiraModel`` into an
eager PyTorch step list backed by the CUDA kernels.

``Graph.execute`` is a per-node numpy interpreter — fine for analysis and
verification, but it leaves the kernels in ``repro_torch.kernels`` unused.
This module closes the analysis→execution gap (the paper's §4.1–4.2
optimizations only pay off at execution time, as FINN-R's end-to-end build
flow demonstrates):

  * integer ``MatMul``/``Conv`` (im2col, grouped) → :func:`kernels.int_matmul`
    with ``acc_bits`` taken from the SIRA accumulator bound of the output
    range (§4.2 — a 16-bit accumulator when the lossless width ≤ 15 bits);
  * ``MultiThreshold`` → the fused :func:`kernels.multithreshold` kernel
    (transposing the graph's (C, N) threshold layout to the kernel's
    (N, C), handling ``axis`` and the ``out_scale``/``out_bias`` attrs);
  * ``Quant`` → the fused :func:`kernels.quantize` kernel;
  * a ``MatMul/Conv → Mul(const) → Add(const)`` chain is fused into the
    int_matmul's aggregated scale/bias epilogue (float32 mode only — the
    kernel epilogue computes in f32, so exact-mode lowering keeps the
    elementwise nodes separate);
  * residual elementwise ops, pooling and reshapes → plain torch;
  * constant subgraphs (e.g. leftover ``Mul(q_W, s_w)`` weight scaling)
    are folded at build time through the *numpy executor itself*, so
    folded values match ``Graph.execute`` bit for bit.

The lowering is dtype-faithful: tensors whose SIRA range proves them
integer-valued (scale 1, integral bias) are kept as int32 end to end, so
the integer core of the network — quantizers, integer matmuls/convs,
thresholds, residual adds — is **bit-exact** against the numpy
interpreter (asserted per-tensor by the backend tests).  Float epilogues
may differ from numpy in the last ulp (reduction order of float
matmuls/means).  Pass ``dtype=torch.float64`` for tightest-tolerance
comparisons.

The device is explicit.  ``device=None`` means the card (``"cuda"``) and
raises when there is none; nothing falls back to the CPU.  On a card the
three kernels are the hand-written CUDA ones; on ``device="cpu"`` (what
the tests pass) they are the plain PyTorch versions of ``kernels/ref.py``.
The step list is built once and run eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels.int_matmul import k_major
from ..obs.trace import get_tracer
from .graph import Graph, Node, quant_bounds
from .intervals import ScaledIntRange
from .model import SiraModel
from .ops import EXEC_REGISTRY
from .passes import Transformation

Env = Dict[str, torch.Tensor]

INT_DTYPE = torch.int32
MAX_INT32_BITS = 31

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64,
             torch.int32: np.int32, torch.int8: np.int8}


class LoweringError(NotImplementedError):
    """A node the compiled backend cannot lower (op type, dtype, or shape
    combination outside the supported surface)."""


@dataclasses.dataclass
class LoweredOp:
    """One plan entry — which kernel/route a node was lowered to."""
    node_name: str
    op_type: str
    kind: str            # "int_matmul" | "int_conv" | "multithreshold" |
    #                      "quantize" | "const_fold" | "torch" | "fused:<...>"
    acc_bits: Optional[int] = None


def _signed_bits(lo: float, hi: float) -> int:
    """Two's-complement width for an integer value interval (paper §4.2)."""
    m = max(abs(lo), abs(hi) + 1.0)
    if m <= 1.0:
        return 1
    return int(np.ceil(np.log2(m))) + 1


def _integral(a: np.ndarray) -> bool:
    return bool(np.all(np.isfinite(a)) and np.all(a == np.round(a)))


def resolve_device(device) -> torch.device:
    """``None`` → the card.  Asking for a card that is not there raises:
    the backend never picks the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for"
            f"{' (the default, device=None)' if device is None else ''} "
            f"but no CUDA device is available; pass device='cpu' to run "
            f"the plain PyTorch versions on the CPU")
    return dev


class _Lowerer:
    """Single-use builder: walks the toposorted graph once and emits a list
    of closures over a name→tensor environment."""

    def __init__(self, model: SiraModel, *, device: torch.device,
                 use_kernel: bool, dtype, fuse_epilogue: bool):
        self.model = model
        self.g: Graph = model.graph
        # local copy: the Gemm lowering registers synthetic sub-tensor
        # ranges, which must not leak into the model's cached analysis
        self.ranges = dict(model.ranges)
        self.device = device
        self.use_kernel = use_kernel
        self.dtype = dtype
        self.fuse_epilogue = fuse_epilogue
        # build-time constant store, seeded from the initializers and grown
        # by constant folding (numpy, via the graph's own executors)
        self.consts: Dict[str, np.ndarray] = dict(self.g.initializers)
        self._const_cache: Dict[Tuple[str, bool], torch.Tensor] = {}
        self.is_int: Dict[str, bool] = {}      # dynamic tensors only
        self.steps: List[Callable[[Env], None]] = []
        # one human-readable label per step closure (for profile() spans);
        # NOT 1:1 with self.plan — const folds add plan entries only
        self.step_labels: List[str] = []
        self.plan: List[LoweredOp] = []
        self._skip: set = set()                # nodes consumed by fusion

    # ------------------------------------------------------------- helpers
    def _kargs(self) -> Dict[str, Any]:
        return dict(use_kernel=self.use_kernel)

    def _dev(self, a, dtype) -> torch.Tensor:
        """A numpy value as a tensor of ``dtype`` on the target device
        (converted by numpy first, so the value is numpy's)."""
        return torch.tensor(np.asarray(a, _NP_DTYPE[dtype]),
                            device=self.device)

    def _weight(self, w, dtype) -> torch.Tensor:
        """A (K, N) integer weight of ``int_matmul`` on the device, stored
        once: int8 K-major (an (N, K) matrix, rows padded to 16 bytes,
        seen as (K, N)), the layout the tensor-core kernel reads, so no
        call copies it; int32 as it is (the CUDA-core kernel takes any
        strides)."""
        t = self._dev(w, dtype)
        return k_major(t) if dtype == torch.int8 else t

    def _const(self, name: str, as_int: bool = False) -> torch.Tensor:
        """Constant as a dtype-converted tensor on the device, uploaded
        once per (name, as_int) — no step uploads a constant per call."""
        key = (name, as_int)
        cached = self._const_cache.get(key)
        if cached is None:
            cached = self._dev(self.consts[name],
                               INT_DTYPE if as_int else self.dtype)
            self._const_cache[key] = cached
        return cached

    def _int_range_bits(self, tensor: str) -> Optional[int]:
        """Accumulator width for an integer-valued tensor, from its SIRA
        range (None when the range does not prove integrality)."""
        r = self.ranges.get(tensor)
        if r is None or not r.is_scaled_int:
            return None
        if not (np.all(r.scale == 1.0) and _integral(np.asarray(r.bias))):
            return None
        return _signed_bits(float(np.min(r.lo)), float(np.max(r.hi)))

    def _tensor_is_int(self, tensor: str) -> bool:
        if tensor in self.consts:
            return _integral(self.consts[tensor])
        return self.is_int.get(tensor, False)

    def _fits(self, tensor: str, lo: int, hi: int) -> bool:
        if tensor in self.consts:
            v = self.consts[tensor]
            return bool(v.min() >= lo and v.max() <= hi)
        r = self.ranges.get(tensor)
        return (r is not None and float(np.min(r.lo)) >= lo
                and float(np.max(r.hi)) <= hi)

    def _get(self, env: Env, name: str, *, as_int=False) -> torch.Tensor:
        if name in self.consts:
            return self._const(name, as_int=as_int)
        return env[name]

    def _getf(self, env: Env, name: str) -> torch.Tensor:
        """Fetch as the float compute dtype (casting int tensors)."""
        v = self._get(env, name)
        return v.to(self.dtype) if v.dtype != self.dtype else v

    def _push(self, run: Callable[[Env], None]) -> None:
        self.steps.append(run)

    # ---------------------------------------------------------------- build
    def build(self) -> None:
        self.g.toposort()
        for node in self.g.nodes:
            if node.name in self._skip:
                continue
            n0 = len(self.steps)
            if all(t in self.consts for t in node.inputs):
                self._fold(node)
                continue
            fn = getattr(self, f"_lower_{node.op_type.lower()}", None)
            if fn is None:
                raise LoweringError(
                    f"no lowering for op {node.op_type!r} "
                    f"(node {node.name})")
            fn(node)
            self.step_labels.extend(
                f"{node.op_type}:{node.name}"
                for _ in range(len(self.steps) - n0))
        for out in self.g.outputs:
            if out not in self.consts and out not in self.is_int:
                raise LoweringError(f"graph output {out} was never lowered")
        # the step closures only touch consts/dtype/kernel args — drop the
        # graph/analysis references so a long-lived CompiledSiraModel does
        # not pin the range arrays and model
        self.ranges = None
        self.model = None
        self.g = None

    def _fold(self, node: Node) -> None:
        """Constant-fold through the numpy executor — bit-identical to what
        Graph.execute would compute for this node."""
        fn = EXEC_REGISTRY.get(node.op_type)
        if fn is None:
            raise LoweringError(f"no executor to fold {node.op_type}")
        args = [np.asarray(self.consts[t], np.float64) for t in node.inputs]
        outs = fn(node, *args)
        if not isinstance(outs, tuple):
            outs = (outs,)
        for name, val in zip(node.outputs, outs):
            self.consts[name] = np.asarray(val, np.float64)
        self.plan.append(LoweredOp(node.name, node.op_type, "const_fold"))

    # ------------------------------------------------------------ epilogue
    def _epilogue_chain(self, node: Node
                        ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                            List[Node], str]]:
        """Detect MatMul/Conv → Mul(const) → [Add(const)] with single
        consumers, returning (scale, bias, fused_nodes, final_tensor)."""
        t = node.outputs[0]
        if t in self.g.outputs:
            return None
        cons = self.g.consumers(t)
        if len(cons) != 1 or cons[0].op_type != "Mul":
            return None
        mul = cons[0]
        if mul.inputs[0] != t or mul.inputs[1] not in self.consts:
            return None
        scale = np.asarray(self.consts[mul.inputs[1]], np.float64).reshape(-1)
        fused = [mul]
        final = mul.outputs[0]
        bias = np.zeros((1,))
        if final not in self.g.outputs:
            cons2 = self.g.consumers(final)
            if (len(cons2) == 1 and cons2[0].op_type == "Add"
                    and cons2[0].inputs[0] == final
                    and cons2[0].inputs[1] in self.consts):
                add = cons2[0]
                bias = np.asarray(self.consts[add.inputs[1]],
                                  np.float64).reshape(-1)
                fused.append(add)
                final = add.outputs[0]
        n_out = self._matmul_out_channels(node)
        if scale.size not in (1, n_out) or bias.size not in (1, n_out):
            return None
        return (np.broadcast_to(scale, (n_out,)).astype(np.float32),
                np.broadcast_to(bias, (n_out,)).astype(np.float32),
                fused, final)

    def _matmul_out_channels(self, node: Node) -> int:
        w = self.consts.get(node.inputs[1])
        if w is None:
            return -1
        return int(w.shape[0] if node.op_type == "Conv" else w.shape[-1])

    # ------------------------------------------------------------- lowering
    def _lower_quant(self, node: Node) -> None:
        x_t, s_t, z_t, b_t = node.inputs
        out = node.outputs[0]
        s = np.asarray(self.consts[s_t], np.float64)
        z = np.asarray(self.consts[z_t], np.float64)
        bits = int(np.asarray(self.consts[b_t]).reshape(-1)[0])
        signed = bool(node.attrs.get("signed", 1))
        narrow = bool(node.attrs.get("narrow", 0))
        qmin, qmax = quant_bounds(bits, signed, narrow)
        qmin, qmax = int(qmin), int(qmax)
        trivial = bool(np.all(s == 1.0) and np.all(z == 0.0))
        # the fused kernel needs a per-last-axis (C,) or scalar layout
        kernelable = s.size == 1 and z.size == 1
        dtype, kargs = self.dtype, self._kargs()
        sd, zd = self._dev(s, dtype), self._dev(z, dtype)
        if kernelable:
            # rounded to float32 even in float64 mode (the kernel takes its
            # parameters in float32 and promotes them), as in the reference
            s_arr = self._dev(s.reshape(-1), torch.float32)
            z_arr = self._dev(z.reshape(-1), torch.float32)

            def run(env: Env) -> None:
                x = self._getf(env, x_t)
                c = x.shape[-1]
                q = kops.quantize(x.reshape(-1, c), s_arr, z_arr,
                                  qmin=qmin, qmax=qmax,
                                  out_dtype=INT_DTYPE, **kargs)
                q = q.reshape(x.shape)
                if trivial:
                    env[out] = q
                else:
                    env[out] = sd * (q.to(dtype) - zd)
            kind = "quantize"
        else:  # arbitrary-granularity scale: plain torch (still one pass)
            def run(env: Env) -> None:
                x = self._getf(env, x_t)
                q = torch.clamp(torch.round(x / sd + zd), qmin, qmax)
                env[out] = q.to(INT_DTYPE) if trivial else sd * (q - zd)
            kind = "torch"
        self.is_int[out] = trivial
        self._push(run)
        self.plan.append(LoweredOp(node.name, "Quant", kind))

    # ---- integer / float matmul ------------------------------------------
    def _acc_bits(self, out_tensor: str) -> int:
        bits = self._int_range_bits(out_tensor)
        return MAX_INT32_BITS + 1 if bits is None else bits

    def _lower_matmul(self, node: Node) -> None:
        a_t, b_t = node.inputs
        out = node.outputs[0]
        w = self.consts.get(b_t)
        int_ok = (w is not None and _integral(w)
                  and self._tensor_is_int(a_t)
                  and self._acc_bits(out) <= MAX_INT32_BITS)
        if not int_ok:
            def run(env: Env) -> None:
                a = self._getf(env, a_t)
                b = self._getf(env, b_t)
                env[out] = a @ b
            self.is_int[out] = False
            self._push(run)
            self.plan.append(LoweredOp(node.name, "MatMul", "torch"))
            return

        acc_bits = self._acc_bits(out)
        in8 = self._fits(a_t, -128, 127) and self._fits(b_t, -128, 127)
        in_dtype = torch.int8 if in8 else INT_DTYPE
        wq = self._weight(w, in_dtype)
        K = int(w.shape[0])
        fused = self.fuse_epilogue and self._epilogue_chain(node)
        kargs = self._kargs()
        if fused:
            scale, bias, fused_nodes, final = fused
            s_arr = self._dev(scale, torch.float32)
            b_arr = self._dev(bias, torch.float32)

            def run(env: Env) -> None:
                a = self._get(env, a_t)
                lead = a.shape[:-1]
                y = kops.int_matmul(a.reshape(-1, K).to(in_dtype), wq,
                                    s_arr, b_arr, acc_bits=acc_bits,
                                    out_dtype=torch.float32, **kargs)
                env[final] = y.reshape(lead + (y.shape[-1],))
            for n in fused_nodes:
                self._skip.add(n.name)
            self.is_int[final] = False
            self._push(run)
            self.plan.append(LoweredOp(node.name, "MatMul",
                                       "fused:int_matmul+epilogue",
                                       acc_bits=acc_bits))
            return

        def run(env: Env) -> None:
            a = self._get(env, a_t)
            lead = a.shape[:-1]
            y = kops.int_matmul(a.reshape(-1, K).to(in_dtype), wq,
                                acc_bits=acc_bits, out_dtype=INT_DTYPE,
                                **kargs)
            env[out] = y.reshape(lead + (y.shape[-1],))
        self.is_int[out] = True
        self._push(run)
        self.plan.append(LoweredOp(node.name, "MatMul", "int_matmul",
                                   acc_bits=acc_bits))

    def _lower_gemm(self, node: Node) -> None:
        # Gemm = MatMul + optional bias; reuse the matmul route then add
        if len(node.inputs) == 2:
            return self._lower_matmul(node)
        a_t, b_t, c_t = node.inputs
        out = node.outputs[0]
        mm = Node("MatMul", [a_t, b_t], [out + "_mm_tmp"], {},
                  name=node.name + "_mm")
        # the synthetic matmul output has no SIRA range of its own; when
        # the Gemm output is proven integer and the bias is an integral
        # constant, shift the output range by the bias so the matmul part
        # still gets its accumulator bound (and the int_matmul route)
        r_out = self.ranges.get(out)
        if (r_out is not None and self._int_range_bits(out) is not None
                and c_t in self.consts and _integral(self.consts[c_t])):
            b = np.asarray(self.consts[c_t], np.float64)
            self.ranges[mm.outputs[0]] = ScaledIntRange.from_scaled_int(
                r_out.lo - b, r_out.hi - b, 1.0, 0.0)
        # lower the matmul part without epilogue fusion (bias follows)
        saved = self.fuse_epilogue
        self.fuse_epilogue = False
        try:
            self._lower_matmul(mm)
        finally:
            self.fuse_epilogue = saved
        mm_out = mm.outputs[0]
        # the synthetic sub-tensor is popped from the env below and must
        # not be advertised (int_tensors / extra_outputs) as addressable
        mm_int = self.is_int.pop(mm_out, False)
        bias_int = (c_t in self.consts and _integral(self.consts[c_t])
                    and mm_int)
        dtype = self.dtype

        def run(env: Env) -> None:
            y = env.pop(mm_out)
            if bias_int:
                env[out] = y + self._get(env, c_t, as_int=True)
            else:
                env[out] = y.to(dtype) + self._getf(env, c_t)
        self.is_int[out] = bias_int
        self._push(run)
        self.plan.append(LoweredOp(node.name, "Gemm", "torch"))

    # ---- conv (im2col) ----------------------------------------------------
    @staticmethod
    def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int, pad: int
                ) -> Tuple[torch.Tensor, int, int]:
        """(n, c, h, w) → the (n*ho*wo, c*kh*kw) patch matrix, columns in
        the numpy executor's patch order (channel, then kernel row, then
        kernel column).  Slice-and-stack: ``F.unfold`` takes no integers.

        The patches are gathered channels-last, so the one copy ``stack``
        makes is already the row-major matrix the matmul wants; the
        ``permute`` is free when x is channels-last in memory, which is
        how a conv or threshold step leaves its output."""
        n, c = x.shape[0], x.shape[1]
        xh = x.permute(0, 2, 3, 1)               # (n, h, w, c)
        if pad:
            xh = F.pad(xh, (0, 0, pad, pad, pad, pad))
        ho = (xh.shape[1] - kh) // stride + 1
        wo = (xh.shape[2] - kw) // stride + 1
        parts = [xh[:, i:i + stride * ho:stride, j:j + stride * wo:stride]
                 for i in range(kh) for j in range(kw)]
        cols = torch.stack(parts, dim=-1)        # (n, ho, wo, c, kh*kw)
        return cols.reshape(n * ho * wo, c * kh * kw), ho, wo

    def _lower_conv(self, node: Node) -> None:
        x_t, w_t = node.inputs[:2]
        b_t = node.inputs[2] if len(node.inputs) > 2 else None
        out = node.outputs[0]
        stride = int(node.attrs.get("stride", 1))
        pad = int(node.attrs.get("pad", 0))
        groups = int(node.attrs.get("groups", 1))
        w = self.consts.get(w_t)
        if w is None:
            raise LoweringError(f"Conv {node.name} needs a constant weight")
        cout, cin_g, kh, kw = (int(d) for d in w.shape)
        og = cout // groups
        acc_bits = self._acc_bits(out)
        int_ok = (_integral(w) and self._tensor_is_int(x_t)
                  and acc_bits <= MAX_INT32_BITS
                  and (b_t is None or _integral(self.consts[b_t])))
        dtype, kargs = self.dtype, self._kargs()
        # no epilogue fusion over a biased conv: the kernel epilogue runs
        # scale/bias on the raw accumulator, but the conv bias must be
        # added *before* the Mul/Add chain
        fused = (int_ok and b_t is None and self.fuse_epilogue
                 and self._epilogue_chain(node)) or None
        if int_ok:
            in8 = self._fits(x_t, -128, 127) and self._fits(w_t, -128, 127)
            in_dtype = torch.int8 if in8 else INT_DTYPE
        else:
            in_dtype = dtype
        to_dev = self._weight if int_ok else self._dev
        wmats = [to_dev(
            w[g * og:(g + 1) * og].reshape(og, cin_g * kh * kw).T,
            in_dtype) for g in range(groups)]
        sgs = bgs = [None] * groups
        if fused:
            scale, bias, fused_nodes, final = fused
            for n in fused_nodes:
                self._skip.add(n.name)
            sgs = [self._dev(scale[g * og:(g + 1) * og], torch.float32)
                   for g in range(groups)]
            bgs = [self._dev(bias[g * og:(g + 1) * og], torch.float32)
                   for g in range(groups)]
        else:
            final = out
        bias_t = None if b_t is None else \
            self._const(b_t, as_int=int_ok).reshape(1, -1, 1, 1)

        def run(env: Env) -> None:
            x = self._get(env, x_t) if int_ok else self._getf(env, x_t)
            n = x.shape[0]
            outs = []
            # one kernel launch per group, as the reference does
            for g in range(groups):
                # cast before the patches are gathered: same values, and
                # int8 patches are a quarter of the bytes
                xg = x[:, g * cin_g:(g + 1) * cin_g].to(in_dtype)
                a2, ho, wo = self._im2col(xg, kh, kw, stride, pad)
                if int_ok:
                    y2 = kops.int_matmul(
                        a2, wmats[g], sgs[g], bgs[g], acc_bits=acc_bits,
                        out_dtype=torch.float32 if fused else INT_DTYPE,
                        **kargs)
                else:
                    y2 = a2 @ wmats[g]
                # (n, og, ho, wo) as a view: no copy back to NCHW order
                outs.append(y2.reshape(n, ho, wo, og).permute(0, 3, 1, 2))
            y = outs[0] if groups == 1 else torch.cat(outs, dim=1)
            if bias_t is not None:
                y = y + bias_t
            env[final] = y
        self.is_int[final] = bool(int_ok and not fused)
        self._push(run)
        kind = ("fused:int_conv+epilogue" if fused
                else ("int_conv" if int_ok else "torch"))
        self.plan.append(LoweredOp(node.name, "Conv", kind,
                                   acc_bits=acc_bits if int_ok else None))

    # ---- multithreshold ----------------------------------------------------
    def _lower_multithreshold(self, node: Node) -> None:
        x_t, thr_t = node.inputs[:2]
        out = node.outputs[0]
        axis = int(node.attrs.get("axis", -1))
        out_scale = np.asarray(node.attrs.get("out_scale", 1.0),
                               np.float64).reshape(-1)
        out_bias = np.asarray(node.attrs.get("out_bias", 0.0),
                              np.float64).reshape(-1)
        thr = np.asarray(self.consts[thr_t], np.float64)   # (C, N)
        C, N = thr.shape
        x_int = self._tensor_is_int(x_t)
        thr_int = _integral(thr)
        # Integer fast path when both the input and the thresholds are
        # integral; scaled-entry tails (thresholds in real units at grid
        # midpoints, see core.thresholds) fall back to a float compare —
        # the count is exact either way because the midpoint placement
        # absorbs floating-point noise on the entry tensor.
        int_cmp = x_int and thr_int
        thrT = self._dev(thr.T, INT_DTYPE if int_cmp else self.dtype)
        unit = bool(np.all(out_scale == 1.0))
        int_bias = _integral(out_bias) and out_bias.size == 1
        int_out = unit and int_bias
        ob = int(out_bias[0]) if int_bias else 0
        dtype, kargs = self.dtype, self._kargs()
        os_t = self._dev(out_scale, self.dtype)
        ob_t = self._dev(out_bias, self.dtype)

        def run(env: Env) -> None:
            x = env[x_t]
            xm = torch.movedim(x, axis, -1)
            lead = xm.shape[:-1]
            cx = xm.shape[-1]
            t = thrT if C == cx else thrT.expand(N, cx)
            # reshape copies a moved axis into (M, C) row-major order; the
            # kernel wrapper takes contiguous operands
            x2 = xm.reshape(-1, cx)
            if not int_cmp and x2.dtype != t.dtype:
                x2 = x2.to(t.dtype)
            if int_out:
                y2 = kops.multithreshold(x2, t, out_bias=ob,
                                         out_dtype=INT_DTYPE, **kargs)
            else:
                cnt = kops.multithreshold(x2, t, out_bias=0,
                                          out_dtype=INT_DTYPE, **kargs)
                y2 = ob_t + os_t * cnt.to(dtype)
            env[out] = torch.movedim(y2.reshape(lead + (cx,)), -1, axis)
        self.is_int[out] = int_out
        self._push(run)
        self.plan.append(LoweredOp(node.name, "MultiThreshold",
                                   "multithreshold"))

    # ---- elementwise / structural -----------------------------------------
    def _lower_binary(self, node: Node, op) -> None:
        a_t, b_t = node.inputs
        out = node.outputs[0]
        # integer-closed only for Add/Sub/Mul on integer operands
        closed = node.op_type in ("Add", "Sub", "Mul")
        bits = self._int_range_bits(out)
        int_out = (closed and self._tensor_is_int(a_t)
                   and self._tensor_is_int(b_t)
                   and bits is not None and bits <= MAX_INT32_BITS)

        def run(env: Env) -> None:
            if int_out:
                a = self._get(env, a_t, as_int=True)
                b = self._get(env, b_t, as_int=True)
            else:
                a, b = self._getf(env, a_t), self._getf(env, b_t)
            env[out] = op(a, b)
        self.is_int[out] = int_out
        self._push(run)
        self.plan.append(LoweredOp(node.name, node.op_type, "torch"))

    def _lower_add(self, node):
        self._lower_binary(node, lambda a, b: a + b)

    def _lower_sub(self, node):
        self._lower_binary(node, lambda a, b: a - b)

    def _lower_mul(self, node):
        self._lower_binary(node, lambda a, b: a * b)

    def _lower_div(self, node):
        a_t, b_t = node.inputs
        out = node.outputs[0]

        def run(env: Env) -> None:
            env[out] = self._getf(env, a_t) / self._getf(env, b_t)
        self.is_int[out] = False
        self._push(run)
        self.plan.append(LoweredOp(node.name, "Div", "torch"))

    def _lower_unary(self, node: Node, op, preserves_int: bool) -> None:
        x_t = node.inputs[0]
        out = node.outputs[0]
        int_out = preserves_int and self._tensor_is_int(x_t)

        def run(env: Env) -> None:
            x = self._get(env, x_t) if int_out else self._getf(env, x_t)
            env[out] = op(x)
        self.is_int[out] = int_out
        self._push(run)
        self.plan.append(LoweredOp(node.name, node.op_type, "torch"))

    def _lower_relu(self, node):
        self._lower_unary(node, lambda x: torch.clamp(x, min=0), True)

    def _lower_identity(self, node):
        self._lower_unary(node, lambda x: x, True)

    def _lower_sigmoid(self, node):
        self._lower_unary(node, torch.sigmoid, False)

    def _lower_tanh(self, node):
        self._lower_unary(node, torch.tanh, False)

    def _lower_silu(self, node):
        self._lower_unary(node, F.silu, False)

    def _lower_gelu(self, node):
        sqrt2 = float(np.sqrt(2.0))
        self._lower_unary(
            node, lambda x: 0.5 * x * (1.0 + torch.special.erf(x / sqrt2)),
            False)

    def _lower_softcap(self, node):
        cap = float(node.attrs["cap"])
        self._lower_unary(node, lambda x: cap * torch.tanh(x / cap), False)

    def _lower_floor(self, node):
        self._lower_unary(node, torch.floor, True)

    def _lower_round(self, node):
        self._lower_unary(node, torch.round, True)

    def _lower_clip(self, node):
        def bound(i):
            if len(node.inputs) <= i:
                return None
            return self._dev(self.consts[node.inputs[i]], self.dtype)
        lo, hi = bound(1), bound(2)
        if lo is None and hi is None:
            self._lower_unary(node, lambda x: x, False)
        else:
            self._lower_unary(
                node, lambda x: torch.clamp(x, min=lo, max=hi), False)

    def _lower_softmax(self, node):
        ax = int(node.attrs.get("axis", -1))
        self._lower_unary(node, lambda x: torch.softmax(x, dim=ax), False)

    def _lower_flatten(self, node):
        self._lower_unary(node, lambda x: x.reshape(x.shape[0], -1), True)

    def _lower_reshape(self, node):
        shape = tuple(node.attrs["shape"])
        self._lower_unary(node, lambda x: x.reshape(shape), True)

    def _lower_transpose(self, node):
        perm = tuple(node.attrs["perm"])
        self._lower_unary(node, lambda x: x.permute(perm), True)

    def _lower_maxpool(self, node):
        k = int(node.attrs.get("kernel", 2))
        s = int(node.attrs.get("stride", k))

        def op(x):
            # slice form: F.max_pool2d has no int32 path on the card
            ho = (x.shape[2] - k) // s + 1
            wo = (x.shape[3] - k) // s + 1
            slices = [x[:, :, i:i + s * ho:s, j:j + s * wo:s]
                      for i in range(k) for j in range(k)]
            out = slices[0]
            for sl in slices[1:]:
                out = torch.maximum(out, sl)
            return out
        self._lower_unary(node, op, True)

    def _lower_averagepool(self, node):
        k = int(node.attrs.get("kernel", 2))
        s = int(node.attrs.get("stride", k))
        dtype = self.dtype

        def op(x):
            ho = (x.shape[2] - k) // s + 1
            wo = (x.shape[3] - k) // s + 1
            acc = sum(x[:, :, i:i + s * ho:s, j:j + s * wo:s]
                      for i in range(k) for j in range(k))
            return acc.to(dtype) / (k * k)
        self._lower_unary(node, op, False)

    def _lower_globalaveragepool(self, node):
        dtype = self.dtype

        def op(x):
            # exact for integer inputs: the sum is an exact float, and one
            # IEEE division matches numpy's mean (an int32 sum comes back
            # as int64 in torch; the cast is exact either way)
            n = x.shape[2] * x.shape[3]
            return x.sum(dim=(2, 3), keepdim=True).to(dtype) / n
        self._lower_unary(node, op, False)

    def _lower_concat(self, node):
        ax = int(node.attrs.get("axis", -1))
        in_ts = list(node.inputs)
        out = node.outputs[0]
        int_out = all(self._tensor_is_int(t) for t in in_ts)

        def run(env: Env) -> None:
            xs = [self._get(env, t, as_int=True) if int_out
                  else self._getf(env, t) for t in in_ts]
            env[out] = torch.cat(xs, dim=ax)
        self.is_int[out] = int_out
        self._push(run)
        self.plan.append(LoweredOp(node.name, "Concat", "torch"))


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------

class CompiledSiraModel:
    """A kernel-backed executable for an optimized SiraModel.

    Call with a feed dict (like ``Graph.execute``); returns numpy arrays
    for the graph outputs (plus any ``extra_outputs`` requested at lower
    time).  The steps run eagerly on ``device``.
    """

    def __init__(self, name: str, steps, plan, outputs, int_tensors,
                 dtype, device: torch.device,
                 step_labels: Optional[Sequence[str]] = None):
        # only the name — holding the SiraModel would pin its graph and
        # cached range arrays (and create a cycle via metadata['compiled'])
        self.name = name
        self.plan: List[LoweredOp] = plan
        self.outputs: List[str] = list(outputs)
        self.int_tensors: List[str] = list(int_tensors)
        self.dtype = dtype
        self.device = device
        self._steps = steps
        self.step_labels: List[str] = list(
            step_labels if step_labels is not None
            else (f"step{i}" for i in range(len(steps))))

    def _env(self, feeds: Dict[str, Any]) -> Env:
        # upload as given, cast on the device
        return {k: torch.tensor(np.asarray(v), device=self.device)
                .to(self.dtype) for k, v in feeds.items()}

    def _forward(self, feeds: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            env = self._env(feeds)
            for run in self._steps:
                run(env)
            return {t: env[t] for t in self.outputs}

    def __call__(self, feeds: Dict[str, Any]) -> Dict[str, np.ndarray]:
        tr = get_tracer()
        if tr.enabled:
            with tr.span("compiled:call", model=self.name):
                out = self._forward(feeds)
                return {k: v.cpu().numpy() for k, v in out.items()}
        out = self._forward(feeds)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def profile(self, feeds: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Per-kernel dispatch timing: one span per lowered step, waiting
        for the device after each so span durations reflect device time.
        Slower than ``__call__`` by construction — a diagnostics path,
        never the serving path."""
        tr = get_tracer()
        on_card = self.device.type == "cuda"
        with torch.no_grad():
            env = self._env(feeds)
            with tr.span("compiled:profile", model=self.name,
                         kernels=len(self._steps)):
                for label, run in zip(self.step_labels, self._steps):
                    with tr.span(f"kernel:{label}"):
                        run(env)
                        if on_card:
                            torch.cuda.synchronize(self.device)
        return {t: env[t].cpu().numpy() for t in self.outputs}

    @property
    def kernel_calls(self) -> Dict[str, int]:
        """Plan summary: how many nodes hit each lowering route."""
        counts: Dict[str, int] = {}
        for op in self.plan:
            counts[op.kind] = counts.get(op.kind, 0) + 1
        return counts

    def __repr__(self) -> str:   # pragma: no cover - debug aid
        return (f"CompiledSiraModel({self.name or 'unnamed'}, "
                f"{len(self.plan)} ops, {self.kernel_calls}, "
                f"{self.device})")


def lower(model: SiraModel, *, device=None, dtype=torch.float32,
          use_kernel: Optional[bool] = None,
          fuse_epilogue: Optional[bool] = None,
          extra_outputs: Sequence[str] = ()) -> CompiledSiraModel:
    """Lower an optimized model to an eager step list on ``device``.

    device: where the model runs; None → ``"cuda"``.  Raises
        ``RuntimeError`` when a card is asked for and none is present.
    dtype: float compute dtype — ``torch.float32`` (default) or
        ``torch.float64`` (the exact mode).
    use_kernel: None → the CUDA kernels on a card, their plain PyTorch
        versions on the CPU; True demands the kernels (raises on the CPU);
        False runs the plain versions on whichever device.
    fuse_epilogue: fuse MatMul/Conv→Mul→Add chains into the int_matmul
        scale/bias epilogue.  Default: only in float32 mode (the kernel
        epilogue computes in f32, which would break float64 exactness).
    extra_outputs: additional tensor names to return on every call
        (e.g. integer intermediates for bit-exactness checks).
    """
    dev = resolve_device(device)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be torch.float32 or torch.float64, "
                        f"got {dtype}")
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    elif use_kernel and dev.type not in ("cuda", "meta"):
        # meta: a model counted without a card (roofline/op_cost.py)
        raise RuntimeError(
            f"use_kernel=True needs a CUDA device, got device={str(dev)!r}")
    if fuse_epilogue is None:
        fuse_epilogue = dtype == torch.float32
    with get_tracer().span("compile:lower", model=model.name,
                           nodes=len(model.graph.nodes),
                           dtype=str(dtype), device=str(dev)) as sp:
        lw = _Lowerer(model, device=dev, use_kernel=bool(use_kernel),
                      dtype=dtype, fuse_epilogue=fuse_epilogue)
        with get_tracer().span("compile:build_plan"):
            lw.build()
        sp.set_attr("plan_ops", len(lw.plan))
        outputs = list(model.graph.outputs)
        for t in extra_outputs:
            if t not in lw.consts and t not in lw.is_int:
                raise LoweringError(
                    f"extra output {t!r} is not materialized by the "
                    f"lowered program (unknown tensor, or eliminated by "
                    f"epilogue fusion — retry with fuse_epilogue=False)")
            if t not in outputs:
                outputs.append(t)
        # constant outputs (fully folded graphs) are materialized up front
        const_outs = {t for t in outputs if t in lw.consts}
        labels = list(lw.step_labels)
        if const_outs:
            consts = {t: torch.tensor(np.asarray(lw.consts[t]), device=dev)
                      for t in const_outs}

            def emit_consts(env: Env) -> None:
                env.update(consts)
            steps = [emit_consts] + list(lw.steps)
            labels = ["consts"] + labels
        else:
            steps = lw.steps
        int_tensors = [t for t, flag in lw.is_int.items() if flag]
        return CompiledSiraModel(model.name, steps, lw.plan, outputs,
                                 int_tensors, dtype, dev,
                                 step_labels=labels)


class CompileBackend(Transformation):
    """Build-flow step (``step_compile``): lower the current model and
    stash the executable under ``metadata['compiled']``.  Never modifies
    the graph."""

    def __init__(self, device=None, dtype=torch.float32,
                 use_kernel: Optional[bool] = None,
                 fuse_epilogue: Optional[bool] = None):
        self.kwargs = dict(device=device, dtype=dtype,
                           use_kernel=use_kernel,
                           fuse_epilogue=fuse_epilogue)

    @property
    def name(self) -> str:
        return "step_compile"

    def apply(self, model: SiraModel):
        model.metadata["compiled"] = lower(model, **self.kwargs)
        return model, False
