"""A2Q-style accumulator-budget constraints for QAT (PAPERS.md: A2Q,
A2Q+): train weights that *provably* fit a chosen accumulator width.

Setting
-------
A dot-product layer accumulates ``z[j] = sum_k q[k, j] * x[k]`` with
integer inputs ``x`` and per-output-channel integer weights
``q = toz(W / s)`` (round-toward-zero, frozen per-channel scale ``s``).
``z`` fits ``P`` signed bits iff (core.intervals
``required_signed_bits``)

    z_hi <= 2^(P-1) - 1   and   -z_lo <= 2^(P-1).

Unsigned N-bit inputs, ``x in [0, M]`` with ``M = 2^N - 1``:

    z_hi = M * sum(q+),   z_lo = -M * sum(q-),

so the budget is a pair of L1-type bounds on the weight column masses:

    sum(q+) <= (2^(P-1) - 1) / M,     sum(q-) <= 2^(P-1) / M.

* **A2Q** (``zero_center=False``) uses the symmetric tight side:
  ``||q||_1 <= (2^(P-1) - 1) / M``.
* **A2Q+** (``zero_center=True``) zero-centers ``v = W/s`` per channel
  and constrains the positive and negative masses *separately* —
  roughly twice the feasible mass for the same budget.

Signed N-bit inputs (``|x| <= M = 2^(N-1)``): either input sign can
flip every product, so both bounds collapse to ``M * ||q||_1`` and only
the symmetric form applies (zero-centering then still conditions the
weights but buys no extra mass).

The guarantee survives quantization because round-toward-zero gives
``|q_k| <= |v_k|`` element-wise (``QuantSpec(rounding="toward_zero")``)
and clipping to ``qmax`` only shrinks magnitudes — so any bound proved
on ``v = W/s`` transfers to ``q``.  It is enforced as (a) a
differentiable L1 hinge penalty inside the loss and (b) a hard
Euclidean projection applied to the optimizer's master weights after
every step (``AdamW(project=...)``), and it is validated against
``repro_torch.core.accumulator`` (``exact_worst_case_bits`` /
``channel_worst_case_bits``) as the oracle — including a seeded
"lying projector" mode the fuzzer must catch, mirroring
``repro_torch.core.fuzz``.

Counterpart of ``src/repro/qat/constraints.py``: the projection and the
penalty on tensors (autograd gives the penalty's gradient); the
quantizer, the adversarial inputs and the oracle stay float64 numpy, as
the proofs need.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.accumulator import channel_worst_case_bits, exact_worst_case_bits
from ..quant.quantizer import QuantSpec


@dataclasses.dataclass(frozen=True)
class AccumulatorBudget:
    """Per-layer accumulator-budget: prove ``<= bits`` signed bits for a
    dot product over ``input_bits``-bit integer inputs."""
    bits: int                      # target accumulator width P (signed)
    input_bits: int = 8            # N: width of the dynamic input
    input_signed: bool = False
    zero_center: bool = False      # A2Q+ asymmetric variant

    def __post_init__(self) -> None:
        if self.bits < 2:
            raise ValueError(f"accumulator budget needs bits >= 2, "
                             f"got {self.bits}")

    @property
    def input_mag(self) -> int:
        """Worst-case |x| of the integer input."""
        if self.input_signed:
            return 2 ** (self.input_bits - 1)
        return 2 ** self.input_bits - 1

    def input_range(self) -> Tuple[int, int]:
        """Integer input range (x_lo, x_hi) the budget defends against."""
        if self.input_signed:
            return -(2 ** (self.input_bits - 1)), \
                2 ** (self.input_bits - 1) - 1
        return 0, 2 ** self.input_bits - 1

    def caps(self) -> Tuple[float, float]:
        """(cap_pos, cap_neg) L1 limits on the integer-weight column
        masses.  ``cap_neg < 0`` signals the symmetric regime (bound
        ``||q||_1 <= cap_pos`` instead of separate masses)."""
        cap_pos = (2.0 ** (self.bits - 1) - 1.0) / self.input_mag
        if self.zero_center and not self.input_signed:
            return cap_pos, (2.0 ** (self.bits - 1)) / self.input_mag
        return cap_pos, -1.0


def _project_l1_nonneg(u: torch.Tensor, radius: float) -> torch.Tensor:
    """Euclidean projection of each *column* of the non-negative matrix
    ``u`` (K, M) onto ``{y >= 0 : sum(y) <= radius}`` (Duchi et al.
    sort-and-threshold; no data-dependent shapes)."""
    K = u.shape[0]
    s = torch.sort(u, dim=0, descending=True).values
    css = torch.cumsum(s, dim=0)
    k = torch.arange(1, K + 1, dtype=u.dtype, device=u.device)[:, None]
    theta_k = (css - radius) / k
    rho = torch.clamp(torch.sum(s > theta_k, dim=0), min=1)
    theta = torch.gather(theta_k, 0, (rho - 1)[None, :])[0]
    # feasible columns have theta <= 0: clamp so they project to themselves
    theta = torch.clamp(theta, min=0.0)
    return torch.clamp(u - theta[None, :], min=0.0)


def _int_domain(W: torch.Tensor, scale
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    s = torch.as_tensor(scale, dtype=W.dtype, device=W.device)
    if s.dim() == 1:
        s = s[None, :]
    return W / s, s


def project_weights(W: torch.Tensor, scale,
                    budget: AccumulatorBudget) -> torch.Tensor:
    """Hard Euclidean projection of a (K, M) weight matrix onto the
    budget's constraint set, in integer units ``v = W / scale``
    (``scale``: per-output-channel, broadcastable to (1, M)).

    Symmetric regime: project ``|v|`` columns onto the L1 ball (signs
    kept) — the exact Euclidean projection onto ``||v||_1 <= cap``.
    A2Q+ regime: zero-center each column (reparameterization, as in
    A2Q+), then project the positive and negative parts onto their own
    simplex caps; the parts live on disjoint coordinates, so this is
    the exact projection onto the pair constraint."""
    v, s = _int_domain(W, scale)
    cap_pos, cap_neg = budget.caps()
    if cap_neg >= 0.0:
        v = v - torch.mean(v, dim=0, keepdim=True)
        pos = _project_l1_nonneg(torch.clamp(v, min=0.0), cap_pos)
        neg = _project_l1_nonneg(torch.clamp(-v, min=0.0), cap_neg)
        v = pos - neg
    else:
        mag = _project_l1_nonneg(torch.abs(v), cap_pos)
        v = torch.sign(v) * mag
    return v * s


def budget_penalty(W: torch.Tensor, scale,
                   budget: AccumulatorBudget) -> torch.Tensor:
    """Differentiable L1-norm hinge penalty: mean squared excess of the
    per-channel integer-domain column masses over the budget caps.
    Zero on the feasible set, so it never fights the projection."""
    v, _ = _int_domain(W, scale)
    cap_pos, cap_neg = budget.caps()
    if cap_neg >= 0.0:
        v = v - torch.mean(v, dim=0, keepdim=True)
        e_pos = torch.clamp(
            torch.sum(torch.clamp(v, min=0.0), dim=0) - cap_pos, min=0.0)
        e_neg = torch.clamp(
            torch.sum(torch.clamp(-v, min=0.0), dim=0) - cap_neg, min=0.0)
        return torch.mean(e_pos ** 2 + e_neg ** 2)
    excess = torch.clamp(torch.sum(torch.abs(v), dim=0) - cap_pos, min=0.0)
    return torch.mean(excess ** 2)


def weight_quant_spec(weight_bits: int) -> QuantSpec:
    """The toz weight quantizer every constrained layer must use (the
    |q| <= |v| property is what transfers the L1 bound to integers)."""
    return QuantSpec(bits=weight_bits, signed=True,
                     granularity="per_channel", channel_axis=-1,
                     rounding="toward_zero")


def _f64(x) -> np.ndarray:
    """A tensor (any device) or array as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


def quantize_weights(W, scale, weight_bits: int) -> np.ndarray:
    """(K, M) float weights -> integer q, the float64 numpy reference of
    the toz quantizer (``quantize_int`` with rounding="toward_zero") —
    used by export and the fuzzer so proofs run at full precision."""
    spec = weight_quant_spec(weight_bits)
    s = _f64(scale)
    if s.ndim == 1:
        s = s[None, :]
    q = np.trunc(_f64(W) / s)
    return np.clip(q, spec.qmin, spec.qmax)


def worst_case_inputs(q: np.ndarray, budget: AccumulatorBudget,
                      maximize: bool = True) -> np.ndarray:
    """The adversarial integer input per output channel: X (K, M) where
    column j maximizes (or minimizes) channel j's accumulator
    ``sum_k q[k, j] * X[k, j]``."""
    x_lo, x_hi = budget.input_range()
    if maximize:
        return np.where(np.asarray(q) > 0, x_hi, x_lo).astype(np.float64)
    return np.where(np.asarray(q) > 0, x_lo, x_hi).astype(np.float64)


def channel_bits(q: np.ndarray, budget: AccumulatorBudget) -> np.ndarray:
    """Exact per-channel worst-case accumulator bits of integer weights
    ``q`` under the budget's input range (the core oracle)."""
    return channel_worst_case_bits(np.asarray(q), *budget.input_range())


# --------------------------------------------------------------------------
# guarantee fuzzer (mirrors core.fuzz: honest run must be clean,
# seeded lying variants must be caught)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ProjectionFuzzReport:
    cases: int
    channels_checked: int
    violations: List[str]
    oracle_mismatches: List[str]

    @property
    def clean(self) -> bool:
        return not self.violations and not self.oracle_mismatches

    def summary(self) -> str:
        return (f"{self.cases} cases / {self.channels_checked} channels: "
                f"{len(self.violations)} budget violations, "
                f"{len(self.oracle_mismatches)} oracle mismatches")


def fuzz_projection(n_cases: int = 40, seed: int = 0,
                    lie: Optional[str] = None) -> ProjectionFuzzReport:
    """Differential fuzz of the A2Q guarantee: random layers -> project
    -> toz-quantize -> the exact worst case (both the closed-form oracle
    and a concrete adversarial input) must fit the budget.

    ``lie`` injects a deliberately unsound projector that a sound
    checker must flag (mirroring core.fuzz's lying certifier):
      * ``"loose"`` — projects against a 2-bit-looser budget;
      * ``"skip"``  — does not project at all.
    """
    if lie not in (None, "loose", "skip"):
        raise ValueError(f"unknown lie mode {lie!r}")
    rng = np.random.default_rng(seed)
    violations: List[str] = []
    mismatches: List[str] = []
    channels = 0
    for case in range(n_cases):
        K = int(rng.integers(4, 48))
        M = int(rng.integers(2, 12))
        wbits = int(rng.integers(3, 9))
        budget = AccumulatorBudget(
            bits=int(rng.integers(6, 15)),
            input_bits=int(rng.integers(2, 9)),
            input_signed=bool(rng.integers(2)),
            zero_center=bool(rng.integers(2)))
        W = rng.normal(size=(K, M)) * rng.uniform(0.5, 3.0)
        scale = np.maximum(
            np.abs(W).max(axis=0) / (2 ** (wbits - 1) - 1), 1e-8)
        if lie == "skip":
            Wp = W
        else:
            target = budget if lie is None else dataclasses.replace(
                budget, bits=budget.bits + 2)
            # float32, as the reference projects (jnp.asarray drops to
            # float32 outside x64 mode)
            Wp = project_weights(
                torch.as_tensor(W, dtype=torch.float32),
                torch.as_tensor(scale, dtype=torch.float32),
                target).numpy()
        q = quantize_weights(Wp, scale, wbits)
        bits = channel_bits(q, budget)
        channels += M
        # the per-channel oracle must be consistent with the scalar
        # range oracle and with a concrete adversarial execution
        x_lo, x_hi = budget.input_range()
        scalar = exact_worst_case_bits(K, x_lo, x_hi,
                                       int(q.min()), int(q.max()))
        if np.any(bits > scalar):
            mismatches.append(
                f"case {case}: channel bits {bits.max()} exceed scalar "
                f"oracle {scalar}")
        z_hi = (q * worst_case_inputs(q, budget, True)).sum(axis=0)
        z_lo = (q * worst_case_inputs(q, budget, False)).sum(axis=0)
        m = np.maximum(np.abs(z_lo), np.abs(z_hi) + 1.0)
        concrete = np.ceil(np.log2(np.maximum(m, 2.0))) + 1
        if np.any(concrete != bits):
            # the adversarial input achieves the oracle's extremes, so
            # the concrete bit count must match exactly
            mismatches.append(
                f"case {case}: concrete worst case disagrees with "
                f"channel_worst_case_bits")
        if np.any(bits > budget.bits):
            violations.append(
                f"case {case}: K={K} M={M} w{wbits} "
                f"N={budget.input_bits}{'s' if budget.input_signed else 'u'}"
                f"{' zc' if budget.zero_center else ''} budget "
                f"{budget.bits} -> proven {int(bits.max())} bits"
                + (f" (lie={lie})" if lie else ""))
    return ProjectionFuzzReport(cases=n_cases, channels_checked=channels,
                                violations=violations,
                                oracle_mismatches=mismatches)
