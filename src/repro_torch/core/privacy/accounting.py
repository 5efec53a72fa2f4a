"""Differential-privacy accounting for the wire codecs.

The port's own copy of the JAX package's ``repro/core/privacy/accounting.py``
(pure Python, the same functions and the same arithmetic), since the port
imports nothing of that package:

  * :func:`gaussian_sigma` / :func:`gaussian_epsilon` — the classic
    Gaussian-mechanism calibration (Dwork & Roth, Thm A.1):
    ``sigma = sensitivity * sqrt(2 ln(1.25/delta)) / epsilon``;
  * :func:`basic_composition` / :func:`advanced_composition` — per-step
    epsilon composed across ``steps`` uses (Dwork & Roth, Thm 3.20 for
    the advanced bound);
  * :func:`amplified_epsilon` — privacy amplification by Poisson
    subsampling at rate ``q``: ``ln(1 + q (e^eps - 1))``;
  * :func:`compose_training` — per-use epsilon -> end-of-training
    (epsilon, delta) under both composition bounds, with optional
    subsampling amplification;
  * :class:`PrivacyAccountant` — a running ledger for heterogeneous
    spends (different leaves / phases with different per-use budgets).

Sensitivity convention: codecs operate on *normalized* tensors (values
in [-1, 1] after the shared pmax scale), so the default per-use L2
sensitivity is 2.0 — the "unit-clipped update" convention. Quoted
epsilons are per *transmitted message* under that bound; rescale
``sensitivity`` for a different clipping norm.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "gaussian_sigma",
    "gaussian_epsilon",
    "basic_composition",
    "advanced_composition",
    "amplified_epsilon",
    "compose_training",
    "TrainingBudget",
    "PrivacyAccountant",
    "DEFAULT_SENSITIVITY",
]

# normalized tensors live in [-1, 1]: replacing one record moves the
# (unit-clipped) update by at most 2 in L2
DEFAULT_SENSITIVITY = 2.0


def _check_delta(delta: float) -> None:
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta must be in (0, 1), got {delta}")


def gaussian_sigma(
    epsilon: float, delta: float, sensitivity: float = DEFAULT_SENSITIVITY
) -> float:
    """Noise std for the Gaussian mechanism at (epsilon, delta).

    ``sigma = sensitivity * sqrt(2 ln(1.25/delta)) / epsilon``. The classic
    bound is stated for epsilon <= 1; for larger per-use epsilon it remains
    the standard (conservative) calibration and is what we quote.
    """
    _check_delta(delta)
    if epsilon <= 0:
        raise ValueError(f"epsilon must be > 0, got {epsilon}")
    if sensitivity <= 0:
        raise ValueError(f"sensitivity must be > 0, got {sensitivity}")
    return sensitivity * math.sqrt(2.0 * math.log(1.25 / delta)) / epsilon


def gaussian_epsilon(
    sigma: float, delta: float, sensitivity: float = DEFAULT_SENSITIVITY
) -> float:
    """Inverse of :func:`gaussian_sigma`: epsilon achieved by noise std
    ``sigma``. Returns ``inf`` for sigma == 0 (no noise, no guarantee)."""
    _check_delta(delta)
    if sigma < 0:
        raise ValueError(f"sigma must be >= 0, got {sigma}")
    if sigma == 0.0:
        return math.inf
    return sensitivity * math.sqrt(2.0 * math.log(1.25 / delta)) / sigma


def basic_composition(epsilon: float, steps: int) -> float:
    """Sequential composition: ``steps`` uses of an epsilon-mechanism."""
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    return float(steps) * epsilon


def advanced_composition(epsilon: float, steps: int, delta_slack: float) -> float:
    """Advanced composition (Dwork & Roth, Thm 3.20): total epsilon of
    ``steps`` uses at per-use ``epsilon``, spending an extra additive
    ``delta_slack`` in delta:

        sqrt(2 steps ln(1/delta_slack)) * eps + steps * eps * (e^eps - 1)
    """
    _check_delta(delta_slack)
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if steps == 0 or epsilon == 0.0:
        return 0.0
    if math.isinf(epsilon):
        return math.inf
    root = math.sqrt(2.0 * steps * math.log(1.0 / delta_slack))
    return root * epsilon + steps * epsilon * math.expm1(epsilon)


def amplified_epsilon(epsilon: float, sampling_rate: float) -> float:
    """Privacy amplification by Poisson subsampling at rate ``q``:
    ``eps_q = ln(1 + q (e^eps - 1))`` (delta scales by q at the caller)."""
    if not 0.0 < sampling_rate <= 1.0:
        raise ValueError(f"sampling_rate must be in (0, 1], got {sampling_rate}")
    if sampling_rate == 1.0 or math.isinf(epsilon):
        return epsilon
    return math.log1p(sampling_rate * math.expm1(epsilon))


@dataclasses.dataclass(frozen=True)
class TrainingBudget:
    """End-of-training privacy ledger (see :func:`compose_training`)."""

    epsilon_per_use: float
    epsilon_per_step: float  # after subsampling amplification
    epsilon_basic: float
    epsilon_advanced: float
    delta_total: float
    steps: int
    sampling_rate: float

    @property
    def epsilon(self) -> float:
        """The tighter of the two composition bounds."""
        return min(self.epsilon_basic, self.epsilon_advanced)


def compose_training(
    epsilon_per_use: float,
    steps: int,
    *,
    delta: float = 1e-5,
    sampling_rate: float = 1.0,
    delta_slack: float | None = None,
) -> TrainingBudget:
    """Compose a per-use epsilon across a training run.

    Each step spends ``epsilon_per_use`` (already summed over leaves /
    phases if several mechanisms fire per step), amplified by Poisson
    subsampling at ``sampling_rate``; the total is reported under both
    basic and advanced composition. ``delta_total`` accounts for the
    per-use delta at every step plus the advanced-composition slack
    (``delta_slack`` defaults to ``delta``).
    """
    if delta_slack is None:
        delta_slack = delta
    _check_delta(delta)
    step_eps = amplified_epsilon(epsilon_per_use, sampling_rate)
    step_delta = sampling_rate * delta
    return TrainingBudget(
        epsilon_per_use=epsilon_per_use,
        epsilon_per_step=step_eps,
        epsilon_basic=basic_composition(step_eps, steps),
        epsilon_advanced=advanced_composition(step_eps, steps, delta_slack),
        delta_total=steps * step_delta + delta_slack,
        steps=steps,
        sampling_rate=sampling_rate,
    )


@dataclasses.dataclass
class PrivacyAccountant:
    """Running ledger for heterogeneous spends.

    ``spend(eps, times)`` records ``times`` uses of an eps-mechanism (all
    at the accountant's ``delta``); totals are available under basic and
    advanced composition. One deterministic (eps = inf) spend poisons the
    ledger — a fully-revealed message has no DP guarantee to compose.
    """

    delta: float = 1e-5
    _events: list[tuple[float, int]] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        _check_delta(self.delta)

    def spend(self, epsilon: float, times: int = 1) -> None:
        if epsilon < 0:
            raise ValueError(f"epsilon must be >= 0, got {epsilon}")
        if times < 0:
            raise ValueError(f"times must be >= 0, got {times}")
        if times:
            self._events.append((epsilon, times))

    @property
    def n_uses(self) -> int:
        return sum(t for _, t in self._events)

    def total_basic(self) -> float:
        return sum(e * t for e, t in self._events)

    def total_advanced(self, delta_slack: float | None = None) -> float:
        """Advanced composition over the ledger. Heterogeneous spends use
        the worst per-use epsilon across all events (a valid upper bound);
        returns the tighter of that and basic composition."""
        if not self._events:
            return 0.0
        if delta_slack is None:
            delta_slack = self.delta
        worst = max(e for e, _ in self._events)
        adv = advanced_composition(worst, self.n_uses, delta_slack)
        return min(adv, self.total_basic())

    def total_delta(self, delta_slack: float | None = None) -> float:
        if delta_slack is None:
            delta_slack = self.delta
        return self.n_uses * self.delta + delta_slack
