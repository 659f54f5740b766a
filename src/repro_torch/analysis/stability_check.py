"""Collapse sentinel: the paper's Theorem 4.2 as a runnable assertion.

Theorem 4.2 (PAPER.md, App. A eq. 23): the forward moment contributed by
an aggregated LoRA update scales as ``gamma^2 * r / N``.  Only the
SFed-LoRA factor ``gamma = alpha * sqrt(N / r)`` makes that scale equal
``alpha^2`` independently of client count and rank — vanilla
``alpha / r`` collapses the adapter signal at high rank (the moment
shrinks like ``1/r``), and rsLoRA-style ``alpha / sqrt(r)`` explodes it
with N.

This module checks both halves at runtime:

* the *config* half — :func:`predicted_scale` evaluates the theorem for
  the run's ``(gamma, r, N, alpha)`` and flags a mis-scaled setup before
  a single round runs;
* the *measured* half — :func:`stability_report` takes the per-round
  aggregated update norms from the federated engine's metrics path and
  flags geometric drift (explosion/vanishing) across rounds, plus — when
  a reference run is supplied — deviation of the measured level ratio
  from the theorem's ``(gamma_a / gamma_b)^2 * (r_a N_b) / (r_b N_a)``
  prediction.

The port of ``repro/analysis/stability_check.py``, which imports no jax;
the port keeps its own copy.  Inputs are any float-convertible sequence:
engine history dicts, benchmark JSON, or test fixtures.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.scaling import predicted_moment_scale


class ScalingCollapseError(AssertionError):
    """The run violates the Theorem 4.2 stabilized-moment prediction."""


def predicted_scale(gamma: float, r: int, n_clients: int, alpha: float) -> float:
    """Theorem 4.2 moment scale, normalized by ``alpha^2`` — equals 1.0
    exactly when ``gamma`` is the SFed-LoRA factor ``alpha*sqrt(N/r)``."""
    return predicted_moment_scale(gamma, r, n_clients) / (alpha * alpha)


@dataclass
class StabilityReport:
    ok: bool
    verdict: str  # "stabilized" | "collapse" | "explosion" | "drift"
    predicted: float  # normalized Thm 4.2 scale (1.0 == SFed-LoRA)
    trend: float  # total measured drift norms[-1]/norms[0]
    norms: list[float] = field(default_factory=list)
    messages: list[str] = field(default_factory=list)

    def __str__(self) -> str:
        status = "OK" if self.ok else "FAIL"
        body = "; ".join(self.messages) or "within tolerance"
        return (
            f"[{status}:{self.verdict}] Thm4.2 scale={self.predicted:.4g} "
            f"(1.0=SFed-LoRA), measured drift x{self.trend:.4g} over "
            f"{len(self.norms)} rounds: {body}"
        )


def _as_floats(norms) -> list[float]:
    out = [float(v) for v in norms]
    if len(out) < 2:
        raise ValueError(
            "stability_report needs >= 2 per-round update norms to measure a trend"
        )
    return out


def stability_report(
    update_norms,
    *,
    gamma: float,
    r: int,
    n_clients: int,
    alpha: float,
    scale_tol: float = 4.0,
    trend_tol: float = 8.0,
    reference: tuple | None = None,
) -> StabilityReport:
    """Judge a federated run against Theorem 4.2.

    ``update_norms``: per-round aggregated adapter update norms (the
    engine's ``update_norm`` metric).  ``reference``: optional
    ``(ref_norms, ref_gamma)`` or ``(ref_norms, ref_gamma, ref_r,
    ref_n)`` from a second run; the measured level ratio between the runs
    must match the theorem's predicted ratio within ``scale_tol``.
    """
    norms = _as_floats(update_norms)
    pred = predicted_scale(gamma, r, n_clients, alpha)
    messages: list[str] = []
    verdict = "stabilized"

    # -- config half: the scale the theorem assigns this (gamma, r, N) ----
    if pred < 1.0 / scale_tol:
        verdict = "collapse"
        messages.append(
            f"gamma={gamma:.4g} predicts moment scale {pred:.4g}*alpha^2 "
            f"(Thm 4.2: gamma^2*r/N) — adapter signal vanishes at r={r}, "
            f"N={n_clients}; use gamma=alpha*sqrt(N/r)="
            f"{alpha * math.sqrt(n_clients / r):.4g}"
        )
    elif pred > scale_tol:
        verdict = "explosion"
        messages.append(
            f"gamma={gamma:.4g} predicts moment scale {pred:.4g}*alpha^2 "
            f"(Thm 4.2: gamma^2*r/N) — activations blow up with N={n_clients}, "
            f"r={r}; use gamma=alpha*sqrt(N/r)"
        )

    # -- measured half: geometric drift across rounds ---------------------
    floor = 1e-30
    trend = norms[-1] / max(norms[0], floor)
    if trend > trend_tol:
        verdict = "explosion" if verdict == "stabilized" else verdict
        messages.append(
            f"measured update norms grew x{trend:.3g} over {len(norms)} "
            "rounds (stabilized aggregation keeps them flat)"
        )
    elif trend < 1.0 / trend_tol:
        verdict = "collapse" if verdict == "stabilized" else verdict
        messages.append(
            f"measured update norms decayed x{trend:.3g} over {len(norms)} "
            "rounds — the adapter is going silent"
        )

    # -- cross-run level check vs the theorem's predicted ratio -----------
    if reference is not None:
        ref_norms = _as_floats(reference[0])
        ref_gamma = float(reference[1])
        ref_r = int(reference[2]) if len(reference) > 2 else r
        ref_n = int(reference[3]) if len(reference) > 3 else n_clients
        measured_ratio = (sum(norms) / len(norms)) / max(
            sum(ref_norms) / len(ref_norms), floor
        )
        predicted_ratio = predicted_moment_scale(gamma, r, n_clients) / max(
            predicted_moment_scale(ref_gamma, ref_r, ref_n), floor
        )
        deviation = measured_ratio / max(predicted_ratio, floor)
        if not (1.0 / scale_tol <= deviation <= scale_tol):
            verdict = "drift" if verdict == "stabilized" else verdict
            messages.append(
                f"measured level ratio {measured_ratio:.3g} vs reference "
                f"deviates x{deviation:.3g} from the Thm 4.2 prediction "
                f"{predicted_ratio:.3g} — the aggregation path is not "
                "following gamma^2*r/N"
            )

    ok = verdict == "stabilized"
    return StabilityReport(
        ok=ok, verdict=verdict, predicted=pred, trend=trend, norms=norms,
        messages=messages,
    )


def assert_stabilized(update_norms, **kwargs) -> StabilityReport:
    """``stability_report`` that raises :class:`ScalingCollapseError` on
    failure — the form tests and the engine's metrics path use."""
    rep = stability_report(update_norms, **kwargs)
    if not rep.ok:
        raise ScalingCollapseError(str(rep))
    return rep


def recovery_action(report: StabilityReport, *,
                    scale_tol: float = 4.0) -> str:
    """Classify what a watchdog retry should change after a failed verdict.

    ``"rescale"``: the CONFIG half of Theorem 4.2 is violated — the run's
    gamma itself predicts a collapsed/exploded moment scale, which no
    participation backoff or fault reseed can fix (it is deterministic in
    (gamma, r, N)).  The paper's own remedy applies: adopt
    gamma = alpha*sqrt(N/r).

    ``"backoff"``: the config is sound but the MEASURED norms drifted —
    plausibly corrupt/stale uploads slipping through; retry with reduced
    participation and a fresh fault draw.
    """
    if not (1.0 / scale_tol <= report.predicted <= scale_tol):
        return "rescale"
    return "backoff"


def scaling_flatness(moments, tol: float = 4.0) -> tuple[bool, float]:
    """Theorem 4.2 invariance check over a sweep: SFed-LoRA keeps the
    aggregated forward moment flat across ``(N, r)`` configurations.
    ``moments`` is a mapping ``{(n, r): moment}`` or a sequence; returns
    ``(flat, max/min ratio)``."""
    values = [
        float(v) for v in (moments.values() if hasattr(moments, "values") else moments)
    ]
    if not values:
        raise ValueError("scaling_flatness needs at least one moment")
    lo, hi = min(values), max(values)
    ratio = hi / max(lo, 1e-30)
    return ratio <= tol, ratio
