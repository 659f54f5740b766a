"""LoRA scaling factors — the paper's central object.

gamma multiplies the adapter product BA in  h = W0 x + gamma * B A x.

  lora      gamma = alpha / r            (Hu et al., 2022)
  rslora    gamma = alpha / sqrt(r)      (Kalajdzievski, 2023)
  sfedlora  gamma = alpha * sqrt(N / r)  (this paper, Theorem 4.2)
  za        gamma = 1 / (sqrt(N)*sqrt(r))  (paper App. B.3 — too small)
  zb        gamma = N^2 / sqrt(r)          (paper App. B.3 — too large)

The paper's derivation (App. A): with FedSA split aggregation the effective
adapter magnitude carries E[A_bar^T A_bar] = (r/N) sigma_A^2 I, so moments
scale as (gamma^2 * r / N)^h — Theta(1) iff gamma ~ sqrt(N/r).
"""
from __future__ import annotations

import math


def gamma_lora(alpha: float, r: int, n_clients: int = 1) -> float:
    return alpha / r


def gamma_rslora(alpha: float, r: int, n_clients: int = 1) -> float:
    return alpha / math.sqrt(r)


def gamma_sfedlora(alpha: float, r: int, n_clients: int) -> float:
    return alpha * math.sqrt(n_clients / r)


def gamma_za(alpha: float, r: int, n_clients: int) -> float:
    # paper defines this candidate without alpha (eq. 24); keep it literal
    return 1.0 / (math.sqrt(n_clients) * math.sqrt(r))


def gamma_zb(alpha: float, r: int, n_clients: int) -> float:
    # eq. 25
    return n_clients ** 2 / math.sqrt(r)


SCALINGS = {
    "lora": gamma_lora,
    "rslora": gamma_rslora,
    "sfedlora": gamma_sfedlora,
    "za": gamma_za,
    "zb": gamma_zb,
}


def scaling_factor(name: str, alpha: float, r: int, n_clients: int) -> float:
    """The adapter scale gamma for a given scheme.

    ``r`` and ``n_clients`` must be >= 1: every scheme divides by r or
    sqrt(r), and sqrt(N/r) of a non-positive client count is meaningless
    (gamma would silently come out 0, inf, or nan and poison the run).
    """
    if r < 1:
        raise ValueError(
            f"scaling_factor needs rank r >= 1, got r={r} (every gamma "
            "scheme divides by r or sqrt(r))")
    if n_clients < 1:
        raise ValueError(
            f"scaling_factor needs n_clients >= 1, got n_clients="
            f"{n_clients} (gamma = alpha*sqrt(N/r) degenerates at N <= 0)")
    try:
        return SCALINGS[name](alpha, r, n_clients)
    except KeyError:
        raise ValueError(f"unknown scaling '{name}'; options {list(SCALINGS)}")


def per_client_gammas(name: str, alpha: float, ranks, n_clients: int):
    """Per-client scaling factors for heterogeneous ranks.

    With per-client ranks r_i the paper's Theorem 4.2 scaling becomes
    gamma_i = alpha * sqrt(N / r_i): N is still the federation size (the
    aggregation averages over all N clients), while the rank in the
    denominator is the client's own adapter rank.  Uniform ranks collapse
    to the homogeneous scaling_factor for every scheme.
    """
    return tuple(scaling_factor(name, alpha, int(r), n_clients)
                 for r in ranks)


def staleness_corrected_gamma(gamma: float, n_eff, n_clients: int):
    """gamma_eff for a round that effectively aggregated ``n_eff`` fresh
    clients (buffered/async aggregation: rejected, dropped, and
    staleness-discounted uploads all shrink N_eff below N).

    Theorem 4.2's moment scale is gamma^2 * r / N for a mean over N
    clients; with the weighted buffered mean the variance reduction goes
    as 1/N_eff instead, so the stabilizing factor is
    gamma_eff = alpha * sqrt(N_eff / r) = gamma * sqrt(N_eff / N).
    Works on floats and traced arrays; degrades to exactly ``gamma`` at
    N_eff = N (the staleness-0 bit-identity guarantee relies on the
    engine's on-device form of this being 1.0 exactly there).
    """
    if n_clients < 1:
        raise ValueError(
            f"staleness_corrected_gamma needs n_clients >= 1, got "
            f"{n_clients}")
    return gamma * (n_eff / n_clients) ** 0.5


def predicted_moment_scale(gamma: float, r: int, n_clients: int) -> float:
    """Theory (App. A eq. 23): adapter output first-moment scale after
    aggregation goes as gamma^2 * r / N.  SFed-LoRA makes this alpha^2
    independent of (N, r)."""
    return gamma ** 2 * r / n_clients
