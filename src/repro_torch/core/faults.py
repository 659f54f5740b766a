"""Deterministic fault injection for the buffered federated engine.

The port of ``repro/core/faults.py``: dropped, straggling (delayed) and
corrupted uploads, drawn per round so that a run replays its failure
schedule.

Where the JAX package folds the round key of its carried scan key, the port
derives each round's fault generator from (trainer seed,
``FaultConfig.seed``, round index) (:meth:`FaultModel.round_generator`), so
the schedule does not depend on how rounds are chunked, replays after a
watchdog rollback, and resumes bit for bit from a checkpoint that stores
nothing for it.  The numbers differ from ``jax.random``'s, so parity runs
inject the JAX draws (masks and noise leaves) into the round instead.

A zero rate draws nothing, and a null model (every rate zero) has no
generator at all: the buffered engine with it is the synchronous engine.

The per-round straggle draw composes into a geometric delay: a straggling
upload stays in flight and is drawn again next round, so ``P(delay = k) =
p^k (1-p)`` (``straggle=geom:P`` on the CLI).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch.tree import tree_leaves

CORRUPT_MODES = ("nan", "noise")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-round fault rates (probabilities in [0, 1]).

    ``dropout``   an attempted upload is lost this round; the client
                  resyncs from the broadcast and its update is gone.
    ``straggle``  an attempted upload is delayed: it stays in flight with
                  staleness tau + 1 and tries again next round.
    ``corrupt``   an arriving upload is corrupted in transit (the upload
                  only, never the client's local state).
    ``corrupt_mode``  "nan": leaves overwritten with NaN / Inf alternately;
                  "noise": ``noise_scale`` x leaf-RMS Gaussian noise added
                  (finite, but a norm outlier).
    ``seed``      selects an independent schedule on the same trainer.
    """
    dropout: float = 0.0
    straggle: float = 0.0
    corrupt: float = 0.0
    corrupt_mode: str = "nan"
    noise_scale: float = 10.0
    seed: int = 0

    def __post_init__(self):
        for f in ("dropout", "straggle", "corrupt"):
            v = getattr(self, f)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"FaultConfig.{f} must be in [0, 1], "
                                 f"got {v}")
        if self.corrupt_mode not in CORRUPT_MODES:
            raise ValueError(
                f"unknown corrupt_mode '{self.corrupt_mode}'; options "
                f"{CORRUPT_MODES}")

    @property
    def null(self) -> bool:
        """True when every fault rate is zero."""
        return self.dropout == 0.0 and self.straggle == 0.0 \
            and self.corrupt == 0.0


def parse_faults(spec: str) -> FaultConfig:
    """The ``--faults`` CLI syntax as a :class:`FaultConfig`:
    ``"dropout=0.1,straggle=geom:0.3,corrupt=0.01"``, keys ``dropout``,
    ``straggle`` (optionally ``geom:P``), ``corrupt``, ``mode``
    (nan|noise), ``noise`` (the scale) and ``seed``.  An empty spec is the
    null model."""
    kw = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        if "=" not in part:
            raise ValueError(
                f"bad --faults entry '{part}': expected key=value")
        k, v = (s.strip() for s in part.split("=", 1))
        if k == "straggle":
            kw["straggle"] = float(v.removeprefix("geom:"))
        elif k in ("dropout", "corrupt"):
            kw[k] = float(v)
        elif k == "mode":
            kw["corrupt_mode"] = v
        elif k == "noise":
            kw["noise_scale"] = float(v)
        elif k == "seed":
            kw["seed"] = int(v)
        else:
            raise ValueError(
                f"unknown --faults key '{k}'; expected one of dropout, "
                "straggle, corrupt, mode, noise, seed")
    return FaultConfig(**kw)


def _map_indexed(fn, tree):
    """``fn(i, leaf)`` over a nested dict, ``i`` the leaf's index in
    sorted-key order (``tree_leaves``, JAX's order); keys keep their
    order in the result."""
    count = itertools.count()

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        return fn(next(count), node)
    return walk(tree)


class FaultModel:
    """Sampler for one :class:`FaultConfig`.  Stateless: every draw comes
    from the generator the caller passes."""

    def __init__(self, cfg: FaultConfig = None):
        self.cfg = cfg or FaultConfig()

    def round_generator(self, seed: int, round_idx: int,
                        device) -> torch.Generator:
        """The generator of round ``round_idx``'s faults on ``device``,
        seeded from (``seed``, ``cfg.seed``, ``round_idx``) alone."""
        s = np.random.SeedSequence(
            [int(seed), int(self.cfg.seed), int(round_idx)])
        return torch.Generator(device).manual_seed(
            int(s.generate_state(1, np.uint64)[0]))

    def sample(self, generator: torch.Generator, n: int) -> dict:
        """(n,) bool masks ``{"drop", "straggle", "corrupt"}`` on the
        generator's device, drawn in that order; a zero rate draws
        nothing and gives all False."""
        dev = generator.device
        out = {}
        for name, p in (("drop", self.cfg.dropout),
                        ("straggle", self.cfg.straggle),
                        ("corrupt", self.cfg.corrupt)):
            out[name] = (torch.rand((n,), generator=generator, device=dev) < p
                         if p > 0 else
                         torch.zeros((n,), dtype=torch.bool, device=dev))
        return out

    def draw(self, generator: torch.Generator, tree) -> dict:
        """One round's draws over the client-stacked ``tree``: the masks of
        :meth:`sample`, then under "noise" mode (at a non-zero rate) one
        standard normal draw per leaf of ``tree`` in ``tree_leaves`` order
        and of its shape (every client's row, as JAX draws them) as
        ``"noise"``, else None."""
        out = self.sample(generator, tree_leaves(tree)[0].shape[0])
        out["noise"] = None
        if self.cfg.corrupt > 0 and self.cfg.corrupt_mode == "noise":
            out["noise"] = [torch.randn(x.shape, generator=generator,
                                        device=x.device, dtype=x.dtype)
                            for x in tree_leaves(tree)]
        return out

    def corrupt_tree(self, tree, mask, noise=None):
        """A copy of the client-stacked ``tree`` with the rows of ``mask``
        (n,) corrupted: "nan" mode writes NaN into even-indexed leaves
        (sorted-key order) and Inf into odd ones; "noise" mode adds
        ``noise_scale`` x the leaf's RMS x ``noise[i]`` (the leaf's draw,
        :meth:`draw`).  At a zero rate the tree itself comes back."""
        cfg = self.cfg
        if cfg.corrupt <= 0:
            return tree
        if cfg.corrupt_mode == "noise" and noise is None:
            raise ValueError("noise-mode corruption needs the round's noise "
                             "draws (FaultModel.draw)")

        def leaf(i, x):
            row = mask.reshape((-1,) + (1,) * (x.ndim - 1))
            if cfg.corrupt_mode == "nan":
                return torch.where(row, float("inf") if i % 2 else
                                   float("nan"), x)
            rms = torch.sqrt(torch.mean(torch.square(x)) + 1e-12)
            return x + torch.where(row, cfg.noise_scale * rms * noise[i],
                                   torch.zeros((), dtype=x.dtype,
                                               device=x.device))
        return _map_indexed(leaf, tree)
