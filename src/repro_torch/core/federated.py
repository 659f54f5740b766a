"""Federated LoRA fine-tuning: the synchronous engine.

The port of the synchronous path of ``repro/core/federated.py``.  One
federated round (paper section 3):
  1. every client runs ``local_steps`` SGD/AdamW steps on its LoRA params,
  2. the server aggregates per the strategy (FedSA/SFed: mean of A only),
  3. the aggregate is broadcast back.

Where the JAX package vmaps the client-local loop over a client dim and
scans rounds on the device, this module loops over clients and rounds in
Python on the client-stacked state; every adapted projection of a local
step goes through the LoRA matmul Function (kernels #5-#8 on CUDA).

The scaling factor gamma = scaling_factor(scheme, alpha, r, N) is folded
into B inside the loss (``AdapterSet.prepared``), so autograd takes the
gradient through that multiply and the kernels see gamma 1.0, as in JAX.

The frozen base may be packed (``core/quant.quantize_tree``): every
projection over it goes through the packed kernels on CUDA (#9-#12 with #7
and #8) and dequantizes on the CPU.

Not yet ported, and raising: ``data_mode="device"``, meshes, the watchdog,
the async buffered engine and faults, heterogeneous ranks.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.io import (load_federated_state,
                                       params_from_numpy,
                                       save_federated_state)
from repro_torch.core.aggregation import get_strategy
from repro_torch.core.lora import AdapterSet, init_lora
from repro_torch.core.scaling import scaling_factor
from repro_torch.optim.optimizers import (apply_updates, clip_by_global_norm,
                                          global_norm, make_optimizer)
from repro_torch.tree import tree_leaves, tree_map


def _not_yet(what: str):
    raise NotImplementedError(f"{what} is not yet ported to repro_torch")


def participation_weights(generator: torch.Generator, num_clients: int,
                          num_sampled: int):
    """(N,) float32 0/1 mask with exactly ``num_sampled`` ones, sampled
    uniformly without replacement from ``generator`` (on its device)."""
    perm = torch.randperm(num_clients, generator=generator,
                          device=generator.device)
    w = torch.zeros((num_clients,), dtype=torch.float32,
                    device=generator.device)
    w[perm[:num_sampled]] = 1.0
    return w


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _client(tree, i: int):
    return tree_map(lambda x: x[i], tree)


def _make_client_local(model, strat, opt_cfg):
    """The per-client local-training loop (``local_steps`` optimizer steps
    on one client's adapter state)."""
    _, opt_update = make_optimizer(opt_cfg)

    def client_local(base, lora, opt_state, batches, round_idx, gamma):
        losses, gnorms = [], []
        for batch in batches:
            leaves = tree_map(lambda x: x.detach().requires_grad_(True),
                              lora)
            loss, _ = model.loss(base, {"tokens": batch},
                                 adapters=AdapterSet(lora=leaves,
                                                     gamma=gamma))
            flat = tree_leaves(leaves)
            grads_flat = torch.autograd.grad(loss, flat)
            it = iter(grads_flat)
            grads = tree_map(lambda _: next(it), leaves)
            gnorm = global_norm(grads)
            grads = strat.mask_grads(grads, round_idx)
            if opt_cfg.grad_clip:
                grads = clip_by_global_norm(grads, opt_cfg.grad_clip)
            updates, opt_state = opt_update(grads, opt_state, lora)
            lora = apply_updates(lora, updates)
            losses.append(loss.detach())
            gnorms.append(gnorm)
        return lora, opt_state, {"loss": torch.stack(losses),
                                 "grad_norm": torch.stack(gnorms)}

    return client_local


def make_round_body(model, *, strategy, opt_cfg, track_update_norm=False):
    """Returns round_body(base, adapters, opt_N, batches, round_idx,
    weights).

    ``adapters`` is a client-stacked :class:`AdapterSet` with a float
    gamma: its ``lora`` tree and ``opt_N`` carry a leading client dim,
    ``batches`` is (N, local_steps, batch, seq).  Returns (adapters',
    opt_N', metrics) with metrics "loss" and "grad_norm" (means over
    clients and local steps, as 0-d tensors) and, with
    ``track_update_norm``, "update_norm": |gamma| times the norm of the
    post-aggregation adapter movement.

    ``weights`` (N,) non-negative: 0 = not sampled (keeps its local state
    and only receives the aggregate); positive values also weight the
    server mean.  Every client trains, sampled or not, and the metrics
    average over all of them, as in the JAX engine."""
    strat = get_strategy(strategy)
    client_local = _make_client_local(model, strat, opt_cfg)

    def round_body(base, adapters, opt_N, batches, round_idx, weights=None):
        lora_N = adapters.lora
        g = adapters.gamma
        if not isinstance(g, float) or adapters.rank_mask is not None:
            _not_yet("per-client gammas and rank masks (heterogeneous "
                     "clients)")
        n = tree_leaves(lora_N)[0].shape[0]
        outs = [client_local(base, _client(lora_N, i), _client(opt_N, i),
                             batches[i], round_idx, g) for i in range(n)]
        new_lora = _stack([o[0] for o in outs])
        new_opt = _stack([o[1] for o in outs])
        if weights is not None:
            def sel(new, old):
                keep = weights.reshape((-1,) + (1,) * (new.ndim - 1)) > 0
                return torch.where(keep, new, old)
            new_lora = tree_map(sel, new_lora, lora_N)
            new_opt = tree_map(sel, new_opt, opt_N)
        new_lora = strat.aggregate(new_lora, round_idx, weights=weights)
        metrics = {"loss": torch.stack([o[2]["loss"] for o in outs]).mean(),
                   "grad_norm": torch.stack(
                       [o[2]["grad_norm"] for o in outs]).mean()}
        if track_update_norm:
            metrics["update_norm"] = abs(g) * global_norm(
                tree_map(lambda a, b: a - b, new_lora, lora_N))
        return dataclasses.replace(adapters, lora=new_lora), new_opt, metrics

    return round_body


class FederatedTrainer:
    """Host-level orchestration: state, rounds, evaluation.

    Keeps the JAX trainer's interface: ``run``, ``run_round``,
    ``history``, ``adapters``, ``client_adapters``, ``client_gamma``,
    ``gamma`` and ``eval_perplexity``.  Batches come from
    ``dataset.round_batch`` on the host, in the order the JAX trainer
    stages them.

    ``base_params``: the frozen base (a tree of tensors, or of numpy
    arrays, placed on ``device``); drawn from the seed when None.
    ``lora_init``: one client's initial A/B tree (tensors or numpy), the
    JAX package's ``init_lora`` draw carried across; drawn from the seed
    when None.  All clients start from it (FedSA init: the same A, B = 0).

    Randomness: base and adapter init draw, in that order, from one
    ``torch.Generator`` seeded with ``seed``; participation sampling from
    one seeded with ``seed + 31337``.  The numbers differ from
    ``jax.random``'s, so parity runs inject the JAX draws (``lora_init=``,
    ``run_round(weights=)``).

    ``save`` / ``restore`` checkpoint the state in the JAX package's file
    format (``checkpoint/io.save_federated_state``): a restored run
    continues bit for bit.
    """

    def __init__(self, model, dataset, *, lora_cfg, fed_cfg, opt_cfg,
                 seed: int = 0, base_params=None, lora_init=None,
                 data_mode: str = "host", mesh=None,
                 track_stability: bool = False, watchdog=None,
                 device="cuda"):
        if data_mode == "device":
            _not_yet("data_mode='device' (DeviceFederatedData)")
        if data_mode != "host":
            raise ValueError(f"unknown data_mode '{data_mode}'")
        if mesh is not None:
            _not_yet("training on a mesh")
        if watchdog is not None:
            _not_yet("the collapse watchdog")
        if lora_cfg.ranks is not None:
            _not_yet("heterogeneous per-client ranks (lora_cfg.ranks)")
        self.device = resolve_device(device)
        self.model = model
        self.dataset = dataset
        self.fed_cfg = fed_cfg
        self.opt_cfg = opt_cfg
        self.lora_cfg = lora_cfg
        self.track_stability = track_stability
        n = fed_cfg.num_clients
        self.gamma = scaling_factor(lora_cfg.scaling, lora_cfg.alpha,
                                    lora_cfg.rank, n)
        self.gammas = (self.gamma,) * n
        gen = torch.Generator(self.device).manual_seed(seed)
        if base_params is None:
            base_params = model.init(gen, self.device)
        self.base = params_from_numpy(base_params, self.device) \
            if _is_numpy_tree(base_params) else base_params
        if lora_init is None:
            lora1 = init_lora(self.base, gen, lora_cfg,
                              targets=lora_cfg.targets)
        elif _is_numpy_tree(lora_init):
            lora1 = params_from_numpy(lora_init, self.device)
        else:
            lora1 = tree_map(lambda x: x.detach().to(self.device), lora_init)
        self.lora = tree_map(
            lambda x: x.expand((n,) + tuple(x.shape)).clone(), lora1)
        opt_init, _ = make_optimizer(opt_cfg)
        opt1 = opt_init(lora1)
        self.opt_state = tree_map(
            lambda x: x.expand((n,) + tuple(x.shape)).clone(), opt1)
        self.client_weights = None
        if fed_cfg.weight_by_size:
            if not hasattr(dataset, "size_weights"):
                raise ValueError(
                    "fed_cfg.weight_by_size needs a dataset exposing "
                    "size_weights (per-client example counts)")
            self.client_weights = torch.as_tensor(
                np.asarray(dataset.size_weights, np.float32),
                device=self.device)
        self._round_body = make_round_body(
            model, strategy=fed_cfg.aggregation, opt_cfg=opt_cfg,
            track_update_norm=track_stability)
        self._part_gen = torch.Generator(self.device).manual_seed(
            seed + 31337)
        self.round_idx = 0
        self.history = []

    # ------------------------------------------------------------- adapters

    @property
    def adapters(self) -> AdapterSet:
        """The client-stacked AdapterSet: the A/B state plus gamma and
        rank/alpha metadata as one value."""
        return AdapterSet(lora=self.lora, gamma=self.gamma,
                          rank=self.lora_cfg.rank, alpha=self.lora_cfg.alpha)

    def client_adapters(self, client: int) -> AdapterSet:
        """Client ``client``'s personalized AdapterSet."""
        return AdapterSet(lora=_client(self.lora, client),
                          gamma=self.gammas[client],
                          rank=self.lora_cfg.rank, alpha=self.lora_cfg.alpha)

    def client_gamma(self, client: int) -> float:
        return self.gammas[client]

    # -------------------------------------------------------------- running

    def _round_weights(self, weights):
        """The round's (N,) aggregation weights: the given participation
        mask, else one sampled at the configured participation (None at
        1.0), composed with the size weights."""
        n = self.fed_cfg.num_clients
        if weights is not None:
            weights = torch.tensor(weights, dtype=torch.float32,
                                   device=self.device)
        elif self.fed_cfg.participation < 1.0:
            num_sampled = max(1, int(round(self.fed_cfg.participation * n)))
            weights = participation_weights(self._part_gen, n, num_sampled)
        if self.client_weights is not None:
            weights = (self.client_weights if weights is None
                       else weights * self.client_weights)
        return weights

    def run_round(self, weights=None):
        """One federated round.  ``weights`` (N,) 0/1, optional: this
        round's participation mask instead of a sampled one (the parity
        tests inject the JAX engine's draws)."""
        batches = torch.as_tensor(
            self.dataset.round_batch(self.fed_cfg.local_steps),
            device=self.device)
        aset, self.opt_state, ms = self._round_body(
            self.base, self.adapters, self.opt_state, batches,
            self.round_idx, self._round_weights(weights))
        self.lora = aset.lora
        self.round_idx += 1
        m = {k: float(v) for k, v in ms.items()}
        m["round"] = self.round_idx
        self.history.append(m)
        return m

    def run(self, rounds=None, log_every: int = 0):
        rounds = rounds or self.fed_cfg.rounds
        for _ in range(rounds):
            m = self.run_round()
            if log_every and m["round"] % log_every == 0:
                print(f"round {m['round']:4d}  loss {m['loss']:.4f}  "
                      f"|g| {m['grad_norm']:.3e}  "
                      f"ppl {math.exp(m['loss']):.2f}")
        return self.history

    @torch.no_grad()
    def eval_perplexity(self, batch: int = 16, client: int = 0) -> float:
        """Held-out perplexity using client ``client``'s personalized
        model."""
        toks = torch.as_tensor(self.dataset.eval_batch(batch),
                               device=self.device)
        loss, _ = self.model.loss(self.base, {"tokens": toks},
                                  adapters=self.client_adapters(client))
        return float(torch.exp(loss))

    # ----------------------------------------------------------- checkpoint

    def save(self, path: str) -> None:
        """Checkpoint the base (packed leaves as packed), the client-stacked
        adapters and optimizer state, the round index, the participation
        generator's state, the dataset's RNG streams and partition, and the
        AdapterSet's metadata (``adapter_meta``: gammas, alpha, rank, ranks,
        scaling), under the JAX package's keys."""
        n = self.fed_cfg.num_clients
        meta = {"gammas": np.asarray(self.gammas, np.float32),
                "alpha": float(self.lora_cfg.alpha),
                "rank": int(self.lora_cfg.rank),
                "ranks": np.asarray((self.lora_cfg.rank,) * n, np.int64),
                "scaling": self.lora_cfg.scaling}
        save_federated_state(
            path, self.base, self.lora, self.opt_state, self.round_idx,
            generator_state=self._part_gen.get_state(),
            data_state=self.dataset.rng_state(),
            partition_state=self.dataset.partition_state(),
            adapter_meta=meta)

    def restore(self, path: str) -> None:
        """Load a checkpoint written by :meth:`save` or by the JAX trainer.

        The data partition is restored (and checked against the dataset's
        seed-derived tables, which raises on a mismatch), as the JAX
        trainer does.  A file with a per-client rank mask raises:
        heterogeneous ranks are not ported.  The port's participation
        generator resumes from its saved state; a JAX-written file carries a
        ``jax.random`` key instead, whose stream the port cannot continue,
        so it restores only at participation 1.0, where no round draws from
        it."""
        base, lora, opt, rnd, state = load_federated_state(path)
        if "rank_mask" in state:
            raise ValueError(
                "checkpoint per-client rank mask does not match this "
                "trainer's configured ranks (heterogeneous ranks are not yet "
                "ported to repro_torch)")
        gen_state = state.get("generator_state")
        if gen_state is None and self.fed_cfg.participation < 1.0:
            raise ValueError(
                f"checkpoint '{path}' has no participation generator state "
                + ("(it was written by the JAX trainer, whose jax.random key "
                   "repro_torch cannot continue) " if "prng_key" in state
                   else "")
                + f"but participation is {self.fed_cfg.participation} < 1, "
                "so the resumed rounds could not sample the clients the "
                "uninterrupted run would")
        if "partition_state" in state:
            self.dataset.set_partition_state(state["partition_state"])
            if self.client_weights is not None:
                self.client_weights = torch.as_tensor(
                    np.asarray(self.dataset.size_weights, np.float32),
                    device=self.device)
        self.base = params_from_numpy(base, self.device)
        self.lora = params_from_numpy(lora, self.device)
        self.opt_state = params_from_numpy(opt, self.device)
        self.round_idx = rnd
        # drop history from beyond the restored round, so consumers never
        # mix two timelines
        self.history = [h for h in self.history if h["round"] <= rnd]
        if gen_state is not None:
            self._part_gen.set_state(torch.from_numpy(gen_state))
        if "data_state" in state:
            self.dataset.set_rng_state(state["data_state"])


def _is_numpy_tree(tree) -> bool:
    leaves = tree_leaves(tree)
    return bool(leaves) and not isinstance(leaves[0], torch.Tensor)
