"""One rank of a CPU mesh run for ``tests/test_torch_mesh.py``.

The test spawns ``world`` of these (``torch.multiprocessing``, spawn),
each with one torch thread, a gloo group over a file store in the test's
``tmp_path`` and a DeviceMesh from ``launch/mesh.mesh_from_spec``.  Each
rank runs the job's scenarios in order (every rank the same ones, so the
collectives line up) and writes its results to ``out<rank>.pkl``: a
trainer's history, adapters and optimizer state as numpy, or the
exception a scenario raised.  Imports torch and repro_torch only, so a
rank starts in a few seconds.
"""
from __future__ import annotations

import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy().copy()


def make_trainer(sc, mesh=None):
    """A reduced trainer from a scenario dict (the test builds the same
    one without a mesh)."""
    from repro_torch import configs
    from repro_torch.configs.base import (FederatedConfig, LoRAConfig,
                                          OptimizerConfig)
    from repro_torch.core.faults import parse_faults
    from repro_torch.core.federated import FederatedTrainer, WatchdogConfig
    from repro_torch.data.synthetic import FederatedDataset
    from repro_torch.models.api import build_model

    cfg = configs.get_config(sc["arch"]).reduced(d_model=64, vocab_size=256)
    n = sc.get("clients", 4)
    fed = dict(num_clients=n, local_steps=2,
               aggregation=sc.get("strategy", "fedsa"),
               participation=sc.get("participation", 1.0))
    if sc.get("faults"):
        fed.update(faults=parse_faults(sc["faults"]),
                   buffer_size=sc.get("buffer"))
    watchdog = (WatchdogConfig(max_retries=sc["watchdog"])
                if sc.get("watchdog") is not None else None)
    return FederatedTrainer(
        build_model(cfg),
        FederatedDataset(cfg.vocab_size, n, seq_len=16, batch_per_client=2,
                         seed=0),
        lora_cfg=LoRAConfig(rank=8, alpha=8.0,
                            scaling=sc.get("scaling", "sfedlora"),
                            targets=sc.get("targets", cfg.lora_targets)),
        fed_cfg=FederatedConfig(**fed),
        opt_cfg=OptimizerConfig(name=sc.get("optimizer", "sgd"),
                                lr=sc.get("lr", 0.5)),
        seed=0, base_params=sc.get("base"), lora_init=sc.get("lora_init"),
        data_mode=sc.get("data_mode", "host"), watchdog=watchdog,
        chunk_rounds=sc.get("chunk", 0), mesh=mesh, device="cpu")


def state(tr):
    return {"history": tr.history, "lora": _numpy(tr.lora),
            "opt": _numpy(tr.opt_state)}


def round_steps(tr, batches):
    """``FederatedTrainer.round_step`` over caller-supplied batches (a
    list of per-round dicts of numpy (N, local_steps, ...) leaves), from
    the trainer's state; the state and history it ends with."""
    aset, opt, hist = tr.adapters, tr.opt_state, []
    for r, batch in enumerate(batches):
        aset, opt, m = tr.round_step(
            tr.base, aset, opt, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, r)
        hist.append({k: float(v) for k, v in m.items()})
    return {"history": hist, "lora": _numpy(aset.lora), "opt": _numpy(opt)}


def decode_steps(sc, mesh=None):
    """Greedy decode of a reduced model from ``sc["base"]`` (numpy) and
    first tokens ``sc["token"]`` (b, 1), ``sc["steps"]`` steps from an
    empty cache.  On a mesh the base, the cache and each step's token and
    position are placed by the rules (``params_sharding``,
    ``cache_sharding``, ``inputs_sharding``) on the whole mesh.  Returns
    every step's logits (gathered) and tokens as numpy."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import configs
    from repro_torch.checkpoint.io import params_from_numpy
    from repro_torch.models.api import build_model
    from repro_torch.sharding import rules
    from repro_torch.sharding.specs import full_local
    from repro_torch.tree import tree_map

    cfg = configs.get_config(sc["arch"]).reduced(d_model=64, vocab_size=256)
    model = build_model(cfg)
    token = torch.from_numpy(sc["token"])
    b = token.shape[0]
    params = params_from_numpy(sc["base"], "cpu")
    cache = model.init_cache(b, sc["steps"] + 2, device="cpu")

    def place(tree, placements):
        if mesh is None:
            return tree
        return tree_map(lambda t, p: distribute_tensor(t, mesh, p), tree,
                        placements)
    params = place(params, rules.params_sharding(params, mesh)
                   if mesh is not None else None)
    cache = place(cache, rules.cache_sharding(cache, mesh)
                  if mesh is not None else None)
    logits_all, tokens = [], []
    for step in range(sc["steps"]):
        pos = torch.full((b,), step, dtype=torch.int32)
        feed = place({"token": token, "pos": pos},
                     rules.inputs_sharding({"token": token, "pos": pos}, mesh)
                     if mesh is not None else None)
        with torch.no_grad():
            logits, cache = model.decode_step(params, cache, feed["token"],
                                              feed["pos"])
        logits = full_local(logits)[:, -1]
        token = logits.argmax(-1, keepdim=True).to(torch.int32)
        logits_all.append(logits.numpy().copy())
        tokens.append(token.numpy().copy())
    return {"logits": np.stack(logits_all), "tokens": np.stack(tokens)}


def grouped_moe(sc, mesh=None):
    """One MoE layer of a reduced ``sc["arch"]`` under ``moe_grouped`` on
    ``sc["params"]`` and ``sc["x"]`` (numpy).  On a mesh the expert stacks
    are placed by ``params_sharding`` and x's batch rows split over the
    batch axes, so each rank dispatches its own rows.  Returns the output
    (gathered) and the aux loss as numpy."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch import configs
    from repro_torch.checkpoint.io import params_from_numpy
    from repro_torch.models.moe import moe_apply
    from repro_torch.sharding import opts, rules
    from repro_torch.sharding.specs import BATCH_AXES
    from repro_torch.tree import tree_map

    cfg = configs.get_config(sc["arch"]).reduced(d_model=64, vocab_size=256)
    params = params_from_numpy(sc["params"], "cpu")
    x = torch.from_numpy(sc["x"])
    if mesh is not None:
        tree = {"stack": {"repeat": {"p0": {"moe": tree_map(
            lambda t: t[None], params)}}}}
        pl = rules.params_sharding(tree, mesh)["stack"]["repeat"]["p0"]["moe"]
        params = tree_map(lambda t, p: distribute_tensor(t, mesh, [
            Shard(q.dim - 1) if q.is_shard() else q for q in p]), params, pl)
        x = distribute_tensor(x, mesh, [
            Shard(0) if n in BATCH_AXES else Replicate()
            for n in mesh.mesh_dim_names])
    opts.set_opts(["moe_grouped"])
    try:
        with torch.no_grad():
            out, aux = moe_apply(cfg, params, x)
    finally:
        opts.reset()
    full = (lambda t: t.full_tensor()) if mesh is not None else (
        lambda t: t)
    return {"out": full(out).numpy().copy(), "aux": full(aux).numpy().copy()}


def run_scenario(sc, mesh):
    if sc.get("decode"):
        return decode_steps(sc, mesh)
    if sc.get("moe"):
        return grouped_moe(sc, mesh)
    tr = make_trainer(sc, mesh)
    if sc.get("batches") is not None:
        return round_steps(tr, sc["batches"])
    if sc.get("restore"):
        tr.restore(sc["restore"])
    tr.run(sc["rounds"])
    if sc.get("save"):
        tr.save(sc["save"])
    return state(tr)


def main(rank, world, tmp, spec):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    from repro_torch.launch.mesh import mesh_from_spec
    with open(f"{tmp}/job.pkl", "rb") as f:
        job = pickle.load(f)
    results = {}
    try:
        mesh = mesh_from_spec(spec, "cpu")
        for name, sc in job.items():
            try:
                results[name] = run_scenario(sc, mesh)
            except Exception as e:                        # noqa: BLE001
                results[name] = {"error": type(e).__name__,
                                 "message": str(e),
                                 "trace": traceback.format_exc()}
    finally:
        with open(f"{tmp}/out{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()


def start(tmp, spec, job):
    """Start ``job`` (name -> scenario) on a CPU mesh of ``spec`` in the
    directory ``tmp``; returns a function that waits for the ranks and
    returns each rank's results."""
    import torch.multiprocessing as mp

    world = int(np.prod([int(d) for d in spec.split("x")]))
    with open(f"{tmp}/job.pkl", "wb") as f:
        pickle.dump(job, f)
    ctx = mp.start_processes(main, args=(world, str(tmp), spec),
                             nprocs=world, start_method="spawn", join=False)

    def results(timeout=300.0):
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"mesh {spec} ranks still running after "
                                   f"{timeout} s")
        out = []
        for r in range(world):
            with open(f"{tmp}/out{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    return results


def spawn(tmp, spec, job):
    """:func:`start`, waited for."""
    return start(tmp, spec, job)()
