"""Federated LoRA fine-tuning launcher: the port of ``repro.launch.train``.

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
      --rank 64 --scaling sfedlora --clients 4 --rounds 3 --seq 128

On the CPU, at smoke scale (the plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
      --rounds 2

The RG-LRU hybrid trains the same way, LoRA at q, v, wx and wy (on the
CPU: ``--arch recurrentgemma-9b --reduced --device cpu``):
  ... --arch recurrentgemma-9b --rank 64 --clients 4 --rounds 3 --seq 128

So do the MoE archs (the router's aux loss joins the gradient; over
``--quant`` only q / k / v / o are packed, the experts stay fp, as in JAX):
  ... --arch qwen2-moe-a2.7b --rank 64 --clients 4 --rounds 3 --seq 128
  ... --arch granite-moe-1b-a400m --quant int4 --clients 16 --data-mode device

``--data-mode device`` draws every round's batches on the device from a
generator of the trainer's own (``data/synthetic.DeviceFederatedData``).

Heterogeneous clients (per-client ranks, each client training with its own
gamma_i = alpha sqrt(N / r_i)), aggregated by FedSA or by FLoRA's stacking:
  ... --arch llama2-7b --clients 4 --ranks 16,32,64,128 --strategy fedsa
  ... --arch llama2-7b --clients 4 --ranks 16,32,64,128 --strategy flora

Over a packed frozen base (int8 per channel, or int4 in groups of
``--quant-group``), checkpointed and resumed:
  ... --quant int4 --quant-group 64 --save ck.npz
  ... --quant int4 --resume ck.npz

The fault-tolerant engine: buffered aggregation (``--buffer M``, 0 = no
cap), injected faults, server screening, the Theorem 4.2 staleness
correction and the collapse watchdog, in chunks of ``--chunk-rounds``:
  ... --chunk-rounds 4 --buffer 3 \
      --faults dropout=0.2,straggle=geom:0.3,corrupt=0.1 --watchdog 2
  ... --scaling lora --rank 64 --clients 8 --watchdog 2  # collapse -> rescale

It prints the JAX launcher's ``# ...`` header, its round lines, the
``# async:`` and ``# watchdog:`` lines and the final held-out perplexity.

On a mesh (``--mesh DxM``, ``PxDxM``, ``pod`` or ``multipod``), one
process per device under ``torch.distributed.run``: the clients shard
over the data axes and the base over ``model`` (``core/federated.py``).
The CLI reads the launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) and starts the default group itself, ``nccl`` on
``cuda`` (rank r on ``cuda:LOCAL_RANK``) and ``gloo`` on ``cpu``; device 0
alone prints and writes the checkpoint:
  python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.train --mesh 2x2 --reduced --device cpu
  python -m torch.distributed.run --nproc-per-node 8 \
      -m repro_torch.launch.train --mesh 4x2 --clients 8
``--mesh`` with ``--quant`` exits with the JAX launcher's message.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import socket

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, NOT_YET_PORTED, get_config
from repro_torch.configs.base import (FederatedConfig, LoRAConfig,
                                      OptimizerConfig)
from repro_torch.core.aggregation import STRATEGIES
from repro_torch.core.faults import parse_faults
from repro_torch.core.federated import FederatedTrainer, WatchdogConfig
from repro_torch.core.lora import init_lora
from repro_torch.core.quant import apply_quant_flag, quantize_tree
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.launch.mesh import mesh_from_spec, parse_spec
from repro_torch.models.api import build_model


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_group(device):
    """The default process group from ``torch.distributed.run``'s
    environment (one process, rank 0, on a free local port, without it):
    ``nccl`` over CUDA, this rank on ``cuda:LOCAL_RANK``; ``gloo`` over
    the CPU.  Returns the rank's device."""
    env = os.environ
    rank, world = int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1))
    addr = env.get("MASTER_ADDR", "localhost")
    port = env.get("MASTER_PORT") or _free_port()
    if device.type == "cuda":
        device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world)
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b",
                    choices=sorted(ARCHS) + sorted(NOT_YET_PORTED))
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant (CPU)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--ranks", default="",
                    help="comma-separated per-client ranks (heterogeneous "
                         "clients, one rank per client; overrides --rank: "
                         "clients pad to max(ranks) with a rank mask and "
                         "train with their own gamma_i)")
    ap.add_argument("--alpha", type=float, default=8.0)
    ap.add_argument("--scaling", default="sfedlora",
                    choices=("lora", "rslora", "sfedlora", "za", "zb"))
    ap.add_argument("--strategy", default="fedsa", choices=STRATEGIES)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of clients sampled per round")
    ap.add_argument("--optimizer", default="sgd", choices=("sgd", "adamw"))
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch-per-client", type=int, default=4)
    ap.add_argument("--partition", default="iid",
                    choices=("iid", "dirichlet"))
    ap.add_argument("--dirichlet-alpha", type=float, default=0.5,
                    help="Dir(alpha) concentration for the non-IID "
                         "partition (topic mixtures AND client sizes)")
    ap.add_argument("--weight-by-size", action="store_true",
                    help="weight the server aggregate by per-client "
                         "example counts instead of a plain mean")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-rounds", type=int, default=0,
                    help="rounds per chunk: the metrics reach the host, the "
                         "staleness correction folds and the watchdog "
                         "judges once a chunk (0: one chunk per log stride)")
    ap.add_argument("--data-mode", default="host", choices=("host", "device"),
                    help="host: dataset batches from the host; device: "
                         "batches drawn on the device each round "
                         "(DeviceFederatedData)")
    ap.add_argument("--mesh", default="",
                    help="train on a mesh: 'DxM', 'PxDxM', 'pod' (16x16) or "
                         "'multipod' (2x16x16), one process per device "
                         "under torch.distributed.run; clients over the "
                         "data axes, the base tensor-parallel over 'model'")
    ap.add_argument("--quant", default="none", choices=("none", "int8", "int4"),
                    help="store the frozen base packed (int8 per channel / "
                         "int4 grouped); the adapters stay fp, and the "
                         "kernels dequantize W as they load it "
                         "(core/quant.py)")
    ap.add_argument("--quant-group", type=int, default=64,
                    help="int4 group size (power of two <= 128)")
    ap.add_argument("--faults", default="",
                    help="deterministic fault injection, e.g. "
                         "'dropout=0.1,straggle=geom:0.3,corrupt=0.01' "
                         "(core/faults.parse_faults); implies the async "
                         "buffered engine")
    ap.add_argument("--buffer", type=int, default=None, metavar="M",
                    help="async buffered aggregation: cap the per-round "
                         "buffer at M accepted uploads (0 = no cap, M = N: "
                         "bit-identical to the synchronous engine at zero "
                         "faults)")
    ap.add_argument("--staleness-beta", type=float, default=0.5,
                    help="staleness discount exponent: an upload tau "
                         "rounds old aggregates with weight (1+tau)^-beta")
    ap.add_argument("--no-screen", action="store_true",
                    help="disable server-side screening of non-finite / "
                         "norm-outlier uploads before aggregation")
    ap.add_argument("--screen-mult", type=float, default=10.0,
                    help="reject finite uploads whose norm exceeds this "
                         "multiple of the round median")
    ap.add_argument("--watchdog", type=int, default=None, metavar="RETRIES",
                    help="collapse watchdog: judge every chunk against the "
                         "Theorem 4.2 sentinel; on a failed verdict roll "
                         "back to the chunk-start snapshot and retry "
                         "(rescale gamma / back off participation) up to "
                         "RETRIES times before raising")
    ap.add_argument("--save", default=None, help="checkpoint path (.npz)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint to restore (round, adapters, optimizer "
                         "and RNG state, so the run continues bit for bit)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if parse_spec(args.mesh) is None:
        return _train(args, device, None)
    if args.quant != "none":
        raise SystemExit("--quant is single-host for now (packed leaves "
                         "carry no sharding annotations); drop --mesh")
    device = _start_group(device)
    try:
        mesh = mesh_from_spec(args.mesh, device)
        with contextlib.ExitStack() as stack:
            if dist.get_rank():            # device 0 alone prints
                sink = stack.enter_context(open(os.devnull, "w"))
                stack.enter_context(contextlib.redirect_stdout(sink))
            return _train(args, device, mesh)
    finally:
        dist.destroy_process_group()


def _train(args, device, mesh):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    ds = FederatedDataset(cfg.vocab_size, args.clients, seq_len=args.seq,
                          batch_per_client=args.batch_per_client,
                          partition=args.partition,
                          dirichlet_alpha=args.dirichlet_alpha,
                          seed=args.seed)
    ranks = (tuple(int(r) for r in args.ranks.split(","))
             if args.ranks else None)
    lora_cfg = LoRAConfig(rank=max(ranks) if ranks else args.rank,
                          ranks=ranks, alpha=args.alpha,
                          scaling=args.scaling, targets=cfg.lora_targets)
    base_params = lora_init = None
    if args.quant != "none":
        # the trainer's draws, base then adapters from one generator, so
        # the packed tree quantizes the identical fp base the fp run trains
        # on, and training starts from the identical adapters
        gen = torch.Generator(device).manual_seed(args.seed)
        fp_base = model.init(gen, device)
        lora_init = init_lora(fp_base, gen, lora_cfg,
                              targets=lora_cfg.targets)
        base_params = quantize_tree(fp_base, args.quant, args.quant_group)
        del fp_base
    faults = parse_faults(args.faults) if args.faults else None
    watchdog = (WatchdogConfig(max_retries=args.watchdog)
                if args.watchdog is not None else None)
    tr = FederatedTrainer(
        model, ds, lora_cfg=lora_cfg,
        fed_cfg=FederatedConfig(num_clients=args.clients,
                                local_steps=args.local_steps,
                                rounds=args.rounds,
                                aggregation=args.strategy,
                                partition=args.partition,
                                dirichlet_alpha=args.dirichlet_alpha,
                                participation=args.participation,
                                weight_by_size=args.weight_by_size,
                                buffer_size=args.buffer,
                                staleness_beta=args.staleness_beta,
                                screen_updates=not args.no_screen,
                                screen_norm_mult=args.screen_mult,
                                faults=faults),
        opt_cfg=OptimizerConfig(name=args.optimizer, lr=args.lr),
        seed=args.seed, base_params=base_params, lora_init=lora_init,
        data_mode=args.data_mode, chunk_rounds=args.chunk_rounds,
        watchdog=watchdog, mesh=mesh, device=device)
    if args.resume:
        tr.restore(args.resume)
        # an fp checkpoint restored under --quant is packed once here; a
        # packed checkpoint under a mismatched flag is a hard error
        tr.base = apply_quant_flag(tr.base, args.quant, args.quant_group,
                                   source=f"checkpoint '{args.resume}'")
        print(f"# resumed from {args.resume} at round {tr.round_idx}")
    gamma_str = (f"gamma={tr.adapters.gamma:.4f} rank={args.rank}"
                 if ranks is None else
                 "gammas=" + ",".join(f"{g:.3f}" for g in tr.gammas)
                 + f" ranks={args.ranks}")
    print(f"# {args.arch}{' (reduced)' if args.reduced else ''}  "
          f"strategy={args.strategy} scaling={args.scaling} "
          f"{gamma_str} N={args.clients}"
          + (" weight-by-size" if args.weight_by_size else "")
          + (f" mesh={args.mesh}" if args.mesh else "")
          + (f" quant={args.quant}" if args.quant != "none" else "")
          + (f" buffer={'N' if args.buffer == 0 else args.buffer}"
             if tr.async_mode else "")
          + (f" faults[{args.faults}]" if args.faults else "")
          + (f" watchdog(retries={args.watchdog})" if watchdog else ""))
    tr.run(args.rounds, log_every=max(1, args.rounds // 10))
    if tr.async_mode:
        last = tr.history[-1]
        print(f"# async: gamma_eff={tr.gamma_eff:.4f} "
              f"n_eff={last['n_eff']:.2f} delivered={last['delivered']:.0f} "
              f"rejected={last['rejected']:.0f} stale={last['stale']:.0f}")
    for ev in tr.watchdog_events:
        print(f"# watchdog: round {ev['round']} verdict={ev['verdict']} "
              f"-> {ev['action']} ({ev['detail']}, retry {ev['retry']})")
    ppl = tr.eval_perplexity()
    print(f"# final held-out perplexity: {ppl:.3f}")
    if args.save:
        tr.save(args.save)
        print(f"# saved -> {args.save}")
    return tr


if __name__ == "__main__":
    main()
