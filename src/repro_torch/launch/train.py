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

Heterogeneous clients (per-client ranks, each client training with its own
gamma_i = alpha sqrt(N / r_i)), aggregated by FedSA or by FLoRA's stacking:
  ... --arch llama2-7b --clients 4 --ranks 16,32,64,128 --strategy fedsa
  ... --arch llama2-7b --clients 4 --ranks 16,32,64,128 --strategy flora

Over a packed frozen base (int8 per channel, or int4 in groups of
``--quant-group``), checkpointed and resumed:
  ... --quant int4 --quant-group 64 --save ck.npz
  ... --quant int4 --resume ck.npz

It prints the JAX launcher's ``# ...`` header, its round lines and the
final held-out perplexity.  Flags of the JAX launcher whose machinery is
not ported yet (``--mesh``, ``--faults``, ``--buffer``, ``--watchdog``,
``--data-mode device``) are accepted by the parser and raise "not yet
ported".
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, NOT_YET_PORTED, get_config
from repro_torch.configs.base import (FederatedConfig, LoRAConfig,
                                      OptimizerConfig)
from repro_torch.core.aggregation import STRATEGIES
from repro_torch.core.federated import FederatedTrainer
from repro_torch.core.lora import init_lora
from repro_torch.core.quant import apply_quant_flag, quantize_tree
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.models.api import build_model


def _reject_unported(args):
    unported = {"--mesh": bool(args.mesh),
                "--faults": bool(args.faults),
                "--buffer": args.buffer is not None,
                "--watchdog": args.watchdog is not None,
                "--data-mode device": args.data_mode == "device"}
    for flag, given in unported.items():
        if given:
            raise NotImplementedError(
                f"{flag} is not yet ported to repro_torch")


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
    ap.add_argument("--data-mode", default="host", choices=("host", "device"),
                    help="host: dataset batches from the host; device: not "
                         "yet ported")
    ap.add_argument("--mesh", default="", help="not yet ported")
    ap.add_argument("--quant", default="none", choices=("none", "int8", "int4"),
                    help="store the frozen base packed (int8 per channel / "
                         "int4 grouped); the adapters stay fp, and the "
                         "kernels dequantize W as they load it "
                         "(core/quant.py)")
    ap.add_argument("--quant-group", type=int, default=64,
                    help="int4 group size (power of two <= 128)")
    ap.add_argument("--faults", default="", help="not yet ported")
    ap.add_argument("--buffer", type=int, default=None, metavar="M",
                    help="not yet ported")
    ap.add_argument("--watchdog", type=int, default=None, metavar="RETRIES",
                    help="not yet ported")
    ap.add_argument("--save", default=None, help="checkpoint path (.npz)")
    ap.add_argument("--resume", default=None,
                    help="checkpoint to restore (round, adapters, optimizer "
                         "and RNG state, so the run continues bit for bit)")
    args = ap.parse_args(argv)
    _reject_unported(args)

    device = resolve_device(args.device)
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
    tr = FederatedTrainer(
        model, ds, lora_cfg=lora_cfg,
        fed_cfg=FederatedConfig(num_clients=args.clients,
                                local_steps=args.local_steps,
                                rounds=args.rounds,
                                aggregation=args.strategy,
                                partition=args.partition,
                                dirichlet_alpha=args.dirichlet_alpha,
                                participation=args.participation,
                                weight_by_size=args.weight_by_size),
        opt_cfg=OptimizerConfig(name=args.optimizer, lr=args.lr),
        seed=args.seed, base_params=base_params, lora_init=lora_init,
        device=device)
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
          + (f" quant={args.quant}" if args.quant != "none" else ""))
    tr.run(args.rounds, log_every=max(1, args.rounds // 10))
    ppl = tr.eval_perplexity()
    print(f"# final held-out perplexity: {ppl:.3f}")
    if args.save:
        tr.save(args.save)
        print(f"# saved -> {args.save}")
    return tr


if __name__ == "__main__":
    main()
