"""Federated LoRA fine-tuning launcher: the port of ``repro.launch.train``.

On the card (the default device):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
      --rank 64 --scaling sfedlora --clients 4 --rounds 3 --seq 128

On the CPU, at smoke scale (the plain PyTorch versions of the kernels):
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
      --rounds 2

It prints the JAX launcher's ``# ...`` header, its round lines and the
final held-out perplexity.  Flags of the JAX launcher whose machinery is
not ported yet (``--ranks``, ``--mesh``, ``--quant``, ``--faults``,
``--buffer``, ``--watchdog``, ``--data-mode device``, ``--save``,
``--resume``) are accepted by the parser and raise "not yet ported".
"""
from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, NOT_YET_PORTED, get_config
from repro_torch.configs.base import (FederatedConfig, LoRAConfig,
                                      OptimizerConfig)
from repro_torch.core.aggregation import STRATEGIES
from repro_torch.core.federated import FederatedTrainer
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.models.api import build_model


def _reject_unported(args):
    unported = {"--ranks": bool(args.ranks),
                "--mesh": bool(args.mesh),
                "--quant": args.quant != "none",
                "--faults": bool(args.faults),
                "--buffer": args.buffer is not None,
                "--watchdog": args.watchdog is not None,
                "--data-mode device": args.data_mode == "device",
                "--save": args.save is not None,
                "--resume": args.resume is not None}
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
    ap.add_argument("--ranks", default="", help="not yet ported")
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
                    help="not yet ported")
    ap.add_argument("--faults", default="", help="not yet ported")
    ap.add_argument("--buffer", type=int, default=None, metavar="M",
                    help="not yet ported")
    ap.add_argument("--watchdog", type=int, default=None, metavar="RETRIES",
                    help="not yet ported")
    ap.add_argument("--save", default=None, help="not yet ported")
    ap.add_argument("--resume", default=None, help="not yet ported")
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
    tr = FederatedTrainer(
        model, ds,
        lora_cfg=LoRAConfig(rank=args.rank, alpha=args.alpha,
                            scaling=args.scaling, targets=cfg.lora_targets),
        fed_cfg=FederatedConfig(num_clients=args.clients,
                                local_steps=args.local_steps,
                                rounds=args.rounds,
                                aggregation=args.strategy,
                                partition=args.partition,
                                dirichlet_alpha=args.dirichlet_alpha,
                                participation=args.participation,
                                weight_by_size=args.weight_by_size),
        opt_cfg=OptimizerConfig(name=args.optimizer, lr=args.lr),
        seed=args.seed, device=device)
    print(f"# {args.arch}{' (reduced)' if args.reduced else ''}  "
          f"strategy={args.strategy} scaling={args.scaling} "
          f"gamma={tr.adapters.gamma:.4f} rank={args.rank} N={args.clients}"
          + (" weight-by-size" if args.weight_by_size else ""))
    tr.run(args.rounds, log_every=max(1, args.rounds // 10))
    ppl = tr.eval_perplexity()
    print(f"# final held-out perplexity: {ppl:.3f}")
    return tr


if __name__ == "__main__":
    main()
