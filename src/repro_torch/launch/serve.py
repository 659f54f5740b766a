"""Multi-tenant batched LoRA serving from an AdapterBank.

The port of the fixed-batch path of ``repro/launch/serve.py``.  A
generation is one ``model.prefill`` over the whole prompt, which fills the
KV cache, then an eager decode loop of ``model.decode_step``.  Every
adapted projection (q and v by default) runs the BGMV kernels of
``kernels/bgmv.py`` on the card: the matmul form in the prefill, the GEMV
form in each decode step.

  # fresh random adapters on the card (B is zero-initialised, so the
  # adapters start as a no-op, as in the JAX package):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b

  # serve a federated checkpoint written by the JAX trainer:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --reduced --resume ck.npz --device cpu

``--merge CLIENT`` merges one tenant into the base weights instead.  The
scheduler (``--arrival-trace``), quantized bases (``--quant``), the live
bank (``--hot-slots``) and deadlines (``--deadline-steps``) are not ported
yet and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.analysis.hostcheck import check_adapter_ids
from repro_torch.checkpoint.io import load_adapter_state
from repro_torch.configs import ARCHS, NOT_YET_PORTED, get_config
from repro_torch.configs.base import LoRAConfig
from repro_torch.core.lora import AdapterBank, AdapterSet, init_adapter_set
from repro_torch.models.api import build_model
from repro_torch.tree import tree_map


def _prepare_adapters(m, adapters):
    """Loop-invariant adapter preparation, once per generation: gamma
    folds, rank masking, the bank's per-request gather and the layer-major
    relayout.  The ids are fixed for the whole call, so the lazy bank view
    materializes its request rows here; decode steps then see adapters
    that pair row i with adapter i (the kernels' ``ids=None``)."""
    if (adapters is not None and adapters.batched
            and adapters.ids is not None):
        idx = adapters.ids.long()
        adapters = dataclasses.replace(
            adapters, lora=tree_map(lambda x: x.index_select(0, idx),
                                    adapters.lora),
            ids=None)
    tree = m._stack_adapters(adapters)
    return None if tree is None else AdapterSet(lora={"stack": tree})


def _sample(logits, temperature: float, vocab: int, generator=None):
    """One next token per row from (b, V) logits, sliced to the real vocab
    first (the padded rows hold untrained logits).  ``temperature`` 0.0 is
    greedy."""
    logits = logits[..., :vocab]
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.inference_mode()
def generate(model, params, prompt, steps: int, max_len: int, adapters=None,
             *, temperature: float = 0.0, generator=None):
    """``steps`` tokens after the prompt: one batched prefill, then an
    eager decode loop.  ``adapters``: None (base or merged weights), an
    AdapterSet, or a banked per-request set (``AdapterBank.requests`` /
    ``gather``).  ``temperature`` > 0 samples with ``generator`` (default:
    a fresh one seeded 0).  Returns the (b, p + steps) sequence, prompt
    included."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    b, p = prompt.shape
    vocab = model.cfg.vocab_size
    if generator is None and temperature > 0.0:
        generator = torch.Generator(prompt.device).manual_seed(0)
    adapters = _prepare_adapters(model, adapters)
    cache = model.init_cache(b, max_len, device=prompt.device)
    logits, cache = model.prefill(params, cache, prompt, adapters,
                                  last_only=True)
    tok = _sample(logits[:, -1], temperature, vocab, generator)[:, None]
    out = [prompt.long(), tok]
    for pos in range(p, p + steps - 1):
        lg, cache = model.decode_step(
            params, cache, tok,
            torch.full((b,), pos, dtype=torch.long, device=prompt.device),
            adapters)
        tok = _sample(lg[:, -1], temperature, vocab, generator)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def generate_banked(model, params, bank: AdapterBank, adapter_ids, prompt,
                    steps: int, max_len: int, *, temperature: float = 0.0,
                    generator=None):
    """Multi-tenant generation: row i of ``prompt`` is served with tenant
    ``adapter_ids[i]``."""
    check_adapter_ids(adapter_ids, bank.size)
    return generate(model, params, prompt, steps, max_len,
                    adapters=bank.requests(adapter_ids),
                    temperature=temperature, generator=generator)


@torch.inference_mode()
def generate_hostloop(model, params, prompt, steps: int, max_len: int,
                      adapters=None):
    """Token-by-token greedy loop (the prompt, too, goes through single
    decode steps), with the adapters passed to every step as given: the
    oracle :func:`generate` is tested against."""
    b, p = prompt.shape
    vocab = model.cfg.vocab_size
    cache = model.init_cache(b, max_len, device=prompt.device)
    tok = prompt[:, :1]
    out = [tok.long()]
    for t in range(p + steps - 1):
        logits, cache = model.decode_step(
            params, cache, tok,
            torch.full((b,), t, dtype=torch.long, device=prompt.device),
            adapters)
        tok = (prompt[:, t + 1:t + 2] if t + 1 < p
               else logits[:, -1:, :vocab].argmax(dim=-1))
        out.append(tok.long())
    return torch.cat(out, dim=1)


# ----------------------------------------------------------------------- CLI

def build_bank(args, cfg, model, device):
    """(base_params, AdapterBank) from a checkpoint (``--resume``) or from
    fresh random adapters (seeded generators)."""
    if args.resume:
        lcfg = LoRAConfig(rank=args.rank, alpha=args.alpha,
                          scaling=args.scaling, targets=cfg.lora_targets)
        base, aset = load_adapter_state(args.resume, lora_cfg=lcfg,
                                        device=device)
        return base, AdapterBank.from_adapter_set(aset)
    params = model.init(torch.Generator(device).manual_seed(0), device)
    ranks = ([int(r) for r in args.ranks.split(",")] if args.ranks
             else [args.rank] * args.clients)
    sets = [init_adapter_set(
        params, torch.Generator(device).manual_seed(1000 + k),
        LoRAConfig(rank=r, alpha=args.alpha, scaling=args.scaling,
                   targets=cfg.lora_targets),
        n_clients=len(ranks)) for k, r in enumerate(ranks)]
    return params, AdapterBank.from_sets(sets)


def _reject_unported(args):
    unported = {"--arrival-trace": args.arrival_trace is not None,
                "--quant": args.quant != "none",
                "--hot-slots": args.hot_slots != 0,
                "--deadline-steps": args.deadline_steps is not None}
    for flag, given in unported.items():
        if given:
            raise NotImplementedError(
                f"{flag} is not yet ported to repro_torch")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b",
                    choices=sorted(ARCHS) + sorted(NOT_YET_PORTED))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--ranks", default="",
                    help="comma-separated per-tenant ranks for a fresh "
                         "mixed-rank bank, e.g. 4,8,16")
    ap.add_argument("--alpha", type=float, default=8.0)
    ap.add_argument("--scaling", default="sfedlora",
                    choices=("lora", "rslora", "sfedlora", "za", "zb"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--clients", type=int, default=4,
                    help="tenant count for a fresh bank (ignored with "
                         "--resume: every checkpointed client serves)")
    ap.add_argument("--resume", default=None,
                    help="federated checkpoint (.npz) to serve")
    ap.add_argument("--quant", default="none",
                    choices=("none", "int8", "int4"),
                    help="not yet ported")
    ap.add_argument("--quant-group", type=int, default=64,
                    help="not yet ported (with --quant)")
    ap.add_argument("--merge", type=int, default=None, metavar="CLIENT",
                    help="merge this client's adapters into the base "
                         "weights instead of banked decode")
    ap.add_argument("--arrival-trace", default=None, help="not yet ported")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="scheduler slots (with --arrival-trace)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="paged-cache block (with --arrival-trace)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="scheduler chunk (with --arrival-trace)")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="not yet ported")
    ap.add_argument("--hot-slots", type=int, default=0,
                    help="not yet ported")
    args = ap.parse_args(argv)
    _reject_unported(args)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    base, bank = build_bank(args, cfg, model, device)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, 4),
                           generator=torch.Generator(device).manual_seed(2),
                           device=device)
    max_len = 4 + args.steps
    if args.merge is not None:
        base = bank.adapter(args.merge).merge(base)
        label, run = f"merged tenant {args.merge}", (
            lambda: generate(model, base, prompt, args.steps, max_len,
                             temperature=args.temperature))
    else:
        ids = torch.arange(args.batch, device=device) % bank.size
        label = (f"banked decode: {bank.size} tenants (ranks "
                 f"{','.join(str(r) for r in bank.ranks)})")
        run = (lambda: generate_banked(model, base, bank, ids, prompt,
                                       args.steps, max_len,
                                       temperature=args.temperature))
    run()                                   # warm-up (kernel build, caches)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.monotonic()
    seq = run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"# {args.arch} {label}, batch={args.batch} steps={args.steps}: "
          f"{dt * 1000 / args.steps:.2f} ms/token on {where}")
    print(seq[:, :12])
    return seq


if __name__ == "__main__":
    main()
