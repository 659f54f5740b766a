"""Multi-tenant batched LoRA serving from an AdapterBank: a fixed batch, or
a stream of requests through the continuous-batching scheduler.

The port of ``repro/launch/serve.py``.  A fixed-batch generation is one
``model.prefill`` over the whole prompt, which fills the KV cache, then an
eager decode loop of ``model.decode_step``.  Every adapted projection (q
and v by default) runs the BGMV kernels of ``kernels/bgmv.py`` on the card:
the matmul form in the prefill, the GEMV form in each decode step.

``serve_scheduled`` serves a stream: KV state lives in shared paged pools
(``Model.init_paged_cache``) handed out block by block by a
:class:`BlockPool`; requests are admitted into free engine slots in FIFO
same-length groups, decode runs in chunks over all slots, and finished or
timed-out requests free their slot and blocks at chunk boundaries.  On the
card each decode step's attention is the paged-attention kernel
(``kernels/paged_attention.py``).  ``--quant int8|int4`` serves either path
over a packed frozen base (``core/quant.py``): the adapted projections take
the quantized BGMV kernels, every other eligible projection the packed
GEMM of ``kernels/lora_matmul.py``.  ``--hot-slots K`` serves the bank
through a :class:`~repro_torch.core.lora.LiveAdapterBank` of K device
slots, and ``--deadline-steps D`` caps each request's tokens.

  # fresh random adapters on the card (B is zero-initialised, so the
  # adapters start as a no-op, as in the JAX package):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b

  # a Poisson request stream over an int4 base, on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \\
      --arrival-trace poisson:50:8 --quant int4

  # serve a federated checkpoint written by the JAX trainer:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --reduced --resume ck.npz --device cpu

``--merge CLIENT`` merges one tenant into the base weights instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis.hostcheck import check_adapter_ids
from repro_torch.checkpoint.io import load_adapter_state
from repro_torch.configs import ARCHS, NOT_YET_PORTED, get_config
from repro_torch.configs.base import LoRAConfig
from repro_torch.core.lora import (AdapterBank, AdapterSet, LiveAdapterBank,
                                   init_adapter_set)
from repro_torch.core.quant import (apply_quant_flag, dequantize_tree,
                                    has_quantized, requantize_merged)
from repro_torch.kernels import dispatch
from repro_torch.models.api import build_model
from repro_torch.models.transformer import reset_paged_blocks
from repro_torch.tree import tree_leaves, tree_map

# requests evicted at a chunk boundary for exceeding their deadline_steps
# (graceful degradation under load: truncated, not failed)
timeouts = 0


def reset_timeout_meter() -> None:
    global timeouts
    timeouts = 0


def _count_timeout(n: int = 1) -> None:
    global timeouts
    timeouts += n


def _prepare_base(m, params):
    """Loop-invariant handling of a packed frozen base, once per
    generation: the plain tier (CPU, or CUDA under ``plain_tier()``)
    dequantizes it up front, so no step dequantizes again; the kernel tier
    keeps the packed bytes, which the kernels dequantize as they load
    them."""
    if not has_quantized(params) or dispatch._use_kernel(
            tree_leaves(params)[0]):
        return params
    return dequantize_tree(params)


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
    params = _prepare_base(model, params)
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


# ----------------------------------------------- continuous-batching scheduler
#
# The fixed-batch engine above serves ONE batch per call: every request in
# it starts together, decodes in lockstep, and the batch holds its ring
# caches until the last request finishes.  The scheduler serves a STREAM:
#
#   * KV state lives in per-layer SHARED block pools addressed through a
#     per-slot block table; BlockPool hands blocks out and takes them back
#     on the host, so a finished request's memory is reusable at once.
#   * Decode runs in CHUNKS of ``chunk`` steps over all engine slots, active
#     or not: idle slots' table rows point at the null block 0, so their
#     discarded writes land where no live request looks.  The JAX package
#     runs a chunk as one jitted lax.scan; here it is an eager loop of
#     ``chunk`` decode steps whose tokens stay on the device, with one host
#     sync per chunk.  Between chunks the host admits arrived requests into
#     free slots and evicts finished ones.
#   * Admission is one prefill per same-length newcomer group, written
#     straight into the engine pools through the newcomers' table rows.
#
# With every request present at the start and uniform shapes, the admission
# group IS the fixed engine's batch and each chunk step runs the fixed
# engine's arithmetic, so on the plain tier scheduled greedy decode is
# token-identical to `generate` (tests/test_torch_paged.py).


class BlockPool:
    """Host-side free-list allocator over the paged cache's block axis.

    Block 0 is the NULL block: idle engine slots' table rows point at it,
    so their discarded decode writes land in a block no live request owns.
    It is never handed out: ``alloc`` serves blocks 1..num_blocks-1."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (one is the reserved null "
                             f"block), got {num_blocks}")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))
        self._held = set()

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int):
        """n blocks, or None if the pool cannot cover them (the caller
        defers admission; nothing is partially allocated)."""
        if n > len(self._free):
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._held.update(blocks)
        return blocks

    def free(self, blocks) -> None:
        blocks = list(blocks)
        bad = [b for b in blocks if b not in self._held]
        if bad or len(set(blocks)) != len(blocks):
            raise ValueError(f"freeing blocks not held (double free?): "
                             f"{bad or blocks}")
        for b in blocks:
            self._held.discard(b)
            self._free.append(b)


@dataclasses.dataclass
class Request:
    """One generation request for the scheduler.  ``steps`` counts generated
    tokens (prompt excluded), as in `generate`; ``arrival`` is seconds from
    scheduler start.  ``adapter_id`` is the TENANT: a row of a static
    AdapterBank, or a store tenant of a LiveAdapterBank; it is validated at
    the host boundary, never clamped.  The scheduler fills ``tokens`` (the
    generated ids, first token included) and ``t_first`` / ``t_done``
    (seconds from start).

    ``deadline_steps`` caps the tokens the scheduler spends on this request:
    one that reaches the cap is evicted at the next chunk boundary with its
    tokens truncated, ``timed_out`` set and the module's ``timeouts``
    counter bumped; its slot and blocks recycle at once."""
    rid: int
    prompt: np.ndarray
    steps: int
    adapter_id: int = 0
    arrival: float = 0.0
    deadline_steps: int | None = None
    slot: int = -1
    blocks: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    t_first: float | None = None
    t_done: float | None = None
    timed_out: bool = False


def _paged_admit(m, params, cache, prompts, table_rows, blocks, adapters):
    """Admission: invalidate the newcomers' (possibly recycled) blocks,
    prefill the same-length group straight into the engine pools through
    its table rows, and return each newcomer's first token (on the
    device)."""
    vocab = m.cfg.vocab_size
    adapters = _prepare_adapters(m, adapters)
    cache = reset_paged_blocks(cache, blocks)
    logits, cache = m.prefill(params, cache, prompts, adapters,
                              last_only=True, table=table_rows)
    return cache, logits[:, -1, :vocab].argmax(dim=-1)


def _paged_chunk(m, params, cache, tok, pos, active, table, adapters,
                 steps: int):
    """``steps`` greedy decode steps for every engine slot.  ``active``
    gates token emission and position advance; inactive slots still run
    (they write into the null block) and their tokens come out as 0.
    Returns (cache, tok, pos, tokens (slots, steps) on the device)."""
    vocab = m.cfg.vocab_size
    adapters = _prepare_adapters(m, adapters)
    out = []
    for _ in range(steps):
        lg, cache = m.decode_step(params, cache, tok, pos, adapters,
                                  table=table)
        nxt = lg[:, -1, :vocab].argmax(dim=-1)
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        pos = torch.where(active, pos + 1, pos)
        tok = nxt[:, None]
        out.append(nxt)
    return cache, tok, pos, torch.stack(out, dim=1)


@torch.no_grad()
def serve_scheduled(model, params, requests, *, bank=None, max_batch=4,
                    block_size=8, chunk=8, max_len=None, wait=True,
                    on_boundary=None):
    """Continuous-batching serve loop: admit / decode a chunk / evict until
    every request completes.  Returns the requests (mutated in place:
    ``tokens``, ``t_first``, ``t_done`` filled) sorted by rid.

    ``requests``: Request list; arrivals are seconds from loop start and are
    honoured against the wall clock (``wait=False`` treats every request as
    arrived: deterministic tests).  ``bank``: an AdapterBank (each
    request's ``adapter_id`` indexes a bank row) or a LiveAdapterBank
    (``adapter_id`` names a store tenant; non-resident tenants are promoted
    into hot slots at admission, slots gathered by running requests stay
    pinned).  ``max_len`` bounds prompt + steps per request and sizes the
    per-request block count; the pool holds exactly ``max_batch`` requests'
    worth of blocks plus the null block, so admission never waits for
    blocks while a slot is free.  The model runs on the device of
    ``params``.

    ``on_boundary(i)``: called at every scheduler boundary (before
    admission, between decode chunks) with a running index: the window in
    which publishing into a live bank is atomic with respect to chunks.

    Runs under ``torch.no_grad()`` (not inference mode), so a bank that
    ``on_boundary`` publishes into stays writable afterwards."""
    reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
    if not reqs:
        return []
    device = tree_leaves(params)[0].device
    live = bank if isinstance(bank, LiveAdapterBank) else None
    if bank is not None and live is None:
        # a live bank's store may grow mid-run (a publish from
        # on_boundary): its tenants are checked at admission instead
        for r in reqs:
            check_adapter_ids([r.adapter_id], bank.size,
                              what=f"request rid={r.rid}: adapter_id")
    need = max(len(r.prompt) + r.steps for r in reqs)
    max_len = max_len or need
    win = model.cfg.attn_window
    # a sliding-window model may wrap its virtual ring (vlen = blocks *
    # block_size) as the fixed engine's ring cache does, as long as the
    # ring still covers the window
    if need > max_len and (win is None or max_len < win):
        raise ValueError(f"request needs {need} positions > max_len "
                         f"{max_len}")
    # per-request virtual ring sized as the fixed engine's ring cache
    # (window-bounded), so the paged layout stays element-identical
    ring = min(max_len, win) if win else max_len
    mb = -(-ring // block_size)
    pool = BlockPool(1 + max_batch * mb)
    params = _prepare_base(model, params)
    cache = model.init_paged_cache(pool.num_blocks, block_size,
                                   device=device)
    table = torch.zeros((max_batch, mb), dtype=torch.int32, device=device)
    tok = torch.zeros((max_batch, 1), dtype=torch.long, device=device)
    pos = torch.zeros((max_batch,), dtype=torch.long, device=device)
    active = torch.zeros((max_batch,), dtype=torch.bool, device=device)
    ids_arr = np.zeros((max_batch,), np.int32)
    free_slots = list(range(max_batch))
    t0 = time.monotonic()
    clock = ((lambda: time.monotonic() - t0) if wait
             else (lambda: float("inf")))
    pending, running = list(reqs), []

    def cur_bank():
        return live.bank if live is not None else bank

    def finish(r, now):
        r.t_done = now
        running.remove(r)
        free_slots.append(r.slot)
        free_slots.sort()
        pool.free(r.blocks)
        active[r.slot] = False
        table[r.slot] = 0                   # back to the null block
        # a stale tenant id on an idle slot would keep being gathered
        # (harmless to outputs) and skew the live bank's LRU and pinning
        ids_arr[r.slot] = 0

    boundary = 0
    while pending or running:
        if on_boundary is not None:
            on_boundary(boundary)
        boundary += 1
        now = clock()
        # ---- admission: FIFO same-length groups into free slots.  The
        # head of the queue is never overtaken, which keeps the loop
        # deterministic and starvation-free.
        while pending and free_slots and pending[0].arrival <= now:
            plen = len(pending[0].prompt)
            group = []
            for r in pending:
                if (r.arrival <= now and len(r.prompt) == plen
                        and len(group) < len(free_slots)
                        and pool.available >= mb * (len(group) + 1)):
                    group.append(r)
                else:
                    break
            slot_map = None
            if group and live is not None:
                for r in group:
                    if not live.has(r.adapter_id):
                        raise ValueError(
                            f"request rid={r.rid}: unknown tenant "
                            f"{r.adapter_id} (store holds {live.tenants})")
                # hot slots gathered by running requests are pinned; shrink
                # the group from the tail (the head keeps FIFO priority)
                # until its tenants fit the unpinned hot set, deferring
                # admission when even the head cannot be promoted
                pinned = {int(ids_arr[r.slot]) for r in running}
                while group:
                    slot_map = live.acquire(
                        [r.adapter_id for r in group], pinned)
                    if slot_map is not None:
                        break
                    group.pop()
            if not group:
                break
            for r in group:
                pending.remove(r)
            slots = [free_slots.pop(0) for _ in group]
            rows = np.zeros((len(group), mb), np.int32)
            gather_ids = np.zeros((len(group),), np.int32)
            for i, (r, s) in enumerate(zip(group, slots)):
                r.slot, r.blocks = s, pool.alloc(mb)
                rows[i] = r.blocks
                gather_ids[i] = (slot_map[int(r.adapter_id)]
                                 if live is not None else r.adapter_id)
                ids_arr[s] = gather_ids[i]
            sl = torch.as_tensor(slots, dtype=torch.long, device=device)
            rows_t = torch.from_numpy(rows).to(device)
            table[sl] = rows_t
            prompts = torch.from_numpy(
                np.stack([np.asarray(r.prompt, np.int64) for r in group])
            ).to(device)
            adapters = (cur_bank().requests(gather_ids)
                        if bank is not None else None)
            cache, first = _paged_admit(model, params, cache, prompts,
                                        rows_t, rows.reshape(-1), adapters)
            tok[sl, 0] = first
            pos[sl] = plen
            active[sl] = True
            tnow = clock()
            first_host = first.cpu().numpy()
            for i, r in enumerate(group):
                r.tokens = [int(first_host[i])]
                r.t_first = None if tnow == float("inf") else tnow
                running.append(r)
            for r in [r for r in group if r.steps <= 1]:
                finish(r, r.t_first)
            for r in [r for r in group
                      if r in running and r.deadline_steps is not None
                      and len(r.tokens) >= r.deadline_steps]:
                r.timed_out = True
                _count_timeout()
                finish(r, r.t_first)

        # ---- decode chunk + eviction
        if running:
            if live is not None:
                # recency driven by the ids flowing through the scheduler
                live.touch([r.adapter_id for r in running])
            adapters = (cur_bank().requests(ids_arr.copy())
                        if bank is not None else None)
            cache, tok, pos, toks = _paged_chunk(
                model, params, cache, tok, pos, active, table, adapters,
                chunk)
            toks = toks.cpu().numpy()        # the chunk's one host sync
            tnow = clock()
            for r in list(running):
                # a deadline caps the tokens this request may consume; the
                # prefix up to the cap is identical to an un-deadlined run
                # (eviction happens between chunks, never inside one)
                cap = (r.steps if r.deadline_steps is None
                       else min(r.steps, r.deadline_steps))
                take = max(0, min(chunk, cap - len(r.tokens)))
                r.tokens.extend(int(t) for t in toks[r.slot, :take])
                if len(r.tokens) >= r.steps:
                    finish(r, None if tnow == float("inf") else tnow)
                elif len(r.tokens) >= cap:
                    r.timed_out = True
                    _count_timeout()
                    finish(r, None if tnow == float("inf") else tnow)
        elif pending:
            gap = pending[0].arrival - clock()
            if gap > 0:
                time.sleep(min(gap, 0.02))
    return sorted(reqs, key=lambda r: r.rid)


def make_requests(trace, *, prompt_len, steps, tenants, vocab, seed=0,
                  deadline_steps=None):
    """Request list from an arrival trace: ``poisson:RATE:N`` (N arrivals,
    RATE requests/s, seeded exponential gaps) or the path of a JSON list of
    ``{"arrival": s, "steps": n, "adapter": k, "deadline": d}`` records.
    Prompts are seeded random ids, adapters round-robin unless the trace
    names them; ``deadline_steps`` is the default token budget (None: no
    deadline), which a record's ``deadline`` overrides.  The numpy draws are
    the JAX package's, so both make the same requests from one seed."""
    rng = np.random.default_rng(seed)
    if trace.startswith("poisson:"):
        _, rate, n = trace.split(":")
        gaps = rng.exponential(1.0 / float(rate), int(n))
        recs = [{"arrival": float(t)} for t in np.cumsum(gaps)]
    else:
        with open(trace) as f:
            recs = json.load(f)

    def _deadline(rec):
        d = rec.get("deadline", deadline_steps)
        return None if d is None else int(d)

    reqs = [Request(rid=i,
                    prompt=rng.integers(0, vocab, prompt_len).astype(
                        np.int32),
                    steps=int(rec.get("steps", steps)),
                    adapter_id=int(rec.get("adapter", i % max(tenants, 1))),
                    arrival=float(rec.get("arrival", 0.0)),
                    deadline_steps=_deadline(rec))
            for i, rec in enumerate(recs)]
    for r in reqs:   # a bad trace record fails here, not serves tenant N-1
        if not 0 <= r.adapter_id < tenants:
            raise ValueError(
                f"request rid={r.rid}: adapter {r.adapter_id} out of range "
                f"for {tenants} tenants (trace record names a tenant the "
                "bank does not hold)")
        if r.deadline_steps is not None and r.deadline_steps < 1:
            raise ValueError(
                f"request rid={r.rid}: deadline_steps={r.deadline_steps} "
                "must be >= 1 (the admission prefill always emits the "
                "first token)")
    return reqs


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


def _where(device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _serve_stream(args, cfg, model, base, bank, device):
    """``--arrival-trace``: a request stream through the scheduler, with the
    JAX CLI's summary line."""
    reqs = make_requests(args.arrival_trace, prompt_len=4, steps=args.steps,
                         tenants=bank.size, vocab=cfg.vocab_size,
                         deadline_steps=args.deadline_steps)
    reset_timeout_meter()
    serve_bank = bank
    if args.hot_slots:
        serve_bank = LiveAdapterBank.from_bank(bank, hot_slots=args.hot_slots)
    if device.type == "cuda":
        from repro_torch.kernels.build import load
        load()                 # build the kernels before the clock starts
    t0 = time.monotonic()
    done = serve_scheduled(model, base, reqs, bank=serve_bank,
                           max_batch=args.max_batch,
                           block_size=args.block_size, chunk=args.chunk)
    dt = time.monotonic() - t0
    lats = sorted(r.t_done - r.arrival for r in done if r.t_done is not None)
    p50 = lats[len(lats) // 2] if lats else 0.0
    p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))] if lats else 0.0
    toks = sum(len(r.tokens) for r in done)
    n_to = sum(1 for r in done if r.timed_out)
    print(f"# {args.arch} scheduled serve: {len(done)} requests, "
          f"{bank.size} tenants, max_batch={args.max_batch} "
          f"block={args.block_size} chunk={args.chunk}  "
          f"p50={p50*1000:.0f}ms p99={p99*1000:.0f}ms "
          f"goodput={toks/dt:.1f} tok/s"
          + (f" timeouts={n_to}" if args.deadline_steps else ""))
    if args.hot_slots:
        print(f"# live bank: {serve_bank.hot_slots}/"
              f"{len(serve_bank.tenants)} slots hot, "
              f"{serve_bank.promotions} promotions, "
              f"{serve_bank.demotions} demotions")
    print(f"# on {_where(device)}")
    return done


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
                    help="serve from a packed frozen base: one-shot "
                         "quantization of the eligible GEMM weights (int8 "
                         "per channel, int4 grouped); adapters stay fp")
    ap.add_argument("--quant-group", type=int, default=64,
                    help="int4 group size (a power of two <= 128)")
    ap.add_argument("--merge", type=int, default=None, metavar="CLIENT",
                    help="merge this client's adapters into the base "
                         "weights instead of banked decode")
    ap.add_argument("--arrival-trace", default=None,
                    help="serve a request stream through the continuous-"
                         "batching scheduler: 'poisson:RATE:N' (seeded "
                         "Poisson arrivals) or a JSON trace file of "
                         "{arrival, steps, adapter, deadline} records")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="scheduler engine slots (concurrent requests)")
    ap.add_argument("--block-size", type=int, default=8,
                    help="KV tokens per pool block (paged cache)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per scheduler chunk (admission and "
                         "eviction happen at chunk boundaries)")
    ap.add_argument("--deadline-steps", type=int, default=None,
                    help="per-request token budget: requests still running "
                         "at this many tokens are evicted (truncated) at "
                         "the next chunk boundary and counted as timeouts")
    ap.add_argument("--hot-slots", type=int, default=0,
                    help="serve the bank through a LiveAdapterBank with "
                         "this many device-resident slots; the other "
                         "tenants wait in host memory and are promoted on "
                         "demand (0: the whole bank on the device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    base, bank = build_bank(args, cfg, model, device)
    # one-shot quantization (a packed checkpoint under a mismatched --quant
    # is an error)
    src = (f"checkpoint '{args.resume}'" if args.resume else "fresh base")
    base = apply_quant_flag(base, args.quant, args.quant_group, source=src)
    if args.arrival_trace:
        return _serve_stream(args, cfg, model, base, bank, device)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, 4),
                           generator=torch.Generator(device).manual_seed(2),
                           device=device)
    max_len = 4 + args.steps
    if args.merge is not None:
        merged = bank.adapter(args.merge).merge(base)
        if has_quantized(base):
            # the merge dequantizes the adapted leaves; pack them again or
            # --merge --quant would serve fp weights
            merged = requantize_merged(merged, base)
        label, run = f"merged tenant {args.merge}", (
            lambda: generate(model, merged, prompt, args.steps, max_len,
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
    print(f"# {args.arch} {label}, batch={args.batch} steps={args.steps}: "
          f"{dt * 1000 / args.steps:.2f} ms/token on {_where(device)}")
    print(seq[:, :12])
    return seq


if __name__ == "__main__":
    main()
