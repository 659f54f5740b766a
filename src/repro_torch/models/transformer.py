"""Block-stack transformer machinery.

The port of ``repro/models/transformer.py`` for the dense ``"attn"`` block.
Parameters keep the JAX tree, ``{"repeat": {"p0": ...}, "tail": {...}}``,
with the leading layer dim on repeat leaves, so carrying weights across is
a plain copy.  Where JAX scans over the layer dim, this module loops over
it in Python.  Other block kinds are not ported yet and raise.

  init_block(cfg, generator, kind)                -> params
  apply_block(..., mode="fullseq")                -> (x, aux)
  apply_block(..., mode="prefill"|"decode", cache=)  -> (x, aux, cache)

A cache is either per-request ring buffers (``init_stack_cache``) or, for
the continuous-batching scheduler, shared paged pools
(``init_paged_stack_cache``) addressed through a block ``table``.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import (attention_decode,
                                          attention_decode_paged,
                                          attention_fullseq,
                                          attention_prefill,
                                          attention_prefill_paged,
                                          attn_params, init_kv_cache,
                                          init_paged_kv_cache,
                                          paged_decode_index)
from repro_torch.models.layers import (apply_norm, mlp_apply, mlp_params,
                                       norm_params)
from repro_torch.tree import tree_leaves, tree_map


def _check_kind(cfg, kind: str):
    if kind != "attn" or cfg.moe is not None:
        what = "moe" if kind == "attn" else kind
        raise NotImplementedError(
            f"block '{what}' is not yet ported to repro_torch (only the "
            "dense 'attn' block is)")


# ---------------------------------------------------------------- block init

def init_block(cfg, generator, kind: str, *, lead=()):
    """One block's parameters (``lead`` prepends stacked layer dims)."""
    _check_kind(cfg, kind)
    d = cfg.d_model
    dev = generator.device
    p = dict(norm_params(cfg, d, "ln1", device=dev, lead=lead))
    p["attn"] = attn_params(cfg, generator, lead=lead)
    p.update(norm_params(cfg, d, "ln2", device=dev, lead=lead))
    p["mlp"] = mlp_params(cfg, generator, d, cfg.d_ff, lead=lead)
    return p


def init_block_cache(cfg, kind: str, batch: int, max_len: int, dtype, *,
                     device):
    _check_kind(cfg, kind)
    return init_kv_cache(cfg, batch, max_len, dtype, device=device)


def init_paged_block_cache(cfg, kind: str, num_blocks: int, block_size: int,
                           dtype, *, device):
    """Paged-serving counterpart of :func:`init_block_cache`: attention KV
    lives in a shared block pool (no batch dim: requests own pool blocks
    through the block table)."""
    _check_kind(cfg, kind)
    return init_paged_kv_cache(cfg, num_blocks, block_size, dtype,
                               device=device)


# ---------------------------------------------------------------- block apply

def apply_block(cfg, kind, p, x, *, adapters=None, positions=None,
                causal=True, mode="fullseq", cache=None, pos=None,
                table=None):
    """``mode``: "fullseq" (no cache), "prefill" (whole prompt, cache
    filled as the token-by-token decode would have), "decode" (one token
    against the cache).  Prefill and decode return (x, aux, cache);
    fullseq returns (x, aux).  ``aux`` (the MoE router loss in the JAX
    package) is 0.0 for the dense block.

    A paged cache (``k_pool`` leaves instead of per-request ``k`` rings)
    takes the paged prefill / decode and requires ``table``: in prefill
    the block table (b, blocks_per_req) int32, in decode the step's
    :class:`~repro_torch.models.attention.PagedDecode` (which
    :func:`decode_stack` builds once for all layers).  A ring cache
    ignores it."""
    _check_kind(cfg, kind)
    adapters = adapters or {}
    aux = 0.0
    h1 = apply_norm(cfg, x, p, "ln1")
    paged = cache is not None and "k_pool" in cache
    if paged and table is None:
        raise ValueError("a paged cache needs the requests' block table")
    if mode == "fullseq":
        a = attention_fullseq(cfg, p["attn"], h1, causal=causal,
                              adapters=adapters.get("attn"),
                              positions=positions)
    elif mode == "prefill" and paged:
        a, cache = attention_prefill_paged(cfg, p["attn"], h1, cache,
                                           positions, table,
                                           adapters=adapters.get("attn"))
    elif mode == "prefill":
        a, cache = attention_prefill(cfg, p["attn"], h1, cache, positions,
                                     adapters=adapters.get("attn"))
    elif mode == "decode" and paged:
        a, cache = attention_decode_paged(cfg, p["attn"], h1, cache, table,
                                          pos, adapters=adapters.get("attn"))
    elif mode == "decode":
        a, cache = attention_decode(cfg, p["attn"], h1, cache, pos,
                                    adapters=adapters.get("attn"))
    else:
        raise ValueError(f"unknown mode '{mode}'")
    x = x + a
    x = x + mlp_apply(cfg, p["mlp"], apply_norm(cfg, x, p, "ln2"))
    if mode == "fullseq":
        return x, aux
    return x, aux, cache


# ---------------------------------------------------------------- the stack

def stack_layout(num_layers: int, pattern):
    m = len(pattern)
    return num_layers // m, tuple(pattern[:num_layers % m])


def init_stack(cfg, generator, *, num_layers=None, pattern=None):
    num_layers = num_layers or cfg.num_layers
    pattern = pattern or cfg.block_pattern
    repeats, tail = stack_layout(num_layers, pattern)
    out = {"repeat": {}, "tail": {}}
    if repeats:
        for j, kind in enumerate(pattern):
            out["repeat"][f"p{j}"] = init_block(cfg, generator, kind,
                                                lead=(repeats,))
    for i, kind in enumerate(tail):
        out["tail"][f"t{i}"] = init_block(cfg, generator, kind)
    return out


def init_stack_cache(cfg, batch, max_len, dtype, *, device, num_layers=None,
                     pattern=None):
    num_layers = num_layers or cfg.num_layers
    pattern = pattern or cfg.block_pattern
    repeats, tail = stack_layout(num_layers, pattern)

    def mk(kind):
        return init_block_cache(cfg, kind, batch, max_len, dtype,
                                device=device)

    out = {"repeat": {}, "tail": {}}
    if repeats:
        for j, kind in enumerate(pattern):
            out["repeat"][f"p{j}"] = tree_map(
                lambda a: a.expand((repeats,) + a.shape).clone(), mk(kind))
    for i, kind in enumerate(tail):
        out["tail"][f"t{i}"] = mk(kind)
    return out


def init_paged_stack_cache(cfg, num_blocks, block_size, dtype, *, device,
                           num_layers=None, pattern=None):
    """Stack cache for the paged serving engine: attention layers hold
    SHARED pools (repeat leaves gain a leading layer dim as usual)."""
    num_layers = num_layers or cfg.num_layers
    pattern = pattern or cfg.block_pattern
    repeats, tail = stack_layout(num_layers, pattern)

    def mk(kind):
        return init_paged_block_cache(cfg, kind, num_blocks, block_size,
                                      dtype, device=device)

    out = {"repeat": {}, "tail": {}}
    if repeats:
        for j, kind in enumerate(pattern):
            out["repeat"][f"p{j}"] = tree_map(
                lambda a: a.expand((repeats,) + a.shape).clone(), mk(kind))
    for i, kind in enumerate(tail):
        out["tail"][f"t{i}"] = mk(kind)
    return out


def reset_paged_blocks(cache, blocks):
    """Invalidate ``blocks`` (1-D int) in every layer's pos pool before
    reuse: freed blocks keep stale ``pos >= 0`` entries that the validity
    mask would otherwise re-admit into a new owner's attention.  In
    place; returns ``cache``.

    The JAX package also keeps per-slot state for its recurrent and
    cross-attention blocks, which admission prefills on a separate view and
    merges back (``paged_prefill_view`` / ``merge_paged_cache``).  The
    dense block has pools only, so admission prefills on the engine cache
    itself; those two come with the first ported block kind that has
    per-slot state."""
    for part in cache.values():
        for c in part.values():
            pp = c["pos_pool"]                # (P, bs) or (repeats, P, bs)
            pp[..., torch.as_tensor(blocks, dtype=torch.long,
                                    device=pp.device), :] = -1
    return cache


def _layers(cfg, pattern, stack_params, adapters, cache=None):
    """(kind, params, adapters, cache) per layer in stack order: the
    repeats slice one layer off every stacked leaf (views, no copies)."""
    adapters = adapters or {}
    rep_p = stack_params.get("repeat") or {}
    rep_a = adapters.get("repeat") or {}
    if rep_p:
        n_rep = tree_leaves(rep_p)[0].shape[0]
        for i in range(n_rep):
            for j, kind in enumerate(pattern):
                key = f"p{j}"
                at = (lambda t, i=i: t[i])
                yield (kind, tree_map(at, rep_p[key]),
                       tree_map(at, rep_a.get(key)),
                       None if cache is None
                       else tree_map(at, cache["repeat"][key]))
    tail_a = adapters.get("tail") or {}
    for i in range(len(stack_params.get("tail") or {})):
        key = f"t{i}"
        yield (pattern[i], stack_params["tail"][key], tail_a.get(key),
               None if cache is None else cache["tail"][key])


def apply_stack(cfg, stack_params, x, *, adapters=None, positions=None,
                causal=True, pattern=None):
    """Full-sequence forward.  Returns (x, aux_sum).  ``adapters`` is the
    prepared "stack" subtree of an AdapterSet; banked per-request trees
    must be in scan layout (:func:`batched_scan_layout`)."""
    pattern = pattern or cfg.block_pattern
    aux_total = 0.0
    for kind, p, lo, _ in _layers(cfg, pattern, stack_params, adapters):
        x, aux = apply_block(cfg, kind, p, x, adapters=lo,
                             positions=positions, causal=causal)
        aux_total = aux_total + aux
    return x, aux_total


def prefill_stack(cfg, stack_params, cache, x, positions, *, adapters=None,
                  pattern=None, table=None):
    """Whole-prompt forward that also fills every layer's cache in one
    pass.  Returns (x, aux_sum, cache); the cache is updated in place.
    ``table`` routes a paged cache; every layer uses the same one (each
    layer has its own pools, so the same block ids name disjoint memory)."""
    pattern = pattern or cfg.block_pattern
    aux_total = 0.0
    for kind, p, lo, c in _layers(cfg, pattern, stack_params, adapters,
                                  cache):
        x, aux, _ = apply_block(cfg, kind, p, x, adapters=lo,
                                positions=positions, mode="prefill", cache=c,
                                table=table)
        aux_total = aux_total + aux
    return x, aux_total, cache


def decode_stack(cfg, stack_params, cache, x, pos, *, adapters=None,
                 pattern=None, table=None):
    """One-token decode through the stack.  Returns (x, cache); the cache
    is updated in place.  ``table`` as in :func:`prefill_stack`; its
    new-token slots and int32 positions are computed once here, not in
    every layer."""
    pattern = pattern or cfg.block_pattern
    if table is not None:
        first = next(iter((cache["repeat"] or cache["tail"]).values()))
        table = paged_decode_index(table, pos, first["k_pool"].shape[-3])
    for kind, p, lo, c in _layers(cfg, pattern, stack_params, adapters,
                                  cache):
        x, _, _ = apply_block(cfg, kind, p, x, adapters=lo, mode="decode",
                              cache=c, pos=pos, table=table)
    return x, cache


def batched_scan_layout(stack_adapters):
    """Layer-major layout for a per-request adapter tree
    (``AdapterBank.gather``): repeat leaves (B, layers, ...) become
    (layers, B, ...), so slicing one layer gives the 3-D per-request
    leaves the batched projection takes.  Tail leaves stay as they are."""
    if not stack_adapters:
        return stack_adapters
    out = dict(stack_adapters)
    if stack_adapters.get("repeat"):
        out["repeat"] = tree_map(lambda x: x.transpose(0, 1).contiguous(),
                                 stack_adapters["repeat"])
    return out


def _attach_ids(tree, ids):
    """``{"a", "b"}`` adapter nodes become ``{"a", "b", "ids"}``."""
    def walk(node):
        if isinstance(node, dict):
            if node and set(node) <= {"a", "b"}:
                return {**node, "ids": ids}
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(tree)


def banked_scan_layout(stack_adapters, ids):
    """Layer-major layout for a lazy bank tree (``AdapterBank.requests``):
    repeat leaves (K, layers, ...) become (layers, K, ...) and ``ids`` (B,)
    is broadcast to (layers, B), so each layer sees its own (K, ...) bank
    page and the request map.  The bank is never gathered here."""
    if not stack_adapters:
        return stack_adapters
    out = dict(stack_adapters)
    rep = stack_adapters.get("repeat")
    if rep:
        swapped = tree_map(lambda x: x.transpose(0, 1).contiguous(), rep)
        n_rep = tree_leaves(swapped)[0].shape[0]
        out["repeat"] = _attach_ids(swapped,
                                    ids.expand((n_rep,) + tuple(ids.shape)))
    if stack_adapters.get("tail"):
        out["tail"] = _attach_ids(stack_adapters["tail"], ids)
    return out
