"""Block-stack transformer machinery.

The port of ``repro/models/transformer.py`` for the ``"attn"`` block
(attention + MLP, or + the MoE MLP when ``cfg.moe`` is set), the
encoder-decoder's ``"xattn"`` block (self-attention, cross-attention over
the encoder output, MLP), the RG-LRU ``"rglru"`` block (recurrent temporal
mix + MLP, the hybrid family) and the xLSTM blocks ``"mlstm"`` and
``"slstm"`` (a norm and the mixer, no MLP).  Parameters keep the JAX tree,
``{"repeat": {"p0": ...}, "tail": {...}}``, with the leading layer dim on
repeat leaves, so carrying weights across is a plain copy.  Where JAX scans
over the layer dim, this module loops over it in Python.

  init_block(cfg, generator, kind)                -> params
  apply_block(..., mode="fullseq")                -> (x, aux)
  apply_block(..., mode="prefill"|"decode", cache=)  -> (x, aux, cache)

A cache is either per-request ring buffers (``init_stack_cache``) or, for
the continuous-batching scheduler, shared paged pools
(``init_paged_stack_cache``) addressed through a block ``table``, beside
the per-slot state of recurrent blocks and of the cross-attention K/V
(``cross_len`` encoder frames a slot).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.models import rglru as rglru_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.attention import (attention_core,
                                          attention_decode,
                                          attention_decode_paged,
                                          attention_fullseq,
                                          attention_prefill,
                                          attention_prefill_paged,
                                          attn_params, init_kv_cache,
                                          init_paged_kv_cache,
                                          paged_decode_index)
from repro_torch.models.layers import (apply_norm, checkpointed, linear,
                                       mlp_apply, mlp_params, norm_params)
from repro_torch.models.moe import moe_apply, moe_params
from repro_torch.sharding import opts
from repro_torch.sharding.specs import constrain, merge_heads, split_heads
from repro_torch.tree import tree_leaves, tree_map

KINDS = ("attn", "xattn", "rglru", "mlstm", "slstm")
XLSTM_KINDS = ("mlstm", "slstm")


def _check_kind(cfg, kind: str):
    if kind not in KINDS or (kind != "attn" and cfg.moe is not None):
        raise NotImplementedError(
            f"block '{kind}' is not yet ported to repro_torch (only the "
            "'attn' block, dense or MoE, and the 'xattn', 'rglru', 'mlstm' "
            "and 'slstm' blocks are)")


# ---------------------------------------------------------------- block init

def init_block(cfg, generator, kind: str, *, lead=()):
    """One block's parameters (``lead`` prepends stacked layer dims)."""
    _check_kind(cfg, kind)
    d = cfg.d_model
    dev = generator.device
    p = dict(norm_params(cfg, d, "ln1", device=dev, lead=lead))
    if kind in XLSTM_KINDS:
        # an xLSTM block is its norm and its mixer: no ln2, no MLP
        params_fn = getattr(xlstm_mod, f"{kind}_params")
        p[kind] = params_fn(cfg, generator, lead=lead)
        return p
    if kind == "rglru":
        p["rglru"] = rglru_mod.rglru_params(cfg, generator, lead=lead)
    else:
        p["attn"] = attn_params(cfg, generator, lead=lead)
    if kind == "xattn":
        p.update(norm_params(cfg, d, "lnx", device=dev, lead=lead))
        p["cross"] = attn_params(cfg, generator, lead=lead)
    p.update(norm_params(cfg, d, "ln2", device=dev, lead=lead))
    if cfg.moe is not None:
        p["moe"] = moe_params(cfg, generator, lead=lead)
    else:
        p["mlp"] = mlp_params(cfg, generator, d, cfg.d_ff, lead=lead)
    return p


def _cross_cache(cfg, batch, cross_len, dtype, device):
    """Zero cross-attention K/V for ``cross_len`` encoder frames a row."""
    shape = (batch, cross_len, cfg.num_kv_heads, cfg.head_dim)
    return {"cross_k": torch.zeros(shape, dtype=dtype, device=device),
            "cross_v": torch.zeros(shape, dtype=dtype, device=device)}


def init_block_cache(cfg, kind: str, batch: int, max_len: int, dtype, *,
                     device, cross_len: int = 0):
    _check_kind(cfg, kind)
    if kind == "xattn":
        return {"self": init_kv_cache(cfg, batch, max_len, dtype,
                                      device=device),
                **_cross_cache(cfg, batch, cross_len, dtype, device)}
    if kind == "rglru":
        return rglru_mod.rglru_init_cache(cfg, batch, dtype, device=device)
    if kind in XLSTM_KINDS:
        init = getattr(xlstm_mod, f"{kind}_init_cache")
        return init(cfg, batch, dtype, device=device)
    return init_kv_cache(cfg, batch, max_len, dtype, device=device)


def init_paged_block_cache(cfg, kind: str, num_blocks: int, block_size: int,
                           batch: int, dtype, *, device, cross_len: int = 0):
    """Paged-serving counterpart of :func:`init_block_cache`: attention KV
    lives in a shared block pool (no batch dim: requests own pool blocks
    through the block table), while a recurrent block and the
    cross-attention K/V keep constant-size PER-SLOT state for ``batch``
    engine slots (admission swaps it per slot, see
    :func:`paged_prefill_view`)."""
    _check_kind(cfg, kind)
    if kind == "attn":
        return init_paged_kv_cache(cfg, num_blocks, block_size, dtype,
                                   device=device)
    if kind == "xattn":
        return {"self": init_paged_kv_cache(cfg, num_blocks, block_size,
                                            dtype, device=device),
                **_cross_cache(cfg, batch, cross_len, dtype, device)}
    return init_block_cache(cfg, kind, batch, 0, dtype, device=device)


# ---------------------------------------------------------------- block apply

def _cross_attention(cfg, params, x, ck, cv, adapters=None):
    """Cross-attention against precomputed encoder K/V: no mask, no RoPE;
    q and o take their adapters."""
    b, s, _ = x.shape
    adapters = adapters or {}
    q = split_heads(linear(x, params["q"], adapters.get("q")),
                    cfg.num_heads, cfg.head_dim)
    mask = torch.ones((b, s, ck.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = attention_core(cfg, q, ck, cv, mask)
    return linear(merge_heads(out), params["o"], adapters.get("o"))


def build_cross_kv(cfg, p_cross, enc_out):
    """The encoder output projected to one layer's cross K/V (no RoPE, no
    adapter, as in the JAX package)."""
    b, t, _ = enc_out.shape
    shape = (b, t, cfg.num_kv_heads, cfg.head_dim)
    return (linear(enc_out, p_cross["k"]).reshape(shape),
            linear(enc_out, p_cross["v"]).reshape(shape))


def apply_block(cfg, kind, p, x, *, adapters=None, positions=None,
                causal=True, mode="fullseq", cache=None, pos=None,
                table=None, enc_out=None):
    """``mode``: "fullseq" (no cache), "prefill" (whole prompt, cache
    filled as the token-by-token decode would have), "decode" (one token
    against the cache).  Prefill and decode return (x, aux, cache);
    fullseq returns (x, aux).  ``aux`` is the MoE router's load-balance
    loss in every mode, and 0.0 for the dense, RG-LRU and xLSTM blocks.

    A paged attention cache (``k_pool`` leaves instead of per-request ``k``
    rings) takes the paged prefill / decode and requires ``table``: in
    prefill the block table (b, blocks_per_req) int32, in decode the step's
    :class:`~repro_torch.models.attention.PagedDecode` (which
    :func:`decode_stack` builds once for all layers).  A ring cache, and
    an RG-LRU or xLSTM block's per-slot state, ignore it.  An xLSTM block
    returns right after its mixer's residual (no ln2, no MLP).

    An ``"xattn"`` block's cache is ``{"self", "cross_k", "cross_v"}``.
    It cross-attends the K/V it builds from ``enc_out`` (b, frames, d) in
    fullseq mode and in a prefill given one, and writes them into the
    cache then; decode, and a prefill without ``enc_out``, read the
    cache's (a fresh cache cross-attends zeros, the JAX package's
    token-by-token semantics)."""
    _check_kind(cfg, kind)
    adapters = adapters or {}
    h1 = apply_norm(cfg, x, p, "ln1")
    if mode not in ("fullseq", "prefill", "decode"):
        raise ValueError(f"unknown mode '{mode}'")
    if kind in XLSTM_KINDS:
        a, cache = _xlstm_mix(cfg, kind, p[kind], h1, adapters.get(kind),
                              mode, cache)
        x = x + a
        return (x, 0.0) if mode == "fullseq" else (x, 0.0, cache)
    if kind == "rglru":
        a, cache = _rglru_mix(cfg, p["rglru"], h1, adapters.get("rglru"),
                              mode, cache)
    elif kind == "xattn":
        a, _ = _attn_mix(cfg, p["attn"], h1, adapters.get("attn"), mode,
                         None if cache is None else cache["self"],
                         positions, pos, table, causal)
    else:
        a, cache = _attn_mix(cfg, p["attn"], h1, adapters.get("attn"), mode,
                             cache, positions, pos, table, causal)
    x = x + a
    if kind == "xattn":
        x = x + _cross_mix(cfg, p, apply_norm(cfg, x, p, "lnx"),
                           adapters.get("cross"), mode, cache, enc_out)
    h2 = apply_norm(cfg, x, p, "ln2")
    aux = 0.0
    if cfg.moe is not None:
        mo, aux = moe_apply(cfg, p["moe"], h2, adapters=adapters.get("moe"))
        x = x + mo
    else:
        x = x + mlp_apply(cfg, p["mlp"], h2)
    if mode == "fullseq":
        return x, aux
    return x, aux, cache


def _attn_mix(cfg, p, h1, adapters, mode, cache, positions, pos, table,
              causal):
    paged = cache is not None and "k_pool" in cache
    if paged and table is None:
        raise ValueError("a paged cache needs the requests' block table")
    if mode == "fullseq":
        return attention_fullseq(cfg, p, h1, causal=causal,
                                 adapters=adapters,
                                 positions=positions), None
    if mode == "prefill" and paged:
        return attention_prefill_paged(cfg, p, h1, cache, positions, table,
                                       adapters=adapters)
    if mode == "prefill":
        return attention_prefill(cfg, p, h1, cache, positions,
                                 adapters=adapters)
    if paged:
        return attention_decode_paged(cfg, p, h1, cache, table, pos,
                                      adapters=adapters)
    return attention_decode(cfg, p, h1, cache, pos, adapters=adapters)


def _cross_mix(cfg, p, hx, adapters, mode, cache, enc_out):
    """The ``"xattn"`` block's cross-attention; a prefill given
    ``enc_out`` writes the K/V it builds into the cache (in place)."""
    if mode == "decode" or (mode == "prefill" and enc_out is None):
        ck, cv = cache["cross_k"], cache["cross_v"]
    else:
        ck, cv = build_cross_kv(cfg, p["cross"], enc_out)
        if mode == "prefill":
            cache["cross_k"].copy_(ck)
            cache["cross_v"].copy_(cv)
    return _cross_attention(cfg, p["cross"], hx, ck, cv, adapters)


def _rglru_mix(cfg, p, h1, adapters, mode, cache):
    if mode == "fullseq":
        return rglru_mod.rglru_apply_fullseq(cfg, p, h1, adapters), None
    if mode == "prefill":
        return rglru_mod.rglru_apply_prefill(cfg, p, h1, cache,
                                             adapters=adapters)
    return rglru_mod.rglru_apply_decode(cfg, p, h1, cache,
                                        adapters=adapters)


def _xlstm_mix(cfg, kind, p, h1, adapters, mode, cache):
    if mode == "fullseq":
        fn = getattr(xlstm_mod, f"{kind}_apply_fullseq")
        return fn(cfg, p, h1, adapters), None
    fn = getattr(xlstm_mod, f"{kind}_apply_{mode}")
    return fn(cfg, p, h1, cache, adapters=adapters)


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
                     pattern=None, cross_len=0):
    num_layers = num_layers or cfg.num_layers
    pattern = pattern or cfg.block_pattern
    repeats, tail = stack_layout(num_layers, pattern)

    def mk(kind):
        return init_block_cache(cfg, kind, batch, max_len, dtype,
                                device=device, cross_len=cross_len)

    out = {"repeat": {}, "tail": {}}
    if repeats:
        for j, kind in enumerate(pattern):
            out["repeat"][f"p{j}"] = tree_map(
                lambda a: a.expand((repeats,) + a.shape).clone(), mk(kind))
    for i, kind in enumerate(tail):
        out["tail"][f"t{i}"] = mk(kind)
    return out


def init_paged_stack_cache(cfg, num_blocks, block_size, batch, dtype, *,
                           device, num_layers=None, pattern=None,
                           cross_len=0):
    """Stack cache for the paged serving engine: attention layers hold
    SHARED pools, recurrent layers and the cross K/V per-slot state for
    ``batch`` engine slots (repeat leaves gain a leading layer dim as
    usual)."""
    num_layers = num_layers or cfg.num_layers
    pattern = pattern or cfg.block_pattern
    repeats, tail = stack_layout(num_layers, pattern)

    def mk(kind):
        return init_paged_block_cache(cfg, kind, num_blocks, block_size,
                                      batch, dtype, device=device,
                                      cross_len=cross_len)

    out = {"repeat": {}, "tail": {}}
    if repeats:
        for j, kind in enumerate(pattern):
            out["repeat"][f"p{j}"] = tree_map(
                lambda a: a.expand((repeats,) + a.shape).clone(), mk(kind))
    for i, kind in enumerate(tail):
        out["tail"][f"t{i}"] = mk(kind)
    return out


# The scheduler's cache surgery (launch/serve.py): a paged stack cache mixes
# two leaf families, SHARED pool subtrees (dicts holding "k_pool", no batch
# dim beyond the repeat-layer one) and PER-SLOT leaves (slot axis 0 in the
# tail, axis 1 under the repeat stacking).  Admission prefills newcomers on
# a view whose pools ARE the engine pools (the prefill writes only the
# newcomers' blocks, in place) and whose per-slot leaves are fresh inits at
# the group size; the merge then scatters the per-slot leaves into the
# newcomers' slots.


def _walk_paged(c, v, fn_pool, fn_leaf, axis):
    if isinstance(c, dict):
        if "k_pool" in c:
            return fn_pool(c, v, axis)
        return {k: _walk_paged(c[k], None if v is None else v[k], fn_pool,
                               fn_leaf, axis) for k in c}
    return fn_leaf(c, v, axis)


def _map_paged_cache(cache, view, fn_pool, fn_leaf):
    """``fn_pool(pool_subtree, view_subtree, axis)`` on every pool subtree
    and ``fn_leaf(leaf, view_leaf, axis)`` on every per-slot leaf, with
    ``axis`` the slot axis (1 under "repeat", 0 in "tail")."""
    return {part: {k: _walk_paged(cache[part][k],
                                  None if view is None else view[part][k],
                                  fn_pool, fn_leaf, axis)
                   for k in cache[part]}
            for part, axis in (("repeat", 1), ("tail", 0))}


def paged_prefill_view(cfg, cache, batch, dtype, *, device, cross_len=0):
    """Admission view: the engine's pools, and fresh per-slot state for a
    ``batch``-request newcomer group (zero recurrences and conv tails, the
    xLSTM's -1e30 stabilizers and 1e-6 sLSTM normaliser, zero cross K/V of
    ``cross_len`` frames: exactly what a fresh fixed-batch cache holds).  A
    dense stack has no per-slot leaves, so its view is the engine cache's
    own pools."""
    out = {}
    for part, layers in cache.items():
        out[part] = {}
        for key, c in layers.items():
            if "k_pool" in c:
                out[part][key] = c
                continue
            fresh = init_block_cache(cfg, cfg.block_pattern[int(key[1:])],
                                     batch, 0, dtype, device=device,
                                     cross_len=cross_len)
            if part == "repeat":
                n = tree_leaves(c)[0].shape[0]
                fresh = tree_map(
                    lambda a: a.expand((n,) + a.shape).clone(), fresh)
            if "self" in c:                   # an xattn layer's pools
                fresh["self"] = c["self"]
            out[part][key] = fresh
    return out


def merge_paged_cache(cache, view, slots):
    """Fold an admission view back into the engine cache: the pools are
    the engine's own (already written), per-slot leaves scatter into the
    newcomers' ``slots``.  In place; returns ``cache``."""
    def leaf(c, v, axis):
        if axis == 0:
            c[slots] = v
        else:
            c[:, slots] = v
        return c
    return _map_paged_cache(cache, view, lambda c, v, axis: c, leaf)


def reset_paged_blocks(cache, blocks):
    """Invalidate ``blocks`` (1-D int) in every layer's pos pool before
    reuse: freed blocks keep stale ``pos >= 0`` entries that the validity
    mask would otherwise re-admit into a new owner's attention.  In
    place; returns ``cache``."""
    def pool(c, v, axis):
        pp = c["pos_pool"]                    # (P, bs) or (repeats, P, bs)
        # index_fill_ takes -1 as a scalar argument: no host tensor to
        # upload (an indexed assignment would copy one, waiting for it)
        pp.index_fill_(-2, torch.as_tensor(blocks, dtype=torch.long,
                                           device=pp.device), -1)
        return c
    return _map_paged_cache(cache, None, pool, lambda c, v, axis: c)


def _first_pool(cache):
    """The first attention layer's pool subtree, or None (no attention)."""
    for part in cache.values():
        for c in part.values():
            c = c.get("self", c)              # an xattn layer's pools
            if "k_pool" in c:
                return c
    return None


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


def _dots_saveable(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat_dots``: save the outputs
    of matmuls without batch dims (a projection's ``mm`` / ``addmm``, as
    JAX's ``dots_with_no_batch_dims_saveable`` saves its dots) and
    recompute everything else (norms, RoPE, the batched attention
    einsums, elementwise ops)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def apply_stack(cfg, stack_params, x, *, adapters=None, positions=None,
                causal=True, pattern=None, remat=True, enc_out=None):
    """Full-sequence forward.  Returns (x, aux_sum).  ``adapters`` is the
    prepared "stack" subtree of an AdapterSet; banked per-request trees
    must be in scan layout (:func:`batched_scan_layout`).  ``enc_out``:
    the encoder output the ``"xattn"`` blocks cross-attend.

    ``remat`` (JAX's default, which every caller keeps): while autograd
    records, each repeat unit (one pass of ``pattern``) runs under one
    non-reentrant checkpoint, so the backward keeps the unit's input and
    recomputes the rest (``layers.checkpointed``, on the forward's tier);
    the sharding switch ``remat_dots`` gives that checkpoint the selective
    policy :func:`_dots_saveable`.  The tail layers and every forward
    without grad run unwrapped.  ``remat=False`` keeps every activation
    (for tests and comparisons).  The other switch that acts here,
    ``seq_parallel_residual``, constrains the residual stream's sequence
    dim onto `model` at the start of every repeat unit (off a mesh, the
    identity)."""
    pattern = pattern or cfg.block_pattern
    layers = list(_layers(cfg, pattern, stack_params, adapters))
    n_rep = (len(pattern) * tree_leaves(stack_params["repeat"])[0].shape[0]
             if stack_params.get("repeat") else 0)

    def block(kind, p, lo, h):
        return apply_block(cfg, kind, p, h, adapters=lo, positions=positions,
                           causal=causal, enc_out=enc_out)

    def unit(unit_layers, h):
        if opts.enabled("seq_parallel_residual"):
            h = constrain(h, (None, "model", None))
        aux = 0.0
        for kind, p, lo, _ in unit_layers:
            h, a = block(kind, p, lo, h)
            aux = aux + a
        return h, aux

    policy = _dots_saveable if opts.enabled("remat_dots") else None
    wrap = remat and torch.is_grad_enabled()
    aux_total = 0.0
    for i in range(0, n_rep, len(pattern)):
        fn = functools.partial(unit, layers[i:i + len(pattern)])
        x, aux = checkpointed(fn, x, policy=policy) if wrap else fn(x)
        aux_total = aux_total + aux
    for kind, p, lo, _ in layers[n_rep:]:
        x, aux = block(kind, p, lo, x)
        aux_total = aux_total + aux
    return x, aux_total


def prefill_stack(cfg, stack_params, cache, x, positions, *, adapters=None,
                  pattern=None, table=None, enc_out=None):
    """Whole-prompt forward that also fills every layer's cache in one
    pass.  Returns (x, aux_sum, cache); the cache is updated in place.
    ``table`` routes a paged cache; every layer uses the same one (each
    layer has its own pools, so the same block ids name disjoint memory).
    ``enc_out``: the encoder output whose cross K/V the ``"xattn"`` blocks
    build and cache (None keeps the cache's)."""
    pattern = pattern or cfg.block_pattern
    aux_total = 0.0
    for kind, p, lo, c in _layers(cfg, pattern, stack_params, adapters,
                                  cache):
        x, aux, _ = apply_block(cfg, kind, p, x, adapters=lo,
                                positions=positions, mode="prefill", cache=c,
                                table=table, enc_out=enc_out)
        aux_total = aux_total + aux
    return x, aux_total, cache


def decode_stack(cfg, stack_params, cache, x, pos, *, adapters=None,
                 pattern=None, table=None):
    """One-token decode through the stack.  Returns (x, cache); the cache
    is updated in place.  ``table`` as in :func:`prefill_stack`; its
    new-token slots and int32 positions are computed once here, not in
    every layer."""
    pattern = pattern or cfg.block_pattern
    pool = None if table is None else _first_pool(cache)
    if pool is not None:
        table = paged_decode_index(table, pos, pool["k_pool"].shape[-3])
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
