"""GQA/MQA attention: full-sequence, prompt prefill and one-token decode
against a ring-buffer KV cache or a paged KV pool.

The port of the dense path of ``repro/models/attention.py``.  Scores and
softmax run in fp32; masked scores are set to ``-1e30`` (not ``-inf``), so
a fully masked row gives a uniform softmax, as in the JAX package.

Caches are updated in place (the JAX functions return a new cache): a
decode step writes one slot per request instead of copying the cache.  The
updated cache is also returned, so callers read like the JAX code.

Two sharding switches act here (``sharding/opts.py``): ``expand_kv``
repeats the KV heads to the full head count before full-sequence and
prefill attention (after the cache is filled) and constrains the head dim
onto `model`; ``seq_parallel_attn`` constrains the query positions of a
blocked attention onto `model` when the heads do not divide 16.  Off a
mesh both leave the numbers as they are.

On DTensors (a mesh) the attention math runs on each device's local
pieces through ``local_map`` (:func:`attention_core`, :func:`_attend`):
batch rows, heads and query positions split with no exchange, and
``blockwise_attention`` loops over plain local blocks.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import dispatch
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models.layers import (apply_rope, checkpointed, linear,
                                       rms_norm)
from repro_torch.sharding import opts
from repro_torch.sharding.specs import constrain, merge_heads, split_heads

NEG_INF = -1e30


def attn_params(cfg, generator, *, lead=(), d_model=None):
    """q/k/v/o projection weights drawn from ``generator``; ``lead``
    prepends stacked layer dims."""
    d = d_model or cfg.d_model
    dt = getattr(torch, cfg.param_dtype)

    def draw(shape, scale):
        w = torch.randn(tuple(lead) + shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        return (w * scale).to(dt)

    p = {"q": draw((d, cfg.q_dim), d ** -0.5),
         "k": draw((d, cfg.kv_dim), d ** -0.5),
         "v": draw((d, cfg.kv_dim), d ** -0.5),
         "o": draw((cfg.q_dim, d), cfg.q_dim ** -0.5)}
    if cfg.qk_norm:
        for name in ("q_norm_scale", "k_norm_scale"):
            p[name] = torch.ones(tuple(lead) + (cfg.head_dim,), dtype=dt,
                                 device=generator.device)
    return p


def _project_qkv(cfg, params, x, adapters=None, positions=None,
                 kv_positions=None, use_rope=True):
    """q (b,s,h,hd), k/v (b,s,kh,hd) with RoPE and qk-norm applied."""
    s = x.shape[1]
    adapters = adapters or {}
    q = split_heads(linear(x, params["q"], adapters.get("q")),
                    cfg.num_heads, cfg.head_dim)
    k = split_heads(linear(x, params["k"], adapters.get("k")),
                    cfg.num_kv_heads, cfg.head_dim)
    v = split_heads(linear(x, params["v"], adapters.get("v")),
                    cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm_scale"])
        k = rms_norm(k, params["k_norm_scale"])
    if use_rope:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        if kv_positions is None:
            kv_positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def _maybe_expand_kv(q, k, v):
    """Under ``expand_kv``: repeat the KV heads to the full head count and
    constrain the head dim onto `model`, so attention shards by head
    instead of computing (partly) replicated when kv_heads is below the
    axis size.  Each query head meets the same K/V values as in the
    grouped layout."""
    if not opts.enabled("expand_kv"):
        return q, k, v
    h, kh = q.shape[2], k.shape[2]
    if kh != h:
        k = k.repeat_interleave(h // kh, dim=2)
        v = v.repeat_interleave(h // kh, dim=2)
    spec = (("pod", "data"), None, "model", None)
    return constrain(q, spec), constrain(k, spec), constrain(v, spec)


def _align_heads(q, k, v):
    """The grouped layout (kh, h // kh) of q's heads cannot keep a split
    of q's heads over a mesh dim whose size does not divide the KV heads
    (32 heads, 8 KV heads, a 16-wide model axis): there the KV heads are
    repeated to h where q is the larger operand (full-sequence
    attention), else q's heads are gathered (decode: one query token
    against a long cache).  Each query head meets the same K/V values
    either way; plain tensors pass as they are."""
    h, kh = q.shape[2], k.shape[2]
    if not isinstance(q, DTensor) or kh == h:
        return q, k, v
    mesh = q.device_mesh
    bad = [i for i, p in enumerate(q.placements)
           if p == Shard(2) and kh % mesh.size(i)]
    if not bad:
        return q, k, v
    if q.numel() >= k.numel():
        return (q, k.repeat_interleave(h // kh, dim=2),
                v.repeat_interleave(h // kh, dim=2))
    pl = [Replicate() if i in bad else p for i, p in enumerate(q.placements)]
    return q.redistribute(mesh, pl), k, v


# what each operand holds along a mesh dim, by the attention's split
# there: batch rows, heads (KV-head blocks and their query groups), the
# head dim (partial scores), or query positions (``seq_parallel_attn``)
_SPLIT = {"q": {"batch": 0, "heads": 2, "dim": 3, "query": 1},
          "kv": {"batch": 0, "heads": 2, "dim": 3},
          "rows": {"batch": 0, "query": 1},        # a mask, query positions
          "cols": {"batch": 0},                    # key positions
          "scores": {"batch": 0, "heads": 1, "query": 3}}


def _roles(q, k, *, dim_split=True):
    """Per mesh dim, how attention over DTensors q (b, s, h, hd) and k
    (b, t, kh, hd) splits there: by batch rows, by heads, by the head dim
    (``dim_split``: partial scores summed across the axis; else
    gathered), by query positions, or not at all (a split of the keys'
    positions, the slots of a cache too small in batch, is gathered)."""
    roles = []
    for pq, pk in zip(q.placements, k.placements):
        if Shard(0) in (pq, pk):
            roles.append("batch")
        elif Shard(2) in (pq, pk):
            roles.append("heads")
        elif pk == Shard(3) and dim_split:
            roles.append("dim")
        elif pq == Shard(1) and pk != Shard(1):
            roles.append("query")
        else:
            roles.append(None)
    return roles


def _placed(t, mesh, roles, kind):
    """``t`` (a DTensor, or a plain tensor every device holds whole) as a
    DTensor split by ``roles`` the way operand ``kind`` is."""
    split = _SPLIT[kind]
    return dispatch._as_dtensor(t, mesh).redistribute(
        mesh, [Shard(split[r]) if r in split else Replicate()
               for r in roles])


def _local(fn, args, kinds, out_kind, roles, mesh):
    """``fn`` on each device's local pieces of ``args`` (placed by
    ``roles`` as ``kinds`` say: a partial sum of scores is summed here),
    through ``local_map``; the output split as ``out_kind`` (partial over
    a head-dim split, for scores)."""
    from torch.distributed.tensor.experimental import local_map
    placed = [_placed(a, mesh, roles, kind) for a, kind in zip(args, kinds)]
    pls = [tuple(a.placements) for a in placed]
    split = _SPLIT[out_kind]
    out_pl = tuple(Partial() if r == "dim" and out_kind == "scores" else
                   Shard(split[r]) if r in split else Replicate()
                   for r in roles)
    def dense(*local):
        # contiguous pieces both ways: DTensor views a piece by its global
        # strides, which a permuted einsum result or gradient lacks
        return fn(*(_Dense.apply(t) for t in local)).contiguous()
    return local_map(dense, out_placements=(out_pl,),
                     in_placements=tuple(pls), in_grad_placements=tuple(pls),
                     device_mesh=mesh, redistribute_inputs=True)(*placed)


class _Dense(torch.autograd.Function):
    """Identity forward; the gradient comes back contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _scores(q, k):
    """(b, kh, g, s, t) fp32 q . k over the head dim, unscaled."""
    b, s, h, hd = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())


def _weighted(cfg, scores, mask, v, hd, dtype):
    """Scale, softcap and mask the scores, softmax over the keys, and
    weight v: (b, s, h, v's head dim) in ``dtype``."""
    scores = scores * (hd ** -0.5)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        scores = c * torch.tanh(scores / c)
    scores = torch.where(mask[:, None, None, :, :], scores,
                         scores.new_full((), NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    b, s = out.shape[:2]
    return out.reshape(b, s, -1, out.shape[-1]).to(dtype)


def attention_core(cfg, q, k, v, mask):
    """q (b,s,h,hd), k/v (b,t,kh,hd), mask (b,s,t) bool.

    On DTensors the computation runs on each device's pieces
    (:func:`_roles`): a split of batch rows, heads or query positions
    needs no exchange; a split of the head dim (a cache sharded there)
    sums partial scores across its axis (one all-reduce of the scores);
    a split of the keys' positions is gathered first."""
    q, k, v = _align_heads(q, k, v)
    hd, dtype = q.shape[-1], q.dtype
    if not (isinstance(q, DTensor) or isinstance(k, DTensor)):
        return _weighted(cfg, _scores(q, k), mask, v, hd, dtype)
    mesh = (q if isinstance(q, DTensor) else k).device_mesh
    q, k = (dispatch._as_dtensor(t, mesh) for t in (q, k))
    roles = _roles(q, k)
    if "dim" not in roles:
        return _local(lambda ql, kl, vl, ml: _weighted(
            cfg, _scores(ql, kl), ml, vl, hd, dtype),
            (q, k, v, mask), ("q", "kv", "kv", "rows"), "q", roles, mesh)
    sc = _local(_scores, (q, k), ("q", "kv"), "scores", roles, mesh)
    return _local(lambda scl, ml, vl: _weighted(cfg, scl, ml, vl, hd, dtype),
                  (sc, mask, v), ("scores", "rows", "kv"), "q", roles, mesh)


def make_mask(positions_q, positions_kv, *, causal: bool, window=None,
              valid_kv=None):
    """(b, s_q, s_kv) boolean mask.  Built out of place, so positions
    that are DTensors (a sharded cache's) give a DTensor mask."""
    pq = positions_q[:, :, None]
    pk = positions_kv[:, None, :]
    shape = torch.broadcast_shapes(pq.shape, pk.shape)
    terms = []
    if causal:
        terms.append(pk <= pq)
    if window is not None:
        terms.append(pq - pk < window)
    if valid_kv is not None:
        terms.append(valid_kv[:, None, :])
    if not terms:
        return torch.ones(shape, dtype=torch.bool, device=pq.device)
    m = terms[0]
    for t in terms[1:]:
        m = m & t
    return m.expand(shape)


BLOCKWISE_THRESHOLD = 2048   # blocked attention above this many positions
Q_BLOCK = 1024
KV_BLOCK = 1024


def blockwise_attention(cfg, q, k, v, positions_q, positions_kv, *, causal,
                        window, q_block=Q_BLOCK, kv_block=KV_BLOCK):
    """Flash-style attention in plain PyTorch: loops over q blocks and, in
    each, over kv blocks carrying (acc, m, l), so the (s, t) score matrix
    never exists whole.  A row with no visible key comes out zero, as in
    ``repro/models/attention.py:blockwise_attention``.  While autograd
    records, each kv step runs under a checkpoint (``jax.checkpoint(kv_step)``
    in JAX): the backward keeps the carries and the step's q / kv blocks,
    O(s hd), and recomputes the block's scores."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()

    def kv_step(acc, m, l, qb, kb, vb, pq, pk):
        sc = torch.einsum("bqkgd,btkd->bkgqt", qb, kb) * scale
        if cfg.attn_logit_softcap:
            c = cfg.attn_logit_softcap
            sc = c * torch.tanh(sc / c)
        msk = make_mask(pq, pk, causal=causal, window=window)
        sc = torch.where(msk[:, None, None], sc, sc.new_full((), NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.where(sc <= NEG_INF / 2, sc.new_zeros(()),
                        torch.exp(sc - m_new[..., None]))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p, vb)
        return acc, m_new, l

    remat = torch.is_grad_enabled()
    out = torch.empty(b, s, h, hd, dtype=torch.float32, device=q.device)
    for q0 in range(0, s, q_block):
        qb = q[:, q0:q0 + q_block].float()
        nq = qb.shape[1]
        qb = qb.reshape(b, nq, kh, g, hd)
        pq = positions_q[:, q0:q0 + q_block]
        acc = torch.zeros(b, kh, g, nq, hd, device=q.device)
        m = torch.full((b, kh, g, nq), NEG_INF, device=q.device)
        l = torch.zeros(b, kh, g, nq, device=q.device)
        for t0 in range(0, t, kv_block):
            args = (acc, m, l, qb, kf[:, t0:t0 + kv_block],
                    vf[:, t0:t0 + kv_block], pq,
                    positions_kv[:, t0:t0 + kv_block])
            acc, m, l = (checkpointed(kv_step, *args) if remat
                         else kv_step(*args))
        o = acc / l.clamp_min(1e-30)[..., None]
        out[:, q0:q0 + nq] = o.permute(0, 3, 1, 2, 4).reshape(b, nq, h, hd)
    return out.to(q.dtype)


def _attend(cfg, q, k, v, positions_q, positions_kv, *, causal, window):
    if max(q.shape[1], k.shape[1]) > BLOCKWISE_THRESHOLD:
        if isinstance(q, DTensor):
            # each device's pieces (batch rows, heads, query positions;
            # see attention_core), the blocks on plain local tensors
            q, k, v = _align_heads(q, k, v)
            if opts.enabled("seq_parallel_attn") and q.shape[2] % 16 != 0:
                # context parallelism: query positions over `model` when
                # the heads cannot divide the axis (8-head archs)
                q = constrain(q, (None, "model", None, None))
            mesh = q.device_mesh
            roles = _roles(q, k, dim_split=False)
            return _local(lambda ql, kl, vl, pq, pk: blockwise_attention(
                cfg, ql, kl, vl, pq, pk, causal=causal, window=window),
                (q, k, v, positions_q, positions_kv),
                ("q", "kv", "kv", "rows", "cols"), "q", roles, mesh)
        return blockwise_attention(cfg, q, k, v, positions_q, positions_kv,
                                   causal=causal, window=window)
    mask = make_mask(positions_q, positions_kv, causal=causal, window=window)
    return attention_core(cfg, q, k, v, mask)


def attention_fullseq(cfg, params, x, *, causal=True, adapters=None,
                      positions=None):
    """Full-sequence self-attention (forward over whole sequences)."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    q, k, v = _project_qkv(cfg, params, x, adapters=adapters,
                           positions=positions, kv_positions=positions)
    q, k, v = _maybe_expand_kv(q, k, v)
    out = _attend(cfg, q, k, v, positions, positions, causal=causal,
                  window=cfg.attn_window if causal else None)
    return linear(merge_heads(out), params["o"],
                  (adapters or {}).get("o"))


# ------------------------------------------------------------- ring KV cache

def init_kv_cache(cfg, batch: int, max_len: int, dtype, *, device):
    """Per-layer cache: a ring buffer of ``min(max_len, window)`` slots;
    ``pos`` -1 marks an empty slot."""
    size = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, size), -1, dtype=torch.int32,
                              device=device)}


def fill_kv_cache(cache, k, v, positions):
    """Write a whole prompt's K/V rows into the ring at the slots the
    token-by-token decode would have used (``pos % size``).  When the
    prompt is longer than the ring, only the last ``size`` positions land:
    the survivors of sequential ring writes.  In place; returns ``cache``."""
    size = cache["k"].shape[1]
    if k.shape[1] > size:
        k, v, positions = k[:, -size:], v[:, -size:], positions[:, -size:]
    slots = positions % size
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    cache["k"][bidx, slots] = k.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v.to(cache["v"].dtype)
    cache["pos"][bidx, slots] = positions.to(torch.int32)
    return cache


def attention_prefill(cfg, params, x, cache, positions, *, adapters=None):
    """Whole-prompt attention that also fills a fresh KV cache, as running
    :func:`attention_decode` once per prompt token would.  x (b, s, d),
    positions (b, s).  Returns (out, cache)."""
    q, k, v = _project_qkv(cfg, params, x, adapters=adapters,
                           positions=positions, kv_positions=positions)
    fill_kv_cache(cache, k, v, positions)
    q, k, v = _maybe_expand_kv(q, k, v)
    out = _attend(cfg, q, k, v, positions, positions, causal=True,
                  window=cfg.attn_window)
    y = linear(merge_heads(out), params["o"], (adapters or {}).get("o"))
    return y, cache


def write_ring(buf, slot, val):
    """``buf[i, slot[i]] = val[i]`` for every row i, in place: one new
    entry per request into a ring buffer ``buf`` (b, S, ...), ``slot``
    (b,), ``val`` (b, ...).

    A DTensor ``buf`` (a cache placed by ``rules.cache_sharding``) is
    written shard by shard, with no communication: ``val`` and ``slot``
    are cut to the buffer's placements (a row split over a batch axis, a
    head or head-dim split over "model"), and where the ring's slots are
    split over an axis (a batch too small to split), each device writes
    the rows whose slot falls in its own range and rewrites its old entry
    elsewhere (a select, not a data-dependent index)."""
    if not isinstance(buf, DTensor):
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, slot] = val.to(buf.dtype)
        return buf
    mesh = buf.device_mesh
    pl = buf.placements

    def cut(t, placements):
        return dispatch._as_dtensor(t, mesh).redistribute(
            mesh, placements).to_local()
    v = cut(val, [Shard(p.dim - 1) if isinstance(p, Shard) and p.dim >= 2
                  else (p if p == Shard(0) else Replicate()) for p in pl])
    sl = cut(slot, [p if p == Shard(0) else Replicate() for p in pl])
    local = buf.to_local()
    size = local.shape[1]
    lo = 0
    for i, p in enumerate(pl):           # pod-major over the slot axes
        if p == Shard(1):
            lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    rows = torch.arange(local.shape[0], device=local.device)
    v = v.to(local.dtype)
    if all(p != Shard(1) for p in pl):
        local[rows, sl] = v
        return buf
    idx = sl.long() - lo * size
    inside = ((idx >= 0) & (idx < size)).reshape((-1,) + (1,) * (v.ndim - 1))
    idx = idx.clamp(0, size - 1)
    local[rows, idx] = torch.where(inside, v, local[rows, idx])
    return buf


def attention_decode(cfg, params, x, cache, pos, *, adapters=None):
    """One-token decode.  x (b,1,d); pos (b,) absolute positions.
    Returns (out (b,1,d), cache).  A cache of DTensors (placed by
    ``rules.cache_sharding``) is written shard by shard
    (:func:`write_ring`)."""
    size = cache["k"].shape[1]
    q, k, v = _project_qkv(cfg, params, x, adapters=adapters,
                           positions=pos[:, None], kv_positions=pos[:, None])
    slot = pos % size
    write_ring(cache["k"], slot, k[:, 0])
    write_ring(cache["v"], slot, v[:, 0])
    write_ring(cache["pos"], slot, pos.to(torch.int32))
    mask = make_mask(pos[:, None], cache["pos"], causal=True,
                     window=cfg.attn_window, valid_kv=cache["pos"] >= 0)
    out = attention_core(cfg, q, cache["k"], cache["v"], mask)
    y = linear(merge_heads(out), params["o"], (adapters or {}).get("o"))
    return y, cache


# ----------------------------------------------------------------- paged KV
#
# The paged layout replaces the per-request ring buffer (batch, size, kh, hd)
# with a SHARED block pool (num_blocks, block_size, kh, hd) plus a per-request
# block table (b, blocks_per_req) int32 mapping virtual block j of request i
# to a pool block.  A request's view of the pool is a virtual ring of
# vlen = blocks_per_req * block_size slots: the token at absolute position p
# lands in virtual slot p % vlen, i.e. pool block table[i, (p % vlen) //
# block_size] at offset (p % vlen) % block_size.  That is the ring formula
# with vlen in place of size, so gathering a request's blocks back into
# (b, vlen, kh, hd) reproduces the ring layout element for element: when
# block_size divides the ring size the paged decode on the plain tier is
# bit-identical to the ring decode (tests/test_torch_paged.py).
#
# Block 0 is the NULL block: the scheduler points idle batch slots' table
# rows at it, so their (discarded) decode writes land in a block no live
# request ever owns.  The pos pool doubles as the validity mask (entry >= 0
# == written), exactly like the ring cache's pos array.
#
# As with the ring cache, the pools are updated in place and returned.


def init_paged_kv_cache(cfg, num_blocks: int, block_size: int, dtype, *,
                        device):
    """Per-layer shared pool.  How many blocks a request owns is the block
    TABLE's width, not a pool property."""
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return {"k_pool": torch.zeros(shape, dtype=dtype, device=device),
            "v_pool": torch.zeros(shape, dtype=dtype, device=device),
            "pos_pool": torch.full((num_blocks, block_size), -1,
                                   dtype=torch.int32, device=device)}


def paged_gather(cache, table):
    """Each request's virtual ring view of the pool: (k (b, vlen, kh, hd),
    v (b, vlen, kh, hd), pos (b, vlen))."""
    b, mb = table.shape
    bs, kh, hd = cache["k_pool"].shape[1:]
    idx = table.long()
    k = cache["k_pool"][idx].reshape(b, mb * bs, kh, hd)
    v = cache["v_pool"][idx].reshape(b, mb * bs, kh, hd)
    pos = cache["pos_pool"][idx].reshape(b, mb * bs)
    return k, v, pos


def _paged_slots(table, positions, bs):
    """(pool block, offset) of each position's virtual-ring slot."""
    vslot = positions.long() % (table.shape[1] * bs)
    blk = torch.gather(table.long(), 1, vslot // bs)
    return blk, vslot % bs


class PagedDecode(NamedTuple):
    """One decode step's paged operands, the same for every layer (each
    layer has its own pools, so the same block ids name disjoint memory):
    the block ``table`` (b, blocks_per_req) int32, each request's new-token
    pool block ``blk`` (b,) and ``off``-set (b,), and ``qpos`` (b,) int32,
    the query position kernel #13 takes.  Built once per step by
    :func:`paged_decode_index`."""
    table: torch.Tensor
    blk: torch.Tensor
    off: torch.Tensor
    qpos: torch.Tensor


def paged_decode_index(table, pos, block_size: int) -> PagedDecode:
    """The :class:`PagedDecode` of a step at absolute positions ``pos``
    (b,)."""
    blk, off = _paged_slots(table, pos[:, None], block_size)
    return PagedDecode(table, blk[:, 0], off[:, 0], pos.to(torch.int32))


def fill_paged_kv_cache(cache, k, v, positions, table):
    """Paged counterpart of :func:`fill_kv_cache`: write a whole prompt's
    K/V rows into each request's pool blocks at the virtual-ring slots the
    token-by-token decode would have used.  On overflow only the last
    ``vlen`` positions land, the survivors of sequential ring writes.  In
    place; returns ``cache``."""
    bs = cache["k_pool"].shape[1]
    vlen = table.shape[1] * bs
    if k.shape[1] > vlen:
        k, v, positions = k[:, -vlen:], v[:, -vlen:], positions[:, -vlen:]
    blk, off = _paged_slots(table, positions, bs)
    cache["k_pool"][blk, off] = k.to(cache["k_pool"].dtype)
    cache["v_pool"][blk, off] = v.to(cache["v_pool"].dtype)
    cache["pos_pool"][blk, off] = positions.to(torch.int32)
    return cache


def attention_prefill_paged(cfg, params, x, cache, positions, table, *,
                            adapters=None):
    """Whole-prompt attention that fills the requests' POOL blocks.  The
    attention itself is over the prompt's own K/V (the arithmetic of
    :func:`attention_prefill`); only the cache writes differ."""
    q, k, v = _project_qkv(cfg, params, x, adapters=adapters,
                           positions=positions, kv_positions=positions)
    fill_paged_kv_cache(cache, k, v, positions, table)
    q, k, v = _maybe_expand_kv(q, k, v)
    out = _attend(cfg, q, k, v, positions, positions, causal=True,
                  window=cfg.attn_window)
    y = linear(merge_heads(out), params["o"], (adapters or {}).get("o"))
    return y, cache


def attention_decode_paged(cfg, params, x, cache, step, pos, *,
                           adapters=None):
    """One-token decode against the block pool.  x (b, 1, d); ``step`` the
    step's :class:`PagedDecode` (built once for all layers); pos (b,)
    absolute positions.  Returns (out (b, 1, d), cache); the pools are
    updated in place.

    On the CPU, and on CUDA under ``dispatch.plain_tier()``, the request's
    blocks are gathered back into the ring layout and the ring's mask and
    attention run on them (the JAX reference tier's expression, which keeps
    scheduled tokens bit-identical to the fixed-batch engine).  On CUDA,
    kernel #13 (``kernels/paged_attention.py``) streams the pool blocks
    through the table and never materializes the gather."""
    q, k, v = _project_qkv(cfg, params, x, adapters=adapters,
                           positions=pos[:, None], kv_positions=pos[:, None])
    blk, off = step.blk, step.off
    cache["k_pool"][blk, off] = k[:, 0].to(cache["k_pool"].dtype)
    cache["v_pool"][blk, off] = v[:, 0].to(cache["v_pool"].dtype)
    cache["pos_pool"][blk, off] = step.qpos
    if dispatch._use_kernel(x):
        dispatch.stats["paged"] += 1
        out = paged_attention(
            q[:, 0].contiguous(), cache["k_pool"], cache["v_pool"],
            cache["pos_pool"], step.table, step.qpos,
            window=cfg.attn_window,
            softcap=cfg.attn_logit_softcap)[:, None]
    else:
        kg, vg, pg = paged_gather(cache, step.table)
        mask = make_mask(pos[:, None], pg, causal=True,
                         window=cfg.attn_window, valid_kv=pg >= 0)
        out = attention_core(cfg, q, kg, vg, mask)
    y = linear(merge_heads(out), params["o"], (adapters or {}).get("o"))
    return y, cache
