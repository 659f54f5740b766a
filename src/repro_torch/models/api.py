"""Public model API: ``build_model(cfg)`` -> :class:`Model` with init /
forward / loss / init_cache / prefill / decode_step.

The port of ``repro/models/api.py`` for every family of the JAX package:
dense decoders, the MoE family (qwen2-moe, granite-moe), the RG-LRU
hybrid family (recurrentgemma), the xLSTM family (``ssm``: xlstm-1.3b),
the audio encoder-decoder (whisper-medium: a bidirectional ``"attn"``
encoder over precomputed frames, the mel / conv frontend a stub as in the
JAX package, and a decoder of ``"xattn"`` blocks), the VLM (paligemma-3b:
precomputed SigLIP patches, projected by ``patch_proj`` and prepended to
the tokens; the vision tower a stub as in the JAX package) and the encoder
family (roberta-large: a bidirectional forward and the MLM loss).  As in
the JAX package the embedding is not scaled by sqrt(d_model), the head is
tied (``embed.T``) unless the config says otherwise, and the vocabulary is
padded to a multiple of 256 (``pad_vocab``).

On a model axis (``core/federated.FederatedTrainer(mesh=)``) the params are
DTensors: the vocab-sharded embedding is looked up vocab-parallel
(:func:`sharded_lookup`) and the losses run on the all-gathered logits
(``sharding/specs.full_local``).  ``forward``, ``prefill`` and
``decode_step`` also run on a base placed by ``rules.params_sharding`` over
a whole (pod, data, model) mesh, with the batch (and a decode cache placed
by ``rules.cache_sharding``) split over the batch axes, as the dry-run
traces them (``launch/dryrun.py``); per-request adapters over a sharded
base still raise.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.core.lora import as_adapter_set
from repro_torch.models.layers import apply_norm, norm_params
from repro_torch.models.transformer import (apply_stack, banked_scan_layout,
                                            batched_scan_layout,
                                            decode_stack,
                                            init_paged_stack_cache,
                                            init_stack, init_stack_cache,
                                            prefill_stack)
from repro_torch.sharding import opts
from repro_torch.sharding.specs import batch_kept, full_local, replicating
from repro_torch.tree import tree_map


def pad_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple


def sharded_lookup(embed, tokens):
    """``embed[tokens]`` for a DTensor table, replicated out but for the
    batch rows ``tokens`` (a DTensor on the table's mesh, or a plain
    tensor every device holds) splits over a batch axis.  A table sharded
    over the vocabulary (the default rule) is looked up vocab-parallel:
    each device gathers the rows of its own range, zeros the rest, and one
    all-reduce sums the (b, s, d) partials; exact, since every sum adds
    zeros to one row.  Any other layout (``embed_dshard``'s d-sharded
    table) gathers locally and all-gathers the result."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = embed.device_mesh
    tok_pl = (tuple(tokens.placements) if isinstance(tokens, DTensor)
              else None)
    kept = (batch_kept(tok_pl, mesh) if tok_pl
            else [Replicate()] * mesh.ndim)
    vocab = [i for i, p in enumerate(embed.placements) if p == Shard(0)]
    if not vocab:
        return embed[tokens].redistribute(mesh, kept)
    rows = embed.to_local().shape[0]
    lo = 0
    for i in vocab:              # vocab-major over the sharding mesh dims
        lo = lo * mesh.size(i) + mesh.get_local_rank(i)
    lo *= rows

    def local(e, tok):
        ids = tok.long() - lo
        inside = (ids >= 0) & (ids < rows)
        out = e[ids.clamp(0, rows - 1)]
        return torch.where(inside[..., None], out, out.new_zeros(()))

    out_pl = tuple(Partial() if p == Shard(0) else k
                   for p, k in zip(embed.placements, kept))
    fn = local_map(local, out_placements=(out_pl,),
                   in_placements=(tuple(embed.placements), tok_pl),
                   device_mesh=mesh)
    return fn(embed, tokens).redistribute(mesh, kept)


def _sharded_scope(params):
    """On a sharded base (DTensor params), plain tensors the model makes
    (positions, masks) meet the DTensors as replicated: every device
    computes them whole, from the global shapes."""
    if isinstance(params.get("embed"), DTensor):
        return replicating()
    return contextlib.nullcontext()


FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm", "encoder")
ENCODER_PATTERN = ("attn",)
PATCH_EMBED_DIM = 1152   # SigLIP stub output width (arXiv:2407.07726)


class Model:
    def __init__(self, cfg):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"model family '{cfg.family}' is not yet ported to "
                f"repro_torch (only {', '.join(FAMILIES)} are)")
        self.cfg = cfg
        self.vocab_padded = pad_vocab(cfg.vocab_size)

    # ----------------------------------------------------------------- params
    def init(self, generator: torch.Generator, device="cuda"):
        """Random parameters drawn from ``generator`` (on its own device,
        then placed on ``device``), in the JAX package's tree layout."""
        cfg = self.cfg
        device = resolve_device(device)
        dt = getattr(torch, cfg.param_dtype)
        gdev = generator.device
        embed = torch.randn(self.vocab_padded, cfg.d_model,
                            generator=generator, device=gdev)
        params = {"embed": (embed * cfg.d_model ** -0.5).to(dt),
                  "stack": init_stack(cfg, generator)}
        params.update(norm_params(cfg, cfg.d_model, "final", device=gdev))
        if not cfg.tie_embeddings:
            head = torch.randn(cfg.d_model, self.vocab_padded,
                               generator=generator, device=gdev)
            params["lm_head"] = (head * cfg.d_model ** -0.5).to(dt)
        if cfg.family == "audio":
            enc = {"stack": init_stack(cfg, generator,
                                       num_layers=cfg.encoder_layers,
                                       pattern=ENCODER_PATTERN)}
            enc.update(norm_params(cfg, cfg.d_model, "encfinal",
                                   device=gdev))
            params["encoder"] = enc
        if cfg.family == "vlm":
            proj = torch.randn(PATCH_EMBED_DIM, cfg.d_model,
                               generator=generator, device=gdev)
            params["patch_proj"] = (proj * PATCH_EMBED_DIM ** -0.5).to(dt)
        return tree_map(lambda t: t.to(device), params)

    # ---------------------------------------------------------------- forward
    def _embed_tokens(self, params, tokens):
        embed = params["embed"]
        x = (sharded_lookup(embed, tokens) if isinstance(embed, DTensor)
             else embed[tokens])
        return x.to(getattr(torch, self.cfg.dtype))

    def _embed(self, params, batch):
        """The stack's input for a batch: the token embeddings, after the
        projected patches (``batch["patches"]`` (b, num_patches, 1152)
        @ ``patch_proj``) for the VLM, whose batch without patches raises
        ``KeyError('patches')``, as in JAX."""
        x = self._embed_tokens(params, batch["tokens"])
        if self.cfg.family == "vlm":
            patches = (batch["patches"] @ params["patch_proj"]).to(x.dtype)
            x = torch.cat([patches, x], dim=1)
        return x

    def _encode(self, params, batch):
        """The audio encoder over ``batch["frames"]`` (b, frames, d_model):
        bidirectional ``"attn"`` blocks with no adapter, then the
        ``encfinal`` norm.  Returns the encoder output (b, frames, d)."""
        cfg = self.cfg
        enc = params["encoder"]
        h, _ = apply_stack(cfg, enc["stack"],
                           batch["frames"].to(getattr(torch, cfg.dtype)),
                           causal=False, pattern=ENCODER_PATTERN)
        return apply_norm(cfg, h, enc, "encfinal")

    def _head(self, params, x):
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return x @ head.to(x.dtype)

    @staticmethod
    def _stack_adapters(adapters):
        """An AdapterSet resolved to the prepared "stack" subtree the block
        machinery consumes: rank mask applied, gamma folded into B, banked
        per-request trees in layer-major layout."""
        if adapters is None:
            return None
        prepared = adapters.prepared()
        tree = (prepared.lora or {}).get("stack")
        if adapters.batched and tree:
            tree = (banked_scan_layout(tree, adapters.ids)
                    if adapters.ids is not None
                    else batched_scan_layout(tree))
        return tree

    @staticmethod
    def _positions(x):
        """Positions 0..s-1 of a (b, s) token or (b, s, d) activation
        tensor: for the VLM they span the patches and the text."""
        b, s = x.shape[:2]
        return torch.arange(s, device=x.device)[None, :].expand(b, s)

    def _hidden(self, params, batch, adapters):
        """The final-normed hidden states (b, s, d) of a full-sequence
        forward (s counts the VLM's patches too), and the aux loss."""
        cfg = self.cfg
        x = self._embed(params, batch)
        enc_out = (self._encode(params, batch) if cfg.family == "audio"
                   else None)
        x, aux = apply_stack(cfg, params["stack"], x,
                             adapters=self._stack_adapters(
                                 as_adapter_set(adapters)),
                             positions=self._positions(x), enc_out=enc_out,
                             causal=cfg.family != "encoder")
        return apply_norm(cfg, x, params, "final"), aux

    def forward(self, params, batch, adapters=None):
        """Full-sequence forward: ``batch["tokens"]`` (b, s) -> (logits
        (b, s', V), aux).  ``adapters``: None, an AdapterSet, or a banked
        per-request set.  The audio family also reads ``batch["frames"]``
        (b, frames, d_model) and runs the encoder over them (a batch
        without frames raises ``KeyError('frames')``, as in JAX); the VLM
        reads ``batch["patches"]`` (b, num_patches, 1152), and s' = s +
        num_patches.  The encoder family attends both ways; every other
        family (the VLM's patch prefix too) attends causally."""
        with _sharded_scope(params):
            x, aux = self._hidden(params, batch, adapters)
            return self._head(params, x), aux

    def loss(self, params, batch, adapters=None):
        """Returns (loss, {"ce", "aux"}), as the JAX package does; the
        gradient takes both terms, and every logsumexp runs in fp32 over
        the padded vocabulary.  ``adapters``: None or an AdapterSet;
        gradients reach its A/B leaves through the LoRA matmul Function.

        The encoder family: the MLM loss.  The positions with ``s % 5 ==
        2`` are masked (their input replaced by the padded vocabulary's
        last row, ``vocab_padded - 1``), and the CE at those positions is
        divided by (masked positions) x b.  Every other family: next-token
        CE over the text segment (the VLM's patch positions predict
        nothing), + the aux loss (the MoE router's, summed over layers; 0
        for every other block); with the ``chunked_ce`` switch of
        :mod:`repro_torch.sharding.opts` on, :meth:`_loss_chunked`."""
        if self.cfg.family == "encoder":
            return self._loss_mlm(params, batch, adapters)
        if opts.enabled("chunked_ce"):
            return self._loss_chunked(params, batch, adapters)
        tokens = batch["tokens"]
        logits, aux = self.forward(params, batch, adapters=adapters)
        s_text = tokens.shape[1]
        lf = full_local(logits)[:, -s_text:][:, :-1].float()
        labels = tokens[:, 1:].long()
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels[..., None])[..., 0]
        ce = (lse - ll).mean()
        aux = full_local(aux)
        return ce + aux, {"ce": ce, "aux": aux}

    def _loss_mlm(self, params, batch, adapters):
        tokens = batch["tokens"]
        b, s = tokens.shape
        masked = torch.arange(s, device=tokens.device) % 5 == 2
        inp = torch.where(masked[None, :],
                          torch.full_like(tokens, self.vocab_padded - 1),
                          tokens)
        logits, aux = self.forward(params, {**batch, "tokens": inp},
                                   adapters=adapters)
        lf = full_local(logits).float()
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, tokens.long()[..., None])[..., 0]
        ce = ((lse - ll) * masked[None, :]).sum() / (masked.sum() * b)
        aux = full_local(aux)
        return ce + aux, {"ce": ce, "aux": aux}

    def _loss_chunked(self, params, batch, adapters, chunk: int = 512):
        """The next-token CE in sequence chunks: the head matmul, the fp32
        logsumexp and the label gather run chunk by chunk over the text's
        predicting positions (padded to a multiple of ``min(chunk, s_text
        - 1)``; a padded position adds exactly 0), each chunk under
        activation checkpointing, so no (b, s, V) logits tensor exists, in
        the forward or saved for the backward (each chunk's logits are
        recomputed there).  Divided by b x (s_text - 1), as the plain
        loss's mean."""
        tokens = batch["tokens"]
        x, aux = self._hidden(params, batch, adapters)
        s_text = tokens.shape[1]
        x = x[:, -s_text:][:, :-1]                    # predicting positions
        labels = tokens[:, 1:].long()
        b, sl = labels.shape
        c = min(chunk, sl)
        pad = (-sl) % c
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        valid = torch.arange(sl + pad, device=x.device) < sl

        def chunk_ce(xb, lb, vb):
            logits = full_local(self._head(params, xb)).float()
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, lb[..., None])[..., 0]
            return ((lse - ll) * vb).sum()

        # a plain scalar: each chunk's sum is a plain tensor on a model
        # axis too (``full_local``), and a DTensor total would hand it a
        # DTensor gradient
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, sl + pad, c):
            tot = tot + checkpoint(chunk_ce, x[:, i:i + c],
                                   labels[:, i:i + c], valid[i:i + c],
                                   use_reentrant=False)
        ce = tot / (b * sl)
        aux = full_local(aux)
        return ce + aux, {"ce": ce, "aux": aux}

    # ---------------------------------------------------------------- serving
    def _cross_len(self) -> int:
        """Encoder frames the cross K/V of a cache hold (0 but for audio)."""
        return self.cfg.encoder_frames if self.cfg.family == "audio" else 0

    def init_cache(self, batch: int, max_len: int, dtype=None, *,
                   device="cuda"):
        dtype = dtype or getattr(torch, self.cfg.dtype)
        return init_stack_cache(self.cfg, batch, max_len, dtype,
                                device=resolve_device(device),
                                cross_len=self._cross_len())

    def init_paged_cache(self, num_blocks: int, block_size: int, batch: int,
                         dtype=None, *, device="cuda"):
        """Paged serving cache: per-layer KV pools of ``num_blocks`` x
        ``block_size`` slots, shared by every request through per-request
        block tables, plus per-slot recurrent and cross state for ``batch``
        engine slots.  Block 0 is reserved as the null block idle slots
        write into (see ``launch/serve.BlockPool``)."""
        dtype = dtype or getattr(torch, self.cfg.dtype)
        return init_paged_stack_cache(self.cfg, num_blocks, block_size,
                                      batch, dtype,
                                      device=resolve_device(device),
                                      cross_len=self._cross_len())

    def prefill(self, params, cache, tokens, adapters=None, *, enc_out=None,
                last_only=False, table=None):
        """Whole-prompt forward that fills a fresh cache in one pass:
        tokens (b, p) -> (logits (b, p, V), cache).  ``last_only=True``
        projects only the last position through the head (logits
        (b, 1, V)).  The cache is left as ``p`` decode steps would leave it
        (updated in place and returned).  An encoder-decoder (audio) model
        takes the encoder output (:meth:`_encode`) as ``enc_out``, and
        every layer's cross K/V land in the cache; without it the cache's
        own are kept (zeros in a fresh cache).  A paged cache
        (:meth:`init_paged_cache`) also needs the requests' block ``table``
        (b, blocks_per_req) int32.  Serving reads tokens only, as in the
        JAX package: the VLM's prefill takes no patches, and the encoder
        family is served as a causal decoder."""
        cfg = self.cfg
        with _sharded_scope(params):
            x = self._embed_tokens(params, tokens)
            x, _, cache = prefill_stack(
                cfg, params["stack"], cache, x, self._positions(tokens),
                adapters=self._stack_adapters(as_adapter_set(adapters)),
                table=table, enc_out=enc_out)
            x = apply_norm(cfg, x, params, "final")
            if last_only:
                x = x[:, -1:]
            return self._head(params, x), cache

    def decode_step(self, params, cache, token, pos, adapters=None, *,
                    table=None):
        """One token: token (b, 1), pos (b,) absolute positions.  Returns
        (logits (b, 1, V), cache); the cache is updated in place.  A paged
        cache also needs the requests' block ``table`` (b, blocks_per_req)
        int32."""
        cfg = self.cfg
        with _sharded_scope(params):
            x = self._embed_tokens(params, token)
            x, cache = decode_stack(
                cfg, params["stack"], cache, x, pos,
                adapters=self._stack_adapters(as_adapter_set(adapters)),
                table=table)
            x = apply_norm(cfg, x, params, "final")
            return self._head(params, x), cache


    # ------------------------------------------------------------- specs
    def input_specs(self, shape, *, n_clients: int = 0):
        """Meta tensors (shapes and dtypes, no data) for every model input
        of an :class:`~repro_torch.configs.base.InputShape`, as the JAX
        package's ``ShapeDtypeStruct`` stand-ins.

        For train shapes with ``n_clients`` > 0 the batch gets a leading
        client dim (global_batch = n_clients * per_client).  Modality
        frontends are stubs: precomputed frame / patch embeddings of the
        right shape (the VLM's tokens are shortened by its patches).  A
        decode shape gives ``token`` (b, 1), ``pos`` (b,) and the ring
        cache of ``seq_len`` positions (:meth:`init_cache` on meta)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        i32 = torch.int32

        def sds(shp, dtype_):
            return torch.empty(shp, dtype=dtype_, device="meta")

        def batch_spec(b, s):
            d = {"tokens": sds((b, s), i32)}
            if cfg.family == "vlm":
                d["tokens"] = sds((b, s - cfg.num_patches), i32)
                d["patches"] = sds((b, cfg.num_patches, PATCH_EMBED_DIM), dt)
            if cfg.family == "audio":
                d["frames"] = sds((b, cfg.encoder_frames, cfg.d_model), dt)
            return d

        if shape.kind == "train":
            b, s = shape.global_batch, shape.seq_len
            if n_clients:
                spec = batch_spec(b // n_clients, s)
                return {k: sds((n_clients,) + tuple(v.shape), v.dtype)
                        for k, v in spec.items()}
            return batch_spec(b, s)
        if shape.kind == "prefill":
            return batch_spec(shape.global_batch, shape.seq_len)
        b = shape.global_batch
        return {"token": sds((b, 1), i32), "pos": sds((b,), i32),
                "cache": self.init_cache(b, shape.seq_len, dtype=dt,
                                         device="meta")}


def build_model(cfg) -> Model:
    return Model(cfg)
