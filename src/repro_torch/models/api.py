"""Public model API: ``build_model(cfg)`` -> :class:`Model` with init /
forward / loss / init_cache / prefill / decode_step.

The port of ``repro/models/api.py`` for dense decoders, the MoE family
(qwen2-moe, granite-moe), the RG-LRU hybrid family (recurrentgemma), the
xLSTM family (``ssm``: xlstm-1.3b) and the audio encoder-decoder
(whisper-medium: a bidirectional ``"attn"`` encoder over precomputed
frames, the mel / conv frontend a stub as in the JAX package, and a
decoder of ``"xattn"`` blocks).  As in the JAX package the embedding is
not scaled by sqrt(d_model), the head is tied (``embed.T``) unless the
config says otherwise, and the vocabulary is padded to a multiple of 256
(``pad_vocab``).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core.lora import as_adapter_set
from repro_torch.models.layers import apply_norm, norm_params
from repro_torch.models.transformer import (apply_stack, banked_scan_layout,
                                            batched_scan_layout,
                                            decode_stack,
                                            init_paged_stack_cache,
                                            init_stack, init_stack_cache,
                                            prefill_stack)
from repro_torch.tree import tree_map


def pad_vocab(v: int, multiple: int = 256) -> int:
    return -(-v // multiple) * multiple


FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio")
ENCODER_PATTERN = ("attn",)


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
        return tree_map(lambda t: t.to(device), params)

    # ---------------------------------------------------------------- forward
    def _embed(self, params, tokens):
        return params["embed"][tokens].to(getattr(torch, self.cfg.dtype))

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
    def _positions(tokens):
        b, s = tokens.shape
        return torch.arange(s, device=tokens.device)[None, :].expand(b, s)

    def forward(self, params, batch, adapters=None):
        """Full-sequence forward: ``batch["tokens"]`` (b, s) -> (logits
        (b, s, V), aux).  ``adapters``: None, an AdapterSet, or a banked
        per-request set.  The audio family also reads ``batch["frames"]``
        (b, frames, d_model) and runs the encoder over them (a batch
        without frames raises ``KeyError('frames')``, as in JAX)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        enc_out = (self._encode(params, batch) if cfg.family == "audio"
                   else None)
        x, aux = apply_stack(cfg, params["stack"], x,
                             adapters=self._stack_adapters(
                                 as_adapter_set(adapters)),
                             positions=self._positions(tokens),
                             enc_out=enc_out)
        x = apply_norm(cfg, x, params, "final")
        return self._head(params, x), aux

    def loss(self, params, batch, adapters=None, *, chunked_ce=False):
        """Next-token cross-entropy over the text segment (+ the aux loss:
        the MoE router's, summed over layers, 0 for the dense, RG-LRU
        and xLSTM blocks): returns (loss, {"ce", "aux"}), as the JAX package's
        decoder branch does; the gradient takes both terms.  The logsumexp runs in fp32 over the
        padded vocabulary.  ``adapters``: None or an AdapterSet; gradients
        reach its A/B leaves through the LoRA matmul Function.

        The JAX package's sequence-chunked CE (``opts "chunked_ce"``) is not
        ported yet; the encoder MLM loss waits with the encoder family."""
        if chunked_ce:
            raise NotImplementedError(
                "the chunked cross-entropy is not yet ported to repro_torch")
        tokens = batch["tokens"]
        logits, aux = self.forward(params, batch, adapters=adapters)
        s_text = tokens.shape[1]
        lf = logits[:, -s_text:][:, :-1].float()
        labels = tokens[:, 1:].long()
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels[..., None])[..., 0]
        ce = (lse - ll).mean()
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
        (b, blocks_per_req) int32."""
        cfg = self.cfg
        x = self._embed(params, tokens)
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
        x = self._embed(params, token)
        x, cache = decode_stack(
            cfg, params["stack"], cache, x, pos,
            adapters=self._stack_adapters(as_adapter_set(adapters)),
            table=table)
        x = apply_norm(cfg, x, params, "final")
        return self._head(params, x), cache


def build_model(cfg) -> Model:
    return Model(cfg)
