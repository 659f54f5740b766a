"""Beyond-paper performance switches: the port of
``repro/sharding/opts.py``, with the same names and defaults.

All default False (the paper-faithful baseline).  What each does in the
port:

  expand_kv          repeat GQA KV heads to the full head count before
                     attention and constrain q / k / v's head dim onto
                     `model` (``models/attention.py``); off a mesh the
                     repeat alone, the same numbers.
  seq_parallel_attn  constrain the query positions onto `model` before a
                     blocked attention when the heads do not divide 16
                     (context parallelism for 8-head archs;
                     ``models/attention._attend``).
  chunked_ce         compute the CE loss in sequence chunks so the (b, s, V)
                     logits tensor never materializes (``Model.loss``; a
                     memory-term fix).
  remat_dots         give the checkpoint of each repeat unit in training the
                     selective policy: save the outputs of matmuls without
                     batch dims and recompute the rest
                     (``models/transformer.apply_stack``, whose default
                     recomputes the whole unit, as JAX's does).
  moe_grouped        per-batch-row MoE dispatch groups: router cumsum and
                     capacity are group-local (``models/moe.py``); this
                     changes which tokens a full expert drops, so it is the
                     one switch whose numbers differ on one device.
  seq_parallel_residual  constrain the residual stream's sequence dim onto
                     `model` at the start of every repeat unit (Megatron-SP
                     analogue).
  embed_dshard       shard the embedding table on d instead of vocab
                     (``sharding/rules.param_spec``).
  cache_seq_shard    shard a KV cache's sequence dim over `model` instead of
                     kv-heads / head-dim (``sharding/rules.cache_spec``).

The four constraint switches act only on a mesh whose model axis holds
DTensors (``sharding/specs.constrain``); elsewhere they leave the numbers
as they are.
"""
from __future__ import annotations

OPTS = {
    "expand_kv": False,
    "seq_parallel_attn": False,
    "chunked_ce": False,
    "remat_dots": False,
    "moe_grouped": False,
    "seq_parallel_residual": False,
    "embed_dshard": False,
    "cache_seq_shard": False,
}

# the switches the port's code reads: all of them
PORTED = tuple(OPTS)


def enabled(name: str) -> bool:
    return OPTS[name]


def set_opts(names, value: bool = True) -> None:
    names = list(names)
    for n in names:
        if n not in OPTS:
            raise ValueError(f"unknown opt '{n}'; options {sorted(OPTS)}")
    for n in names:
        OPTS[n] = value


def reset() -> None:
    for k in OPTS:
        OPTS[k] = False
