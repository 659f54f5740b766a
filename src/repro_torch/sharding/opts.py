"""Beyond-paper performance switches: the port of
``repro/sharding/opts.py``, with the same names and defaults.

All default False (the paper-faithful baseline).

  chunked_ce         compute the CE loss in sequence chunks so the (b, s, V)
                     logits tensor never materializes (``Model.loss``; a
                     memory-term fix).

The other switches (``expand_kv``, ``seq_parallel_attn``, ``remat_dots``,
``moe_grouped``, ``seq_parallel_residual``, ``embed_dshard``,
``cache_seq_shard``) act on the JAX package's mesh and dry-run, which the
port does not run yet: setting one raises :class:`NotImplementedError`
rather than doing nothing.
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

# the switches the port's code reads
PORTED = ("chunked_ce",)


def enabled(name: str) -> bool:
    return OPTS[name]


def set_opts(names, value: bool = True) -> None:
    names = list(names)
    for n in names:
        if n not in OPTS:
            raise ValueError(f"unknown opt '{n}'; options {sorted(OPTS)}")
        if n not in PORTED:
            raise NotImplementedError(
                f"opt '{n}' is not yet ported to repro_torch (ported: "
                f"{', '.join(PORTED)})")
    for n in names:
        OPTS[n] = value


def reset() -> None:
    for k in OPTS:
        OPTS[k] = False
