"""repro_torch model against the JAX package on reduced gemma-2b (2 layers,
d_model 256, MQA): the JAX ``Model.init`` parameters and a 3-tenant
mixed-rank bank with nonzero B are carried across with ``params_from_numpy``,
and forward / prefill / decode_step and the layer-level pieces must agree
with the JAX reference tier at 1e-4 (fp32 on the CPU; the two frameworks
sum in different orders)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.configs.base import LoRAConfig as JLoRAConfig       # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.models import attention as jattn                    # noqa: E402
from repro.models import layers as jlayers                     # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy        # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.models import attention as tattn              # noqa: E402
from repro_torch.models import layers as tlayers               # noqa: E402
from repro_torch.tree import tree_leaves                        # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its small ops gain nothing
    from more, and the suite's parallel workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)
RANKS = (4, 8, 16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def pair():
    """(jax model, port model, jax params, port params, jax bank, port bank,
    jax sets, port sets)."""
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jm, tm = japi.build_model(jcfg), tapi.build_model(tcfg)
    jparams = jm.init(jax.random.key(0))
    tparams = params_from_numpy(_np(jparams), "cpu")
    rng = np.random.default_rng(7)
    jsets, tsets = [], []
    for i, r in enumerate(RANKS):
        js = jlora.init_adapter_set(jparams, jax.random.key(10 + i),
                                    JLoRAConfig(rank=r), n_clients=3)
        # init_lora zero-inits B, which would make every adapter a no-op
        lora = jax.tree.map(
            lambda x: x + 0.02 * rng.standard_normal(x.shape).astype(
                np.float32), _np(js.lora))
        js = dataclasses.replace(js, lora=jax.tree.map(jnp.asarray, lora))
        jsets.append(js)
        tsets.append(tlora.AdapterSet(lora=params_from_numpy(lora, "cpu"),
                                      gamma=js.gamma, rank=r, alpha=js.alpha))
    return (jm, tm, jparams, tparams, jlora.AdapterBank.from_sets(jsets),
            tlora.AdapterBank.from_sets(tsets), jsets, tsets)


def _tokens(b, s, seed=3):
    return np.random.default_rng(seed).integers(0, 512, (b, s)).astype(
        np.int32)


def test_config_matches_jax():
    j = dataclasses.asdict(jconfigs.get_config("gemma-2b").reduced())
    t = dataclasses.asdict(tconfigs.get_config("gemma-2b").reduced())
    j.pop("use_pallas")
    assert j == t
    # roberta-large, the last arch that raised "not yet ported", runs now
    j = dataclasses.asdict(jconfigs.get_config("roberta-large").reduced())
    t = dataclasses.asdict(tconfigs.get_config("roberta-large").reduced())
    j.pop("use_pallas")
    assert j == t


def test_bank_matches_jax(pair):
    *_, jbank, tbank, _, _ = pair
    assert tbank.ranks == jbank.ranks == RANKS
    np.testing.assert_array_equal(tbank.rank_mask,
                                  np.asarray(jbank.rank_mask))
    for jl, tl in zip(jax.tree.leaves(jbank.lora),
                      tree_leaves(tbank.lora)):
        _close(tl, jl, rtol=1e-6, atol=1e-7)


def test_sfedlora_gamma_folded_once(pair):
    *_, jsets, tsets = pair
    assert tsets[0].gamma == pytest.approx(8.0 * (3 / 4) ** 0.5)
    prepared = tsets[0].prepared()
    assert prepared.gamma == 1.0 and prepared.prepared() is prepared


@pytest.mark.parametrize("which", ["base", "single", "lazy", "gather"])
def test_forward_matches_jax(pair, which):
    jm, tm, jp, tp, jbank, tbank, jsets, tsets = pair
    toks = _tokens(3, 12)
    ids = np.array([2, 0, 1], np.int32)
    jad, tad = {"base": (None, None),
                "single": (jsets[1], tsets[1]),
                "lazy": (jbank.requests(jnp.asarray(ids)),
                         tbank.requests(ids)),
                "gather": (jbank.gather(jnp.asarray(ids)),
                           tbank.gather(ids))}[which]
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, adapters=jad)
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                          adapters=tad)
    assert got.shape == (3, 12, tm.vocab_padded) and aux == 0.0
    _close(got, want)


def test_tenants_differ(pair):
    """Two tenants on one prompt give different logits: the LoRA is live."""
    _, tm, _, tp, _, tbank, _, _ = pair
    toks = torch.from_numpy(np.repeat(_tokens(1, 8), 2, axis=0))
    logits, _ = tm.forward(tp, {"tokens": toks},
                           adapters=tbank.requests([0, 2]))
    assert (logits[0] - logits[1]).abs().max() > 1e-3


@pytest.mark.parametrize("last_only", [False, True])
def test_prefill_matches_jax(pair, last_only):
    jm, tm, jp, tp, jbank, tbank, _, _ = pair
    toks = _tokens(3, 10, seed=4)
    ids = np.array([1, 1, 2], np.int32)
    want, jcache = jm.prefill(jp, jm.init_cache(3, 16), jnp.asarray(toks),
                              jbank.requests(jnp.asarray(ids)),
                              last_only=last_only)
    got, tcache = tm.prefill(tp, tm.init_cache(3, 16, device="cpu"),
                             torch.from_numpy(toks), tbank.requests(ids),
                             last_only=last_only)
    _close(got, want)
    for key in ("k", "v", "pos"):
        _close(tcache["repeat"]["p0"][key],
               jcache["repeat"]["p0"][key])


@pytest.mark.parametrize("materialized", [False, True])
def test_decode_steps_match_jax(pair, materialized):
    """4 decode steps after a prefill, on the lazy bank (ids per step) and
    on the materialized one."""
    jm, tm, jp, tp, jbank, tbank, _, _ = pair
    ids = np.array([0, 2, 1], np.int32)
    jad = (jbank.gather if materialized else jbank.requests)(jnp.asarray(ids))
    tad = (tbank.gather if materialized else tbank.requests)(ids)
    prompt = _tokens(3, 6, seed=5)
    _, jcache = jm.prefill(jp, jm.init_cache(3, 12), jnp.asarray(prompt), jad)
    _, tcache = tm.prefill(tp, tm.init_cache(3, 12, device="cpu"),
                           torch.from_numpy(prompt), tad)
    steps = _tokens(3, 4, seed=6)
    for t in range(4):
        pos = np.full((3,), 6 + t, np.int32)
        want, jcache = jm.decode_step(jp, jcache, jnp.asarray(steps[:, t:t + 1]),
                                      jnp.asarray(pos), jad)
        got, tcache = tm.decode_step(tp, tcache,
                                     torch.from_numpy(steps[:, t:t + 1]),
                                     torch.from_numpy(pos).long(), tad)
        _close(got, want)


# --------------------------------------------------------------- layers

def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    scale = rng.standard_normal((32,)).astype(np.float32)
    _close(tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    pos = np.array([[0, 1, 2, 9, 700], [3, 4, 5, 6, 7]], np.int32)
    _close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              10_000.0),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


def test_geglu_mlp_matches_jax():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    p = _np(jlayers.mlp_params(jcfg, jax.random.key(1), 256, 1024))
    x = np.random.default_rng(1).standard_normal((2, 3, 256)).astype(
        np.float32)
    _close(tlayers.mlp_apply(tcfg, params_from_numpy(p, "cpu"),
                             torch.from_numpy(x)),
           jlayers.mlp_apply(jcfg, jax.tree.map(jnp.asarray, p),
                             jnp.asarray(x)))


def test_attention_core_matches_jax_with_fully_masked_row():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 1, 16)).astype(np.float32)
    mask = rng.random((2, 6, 9)) < 0.6
    mask[0, 2] = False                   # a fully masked row: uniform softmax
    got = tattn.attention_core(tcfg, *(torch.from_numpy(a) for a in
                                       (q, k, v, mask)))
    _close(got, jattn.attention_core(jcfg, *(jnp.asarray(a) for a in
                                             (q, k, v, mask))))
    np.testing.assert_allclose(got[0, 2].numpy(),
                               np.broadcast_to(v[0, :, 0].mean(0), (4, 16)),
                               rtol=1e-5, atol=1e-6)


def test_blockwise_attention_matches_jax_and_dense():
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 1, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    tq, tk, tv, tpos = (torch.from_numpy(np.ascontiguousarray(a))
                        for a in (q, k, v, pos))
    want = jattn.blockwise_attention(jcfg, *(jnp.asarray(a) for a in
                                             (q, k, v, pos, pos)),
                                     causal=True, window=None)
    small = tattn.blockwise_attention(tcfg, tq, tk, tv, tpos, tpos,
                                      causal=True, window=7, q_block=16,
                                      kv_block=8)
    dense = tattn.attention_core(
        tcfg, tq, tk, tv, tattn.make_mask(tpos, tpos, causal=True, window=7))
    _close(tattn.blockwise_attention(tcfg, tq, tk, tv, tpos, tpos,
                                     causal=True, window=None), want)
    torch.testing.assert_close(small, dense, rtol=1e-5, atol=1e-5)
