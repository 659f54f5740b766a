"""The four dense configs the port adds beside gemma-2b (llama2-7b,
qwen3-8b, mistral-nemo-12b, stablelm-1.6b) against the JAX package on the
CPU.

Each config must equal the JAX one field for field (less ``use_pallas``,
which the port replaces by the tensors' device).  Then a 2-layer model of
each, narrow, keeps the head shapes a ``reduced()`` config would hide
(``repro/configs/base.py``'s ``reduced`` resets d_model to heads x
head_dim): MHA with an untied head and a d_ff that is no power of two
(llama2-7b), four query heads a kv head with ``qk_norm`` (qwen3-8b), q wider
than d_model's heads (4 x 48 over d_model 256, GQA) with a sliding window of
64 over 100 tokens (mistral-nemo-12b), LayerNorm with head_dim 64
(stablelm-1.6b).  JAX draws the weights; ``params_from_numpy`` carries them
across.  Forward logits, the loss and its LoRA gradients, and greedy prefill
+ decode tokens must agree with the JAX reference tier within 1e-4 (fp32 on
both sides; only the order of the sums differs)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.launch import serve as jserve                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy        # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
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
ARCHS = ("llama2-7b", "qwen3-8b", "mistral-nemo-12b", "stablelm-1.6b")
# the small model of each: dataclasses.replace on the full config, so the
# head shapes stay what the family has
SMALL = {
    "llama2-7b": dict(d_model=256, num_heads=4, num_kv_heads=4,
                      head_dim=64, d_ff=344),
    "qwen3-8b": dict(d_model=256, num_heads=4, num_kv_heads=1,
                     head_dim=64, d_ff=384),
    "mistral-nemo-12b": dict(d_model=256, num_heads=4, num_kv_heads=2,
                             head_dim=48, d_ff=448, attn_window=64),
    "stablelm-1.6b": dict(d_model=256, num_heads=4, num_kv_heads=4,
                          head_dim=64, d_ff=176),
}
VOCAB = 384


def _small(pkg, arch):
    return dataclasses.replace(pkg.get_config(arch), num_layers=2,
                               vocab_size=VOCAB, **SMALL[arch])


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch):
    j = dataclasses.asdict(jconfigs.get_config(arch))
    j.pop("use_pallas")
    assert dataclasses.asdict(tconfigs.get_config(arch)) == j
    if arch == "mistral-nemo-12b":
        j = dataclasses.asdict(jconfigs.get_config(arch, sliding_window=True))
        j.pop("use_pallas")
        t = tconfigs.get_config(arch, sliding_window=True)
        assert dataclasses.asdict(t) == j and t.attn_window == 4096
    # the reduced variants too (the CLIs' --reduced)
    j = dataclasses.asdict(jconfigs.get_config(arch).reduced())
    j.pop("use_pallas")
    assert dataclasses.asdict(tconfigs.get_config(arch).reduced()) == j


@pytest.fixture(scope="module")
def models():
    """arch -> (jax model, port model, jax params, port params, jax lora,
    port lora): JAX-drawn weights and a rank-8 LoRA on q and v with nonzero
    B."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jm = japi.build_model(_small(jconfigs, arch))
            tm = tapi.build_model(_small(tconfigs, arch))
            jp = jm.init(jax.random.key(0))
            lora = jlora.init_lora(jp, jax.random.key(1),
                                   jbase.LoRAConfig(rank=8))
            rng = np.random.default_rng(2)
            lora = jax.tree.map(lambda x: np.asarray(x) + 0.02 * (
                rng.standard_normal(x.shape).astype(np.float32)), lora)
            cache[arch] = (jm, tm, jp, params_from_numpy(_np(jp), "cpu"),
                           lora, params_from_numpy(lora, "cpu"))
        return cache[arch]
    return get


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(
        np.int32)


def test_small_models_keep_their_head_shapes(models):
    """The shapes the small models exist for are there."""
    cfgs = {a: models(a)[1].cfg for a in ARCHS}
    assert not any(c.tie_embeddings for c in cfgs.values())
    assert cfgs["llama2-7b"].num_kv_heads == cfgs["llama2-7b"].num_heads
    assert cfgs["llama2-7b"].d_ff & (cfgs["llama2-7b"].d_ff - 1)
    assert cfgs["qwen3-8b"].qk_norm
    assert cfgs["qwen3-8b"].num_heads // cfgs["qwen3-8b"].num_kv_heads == 4
    nemo = cfgs["mistral-nemo-12b"]
    assert nemo.q_dim != nemo.d_model and nemo.attn_window == 64
    assert cfgs["stablelm-1.6b"].norm == "layernorm"
    p = models("mistral-nemo-12b")[3]["stack"]["repeat"]["p0"]["attn"]
    assert tuple(p["q"].shape) == (2, 256, 192)
    assert tuple(p["o"].shape) == (2, 192, 256)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("adapted", [False, True])
def test_forward_matches_jax(models, arch, adapted):
    jm, tm, jp, tp, jl, tl = models(arch)
    toks = _tokens(2, 100 if arch == "mistral-nemo-12b" else 24, seed=3)
    jad = jlora.AdapterSet(lora=jax.tree.map(jnp.asarray, jl), gamma=2.0) \
        if adapted else None
    tad = tlora.AdapterSet(lora=tl, gamma=2.0) if adapted else None
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, adapters=jad)
    got, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)}, adapters=tad)
    assert got.shape == (2, toks.shape[1], tm.vocab_padded)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_lora_grads_match_jax(models, arch):
    jm, tm, jp, tp, jl, tl = models(arch)
    toks = _tokens(2, 100 if arch == "mistral-nemo-12b" else 24, seed=4)

    def jloss(lo):
        return jm.loss(jp, {"tokens": jnp.asarray(toks)},
                       adapters=jlora.AdapterSet(lora=lo, gamma=2.0))[0]

    want, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, jl))
    leaves = jax.tree.map(lambda x: x.clone().requires_grad_(True), tl)
    got, _ = tm.loss(tp, {"tokens": torch.from_numpy(toks)},
                     adapters=tlora.AdapterSet(lora=leaves, gamma=2.0))
    grads = torch.autograd.grad(got, tree_leaves(leaves))
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        assert float(np.abs(np.asarray(w)).max()) > 0
        _close(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_jax(models, arch):
    """Greedy prefill + decode over a 4-tenant bank; mistral-nemo's prompt
    and steps run past its window of 64, so its ring cache wraps."""
    jm, tm, jp, tp, jl, tl = models(arch)
    plen, steps = (90, 10) if arch == "mistral-nemo-12b" else (12, 6)
    prompt = _tokens(4, plen, seed=5)
    jsets, tsets = [], []
    for i, r in enumerate((4, 8, 8, 16)):
        js = jlora.init_adapter_set(jp, jax.random.key(10 + i),
                                    jbase.LoRAConfig(rank=r), n_clients=4)
        lora = jax.tree.map(lambda x: np.asarray(x) + 0.05 * (
            np.random.default_rng(20 + i).standard_normal(x.shape)
            .astype(np.float32)), js.lora)
        jsets.append(dataclasses.replace(
            js, lora=jax.tree.map(jnp.asarray, lora)))
        tsets.append(tlora.AdapterSet(lora=params_from_numpy(lora, "cpu"),
                                      gamma=js.gamma, rank=r,
                                      alpha=js.alpha))
    jbank = jlora.AdapterBank.from_sets(jsets)
    tbank = tlora.AdapterBank.from_sets(tsets)
    ids = np.array([3, 0, 2, 1], np.int32)
    want = jserve.generate_banked(jm, jp, jbank, jnp.asarray(ids),
                                  jnp.asarray(prompt), steps, plen + steps)
    got = tserve.generate_banked(tm, tp, tbank, ids,
                                 torch.from_numpy(prompt), steps,
                                 plen + steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the logits of every decode step, teacher-forced on those tokens
    jad, tad = jbank.requests(jnp.asarray(ids)), tbank.requests(ids)
    _, jc = jm.prefill(jp, jm.init_cache(4, plen + steps),
                       jnp.asarray(prompt), jad)
    _, tc = tm.prefill(tp, tm.init_cache(4, plen + steps, device="cpu"),
                       torch.from_numpy(prompt), tad)
    seq = np.array(want)
    for t in range(plen, plen + steps - 1):
        pos = np.full((4,), t, np.int32)
        wl, jc = jm.decode_step(jp, jc, jnp.asarray(seq[:, t:t + 1]),
                                jnp.asarray(pos), jad)
        gl, tc = tm.decode_step(tp, tc, torch.from_numpy(seq[:, t:t + 1]),
                                torch.from_numpy(pos).long(), tad)
        _close(gl, wl)
