"""repro_torch's audio encoder-decoder (whisper-medium) against the JAX
package, on the CPU.

The reduced whisper-medium (d_model 64: 4 heads of 16, 2 decoder ``xattn``
layers, 2 bidirectional encoder layers over 16 stub frames, vocab 256).
The weights are the JAX ``Model.init`` draw and the adapters JAX's
``init_adapter_set`` draws (B made nonzero), carried across with
``params_from_numpy``; every other input comes from a numpy seed.

Held within 1e-4 (relative to max(1, max|ref|)):
- ``forward`` with frames, ``_encode`` alone and ``loss``; the LoRA
  gradients of every leaf, the encoder's and ``cross/v`` exactly 0.0 (the
  forward never reads them, in either package);
- ``prefill(enc_out=)`` and 6 decode steps: logits and the cache's cross
  K/V; prefill without ``enc_out`` (zero cross K/V, the serve CLI's case);
- ``round_step`` over caller-supplied frames: 2 clients x 2 local steps,
  fedsa + sfedlora, SGD, 2 rounds, over fp32 and over an int4 base.
Exactly: greedy tokens of ``generate`` (one tenant, and a merged one) and
``generate_banked``, scheduled tokens of ``serve_scheduled`` over fp32 and
int4; the admission view and merge of the per-slot cross K/V; checkpoints
both ways; the CLIs.

Tolerance, with its reason: fp32 on both sides, sums taken in another
order by XLA and by PyTorch's CPU kernels."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.checkpoint import io as jio                         # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.core import quant as jquant                         # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.launch import serve as jserve                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.models import transformer as jtransformer           # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint import io as tio                   # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy        # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.core import quant as tquant                   # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.kernels import dispatch                       # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.models import transformer as ttransformer     # noqa: E402
from repro_torch.tree import tree_leaves, tree_map              # noqa: E402

TOL = 1e-4
VOCAB = 256
D = 64
FRAMES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its small ops gain nothing
    from more, and the suite's parallel workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _cfgs():
    """(jax config, port config): each package's own reduced whisper."""
    return tuple(c.get_config("whisper-medium").reduced(d_model=D,
                                                        vocab_size=VOCAB)
                 for c in (jconfigs, tconfigs))


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params, jax sets, port
    sets, jax bank, port bank), built once: two tenants of ranks 4 and 8
    with nonzero B (on every leaf, the unread ones included)."""
    jcfg, tcfg = _cfgs()
    jm, tm = japi.build_model(jcfg), tapi.build_model(tcfg)
    jp = jm.init(jax.random.key(0))
    rng = np.random.default_rng(5)
    jsets, tsets = [], []
    for i, r in enumerate((4, 8)):
        js = jlora.init_adapter_set(jp, jax.random.key(30 + i),
                                    jbase.LoRAConfig(rank=r), n_clients=2)
        lora = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), _np(js.lora))
        jsets.append(dataclasses.replace(
            js, lora=jax.tree.map(jnp.asarray, lora)))
        tsets.append(tlora.AdapterSet(
            lora=params_from_numpy(lora, "cpu"), gamma=js.gamma, rank=r,
            alpha=js.alpha))
    return (jm, jp, tm, params_from_numpy(_np(jp), "cpu"), jsets, tsets,
            jlora.AdapterBank.from_sets(jsets),
            tlora.AdapterBank.from_sets(tsets))


def _tokens(b, s, seed=3):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(
        np.int32)


def _frames(b, seed=4):
    return np.random.default_rng(seed).standard_normal(
        (b, FRAMES, D)).astype(np.float32)


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


# ------------------------------------------------------------------ pieces

def test_config_params_and_lora_follow_the_jax_tree(models):
    j = dataclasses.asdict(jconfigs.get_config("whisper-medium"))
    t = dataclasses.asdict(tconfigs.get_config("whisper-medium"))
    j.pop("use_pallas")
    assert j == t
    assert "whisper-medium" in tconfigs.ARCHS
    assert "whisper-medium" not in tconfigs.NOT_YET_PORTED
    jred = jconfigs.get_config("whisper-medium").reduced()
    tred = tconfigs.get_config("whisper-medium").reduced()
    assert (tred.encoder_layers, tred.encoder_frames, tred.encoder_d_model) \
        == (jred.encoder_layers, jred.encoder_frames,
            jred.encoder_d_model) == (2, 16, tred.d_model)
    jm, jp, tm, _, jsets, tsets, *_ = models
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert _shapes(tp) == _shapes(jax.eval_shape(jm.init,
                                                 jax.random.key(0)))
    block = tp["stack"]["repeat"]["p0"]
    assert set(block) == {"ln1_scale", "ln1_bias", "attn", "lnx_scale",
                          "lnx_bias", "cross", "ln2_scale", "ln2_bias",
                          "mlp"}
    assert set(tp["encoder"]) == {"stack", "encfinal_scale",
                                  "encfinal_bias"}
    assert set(tp["encoder"]["stack"]["repeat"]["p0"]) == {
        "ln1_scale", "ln1_bias", "attn", "ln2_scale", "ln2_bias", "mlp"}
    # init_lora walks the whole tree: the decoder's attn and cross q / v
    # and the encoder's attn q / v, as JAX's; from the config alone too
    assert _shapes(tsets[0].lora) == _shapes(jsets[0].lora)
    assert set(tsets[0].lora["stack"]["repeat"]["p0"]) == {"attn", "cross"}
    assert set(tsets[0].lora["encoder"]["stack"]["repeat"]["p0"]["attn"]) \
        == {"q", "v"}
    from_cfg = tlora.lora_tree_for_model(
        tm, torch.Generator().manual_seed(0), tbase.LoRAConfig(rank=4),
        device="cpu")
    assert _shapes(from_cfg) == _shapes(jsets[0].lora)


def test_forward_encode_and_loss_match_jax(models):
    jm, jp, tm, tp, jsets, tsets, *_ = models
    toks, frames = _tokens(2, 8), _frames(2)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}
    _close(tm._encode(tp, tb), jm._encode(jp, jb))
    want, _ = jm.forward(jp, jb, adapters=jsets[1])
    got, aux = tm.forward(tp, tb, adapters=tsets[1])
    assert float(aux) == 0.0
    _close(got, want)
    (jl, jmet), (tl, tmet) = (jm.loss(jp, jb, adapters=jsets[0]),
                              tm.loss(tp, tb, adapters=tsets[0]))
    _close(tl, jl)
    _close(tmet["ce"], jmet["ce"])
    # the frames are live: other frames, other logits
    other, _ = tm.forward(tp, {**tb, "frames": tb["frames"] * 2.0})
    assert float((other - tm.forward(tp, tb)[0]).abs().max()) > 1e-3
    # a batch without frames raises KeyError('frames') in both packages
    for m, p, b in ((jm, jp, {"tokens": jb["tokens"]}),
                    (tm, tp, {"tokens": tb["tokens"]})):
        with pytest.raises(KeyError, match="frames"):
            m.loss(p, b)


def _walk_ab(tree, path=()):
    """(path, leaf name, leaf) over an A/B tree, in sorted-key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk_ab(v, path + (k,))
        else:
            yield path, k, v


def _unread(path) -> bool:
    """A node no projection reads: the encoder's adapters (``_encode``
    takes none) and ``cross/v`` (``build_cross_kv`` takes none)."""
    return path[0] == "encoder" or path[-2:] == ("cross", "v")


def test_lora_grads_match_jax_and_unread_leaves_get_zero(models):
    jm, jp, tm, tp, jsets, tsets, *_ = models
    toks, frames = _tokens(2, 8, seed=6), _frames(2, seed=7)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)}
    js = jsets[0]
    want = jax.grad(lambda lo: jm.loss(
        jp, jb, adapters=dataclasses.replace(js, lora=lo))[0])(js.lora)
    leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                      tsets[0].lora)
    loss, _ = tm.loss(tp, tb, adapters=dataclasses.replace(tsets[0],
                                                           lora=leaves))
    grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
    paths = [path for path, _, _ in _walk_ab(leaves)]
    jflat = jax.tree.leaves(want)
    assert len(grads) == len(jflat) == len(paths)
    n_unread = 0
    for path, g, w in zip(paths, grads, jflat):
        if _unread(path):
            n_unread += 1
            assert g is None
            assert not np.asarray(w).any(), path
        else:
            assert g is not None and float(np.abs(np.asarray(w)).max()) > 0
            _close(g, w)
    # encoder q / v (a, b) under the repeat, and cross v (a, b)
    assert n_unread == 6


@pytest.mark.parametrize("enc", ["enc_out", "no-enc_out"])
def test_prefill_and_decode_match_jax(models, enc):
    """``prefill`` (with the encoder output, or without: the cache's zero
    cross K/V) and 6 decode steps under a banked set: logits and every
    layer's cross K/V."""
    jm, jp, tm, tp, _, _, jbank, tbank = models
    toks, frames = _tokens(3, 7, seed=9), _frames(3, seed=10)
    ids = np.asarray([1, 0, 1], np.int32)
    jad, tad = jbank.requests(jnp.asarray(ids)), tbank.requests(ids)
    jenc = tenc = None
    if enc == "enc_out":
        jenc = jm._encode(jp, {"frames": jnp.asarray(frames)})
        tenc = tm._encode(tp, {"frames": torch.from_numpy(frames)})
    jc = jm.init_cache(3, 13)
    tc = tm.init_cache(3, 13, device="cpu")
    assert tc["repeat"]["p0"]["cross_k"].shape == (2, 3, FRAMES, 4, 16)
    jl, jc = jm.prefill(jp, jc, jnp.asarray(toks), jad, enc_out=jenc)
    tl, tc = tm.prefill(tp, tc, torch.from_numpy(toks), tad, enc_out=tenc)
    _close(tl, jl)
    for step in range(6):
        tok = _tokens(3, 1, seed=20 + step)
        pos = np.full((3,), 7 + step, np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                                jad)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok),
                                torch.from_numpy(pos), tad)
        _close(tl, jl)
    for leaf in ("cross_k", "cross_v"):
        got, want = tc["repeat"]["p0"][leaf], jc["repeat"]["p0"][leaf]
        _close(got, want)
        assert bool(got.any()) == (enc == "enc_out")
    _close(tc["repeat"]["p0"]["self"]["k"], jc["repeat"]["p0"]["self"]["k"])


# ------------------------------------------------------------------ serving

def test_greedy_tokens_match_jax(models):
    """``generate`` under one tenant's set and under that tenant merged into
    the base (the serve CLI's ``--merge``), and ``generate_banked`` over
    both tenants: the same tokens as the JAX package."""
    jm, jp, tm, tp, jsets, tsets, jbank, tbank = models
    prompts = _tokens(3, 6, seed=2)
    want = np.asarray(jserve.generate(jm, jp, jnp.asarray(prompts), 7, 13,
                                      jsets[1]))
    got = tserve.generate(tm, tp, torch.from_numpy(prompts), 7, 13,
                          tsets[1])
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jserve.generate(jm, jbank.adapter(1).merge(jp),
                                      jnp.asarray(prompts), 7, 13))
    got = tserve.generate(tm, tbank.adapter(1).merge(tp),
                          torch.from_numpy(prompts), 7, 13)
    np.testing.assert_array_equal(got.numpy(), want)
    ids = np.asarray([1, 0, 1], np.int32)
    want = np.asarray(jserve.generate_banked(jm, jp, jbank, jnp.asarray(ids),
                                             jnp.asarray(prompts), 7, 13))
    got = tserve.generate_banked(tm, tp, tbank, ids,
                                 torch.from_numpy(prompts), 7, 13)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["fp32", "int4"])
def test_scheduled_tokens_match_jax(models, mode):
    """serve_scheduled: 5 requests through 2 slots, so admissions recycle
    slots whose cross K/V must start fresh, and a deadline cuts one
    request; over fp32 and over an int4 base (group 32) packed by each
    package."""
    jm, jp, tm, tp, _, _, jbank, tbank = models
    if mode == "int4":
        jp = jquant.quantize_tree(jp, mode, 32)
        tp = tquant.quantize_tree(tp, mode, 32)
        cross = tp["stack"]["repeat"]["p0"]["cross"]
        assert all(isinstance(cross[k], tquant.QuantizedLinear)
                   for k in "qkvo")
        assert isinstance(tp["encoder"]["stack"]["repeat"]["p0"]["mlp"][
            "w_up"], tquant.QuantizedLinear)
    prompts = _tokens(5, 6, seed=8)
    steps = (7, 3, 7, 5, 7)
    kw = dict(max_batch=2, block_size=4, chunk=4, wait=False)

    def reqs(mod):
        return [mod.Request(rid=i, prompt=prompts[i], steps=steps[i],
                            adapter_id=i % 2,
                            deadline_steps=4 if i == 2 else None)
                for i in range(5)]

    jdone = jserve.serve_scheduled(jm, jp, reqs(jserve), bank=jbank, **kw)
    tdone = tserve.serve_scheduled(tm, tp, reqs(tserve), bank=tbank, **kw)
    want = [r.tokens for r in jdone]
    assert len(want[2]) == 4 and jdone[2].timed_out
    assert [r.tokens for r in tdone] == want
    assert tdone[2].timed_out


def test_paged_view_and_merge_place_cross_kv_per_slot(models):
    """The admission view shares the engine's pools and holds fresh zero
    cross K/V for the newcomer group; the merge scatters them into the
    newcomers' slots only, and leaves the pools and every other slot as
    they were.  JAX's view and merge give the same cache."""
    jm, _, tm, *_ = models
    rng = np.random.default_rng(11)
    cache = tm.init_paged_cache(9, 4, 4, device="cpu")
    jcache = jm.init_paged_cache(9, 4, 4)
    filled = {}
    for path, leaf in (("cross_k", "cross_k"), ("cross_v", "cross_v")):
        val = rng.standard_normal(
            tuple(cache["repeat"]["p0"][leaf].shape)).astype(np.float32)
        cache["repeat"]["p0"][leaf].copy_(torch.from_numpy(val))
        filled[path] = val
    kpool = rng.standard_normal(tuple(
        cache["repeat"]["p0"]["self"]["k_pool"].shape)).astype(np.float32)
    cache["repeat"]["p0"]["self"]["k_pool"].copy_(torch.from_numpy(kpool))
    jcache = jax.tree.map(lambda a: a, jcache)
    jcache["repeat"]["p0"] = {
        **jcache["repeat"]["p0"],
        "cross_k": jnp.asarray(filled["cross_k"]),
        "cross_v": jnp.asarray(filled["cross_v"]),
        "self": {**jcache["repeat"]["p0"]["self"],
                 "k_pool": jnp.asarray(kpool)}}
    view = ttransformer.paged_prefill_view(tm.cfg, cache, 2, torch.float32,
                                           device="cpu", cross_len=FRAMES)
    jview = jtransformer.paged_prefill_view(jm.cfg, jcache, 2, jnp.float32,
                                            cross_len=FRAMES)
    layer = view["repeat"]["p0"]
    assert layer["self"] is cache["repeat"]["p0"]["self"]
    assert layer["cross_k"].shape == (2, 2, FRAMES, 4, 16)
    assert not layer["cross_k"].any() and not layer["cross_v"].any()
    new = {leaf: rng.standard_normal(tuple(layer[leaf].shape)).astype(
        np.float32) for leaf in ("cross_k", "cross_v")}
    for leaf, val in new.items():
        layer[leaf].copy_(torch.from_numpy(val))
        jview["repeat"]["p0"][leaf] = jnp.asarray(val)
    slots = [3, 1]
    merged = ttransformer.merge_paged_cache(cache, view, slots)
    jmerged = jtransformer.merge_paged_cache(jcache, jview,
                                             jnp.asarray(slots))
    for leaf in ("cross_k", "cross_v"):
        got = merged["repeat"]["p0"][leaf].numpy()
        np.testing.assert_array_equal(got[:, slots], new[leaf])
        np.testing.assert_array_equal(got[:, [0, 2]],
                                      filled[leaf][:, [0, 2]])
        np.testing.assert_array_equal(got,
                                      np.asarray(jmerged["repeat"]["p0"][leaf]))
    np.testing.assert_array_equal(
        merged["repeat"]["p0"]["self"]["k_pool"].numpy(), kpool)


# ------------------------------------------------------------ round_step

def _trainers(models, quant=None):
    """A JAX and a port trainer on the reduced whisper (2 clients x 2
    local steps, fedsa + sfedlora, SGD), the port from JAX's base and
    ``init_lora`` draw; ``quant`` packs both bases (group 32)."""
    jm, jp, tm, *_ = models
    n = 2
    lcfg = dict(rank=4, alpha=8.0, scaling="sfedlora")
    fcfg = dict(num_clients=n, local_steps=2, aggregation="fedsa")
    ocfg = dict(name="sgd", lr=0.5)
    ds_kw = dict(seq_len=8, batch_per_client=2, seed=0)
    jbase_p = jp if quant is None else jquant.quantize_tree(jp, quant, 32)
    jtr = jfed.FederatedTrainer(
        jm, jsyn.FederatedDataset(VOCAB, n, **ds_kw),
        lora_cfg=jbase.LoRAConfig(**lcfg),
        fed_cfg=jbase.FederatedConfig(**fcfg),
        opt_cfg=jbase.OptimizerConfig(**ocfg), seed=0, base_params=jbase_p)
    tbase_p = params_from_numpy(_np(jp), "cpu")
    if quant is not None:
        tbase_p = tquant.quantize_tree(tbase_p, quant, 32)
    ttr = tfed.FederatedTrainer(
        tapi.build_model(tm.cfg), tsyn.FederatedDataset(VOCAB, n, **ds_kw),
        lora_cfg=tbase.LoRAConfig(**lcfg),
        fed_cfg=tbase.FederatedConfig(**fcfg),
        opt_cfg=tbase.OptimizerConfig(**ocfg), seed=0, base_params=tbase_p,
        lora_init=jax.tree.map(lambda x: np.asarray(x[0]), jtr.lora),
        device="cpu")
    assert ttr.gamma == jtr.gamma
    return jtr, ttr


def _round_batches(rounds, n=2, steps=2, b=2, s=8, seed=12):
    """Per round, (N, local_steps, ...) tokens and frames."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, (n, steps, b, s)).astype(np.int32),
             rng.standard_normal((n, steps, b, FRAMES, D)).astype(
                 np.float32)) for _ in range(rounds)]


def _run_round_steps(jtr, ttr, rounds):
    ja, jo, ta, to = jtr.adapters, jtr.opt_state, ttr.adapters, ttr.opt_state
    hist = []
    for r, (toks, frames) in enumerate(_round_batches(rounds)):
        ja, jo, jm_ = jtr.round_step(jtr.base, ja, jo,
                                     {"tokens": jnp.asarray(toks),
                                      "frames": jnp.asarray(frames)},
                                     jnp.asarray(r))
        ta, to, tm_ = ttr.round_step(ttr.base, ta, to,
                                     {"tokens": torch.from_numpy(toks),
                                      "frames": torch.from_numpy(frames)},
                                     r)
        hist.append((jm_, tm_))
    return ja, ta, hist


def test_round_step_over_frames_matches_jax(models):
    """2 rounds of ``round_step``: loss, grad-norm and every LoRA leaf
    within 1e-4 of JAX's; the encoder's adapters and ``cross/v`` get exact
    zero gradients, so under SGD their A stays at the init draw and their
    B at exactly 0.0, in both packages; the trainer's own state is not
    touched."""
    jtr, ttr = _trainers(models)
    init = [t.clone() for t in tree_leaves(ttr.lora)]
    dispatch.reset_stats()
    ja, ta, hist = _run_round_steps(jtr, ttr, 2)
    # attn q, attn v and cross q of the 2 layers, per client local step,
    # in the forward and in the backward's recompute
    assert dispatch.stats["lora_matmul"] == 2 * 3 * 2 * 2 * 2 * 2
    for jm_, tm_ in hist:
        for key in ("loss", "grad_norm"):
            _close(tm_[key], jm_[key])
    for g, w in zip(tree_leaves(ta.lora), jax.tree.leaves(ja.lora)):
        _close(g, w)
    nodes = list(_walk_ab(ta.lora))
    jnodes = jax.tree.leaves(ja.lora)
    assert len(nodes) == len(init) == len(jnodes)
    moved = 0
    for (path, name, leaf), t0, jleaf in zip(nodes, init, jnodes):
        if _unread(path):
            assert torch.equal(leaf, t0), path
            if name == "b":
                assert not leaf.any() and not np.asarray(jleaf).any()
        elif name == "b":
            moved += bool(leaf.any())
    assert moved == 3                     # attn q, attn v, cross q
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(ttr.lora),
                                                 init))


def test_trainer_drawn_adapters_keep_unread_leaves_at_zero(models):
    """The port's own ``init_lora`` draw keeps the params' key order,
    "stack" before "encoder", not the sorted order ``tree_leaves`` lists:
    the client loop must put every gradient back on its own leaf
    (``tree_unflatten``), so after a round_step the unread nodes are
    exactly as drawn (B 0.0) and each read one has moved."""
    tm = models[2]
    n = 2
    ttr = tfed.FederatedTrainer(
        tm, tsyn.FederatedDataset(VOCAB, n, seq_len=8, batch_per_client=2),
        lora_cfg=tbase.LoRAConfig(rank=4),
        fed_cfg=tbase.FederatedConfig(num_clients=n, local_steps=2),
        opt_cfg=tbase.OptimizerConfig(lr=0.5), seed=0, device="cpu")
    assert list(ttr.lora) == ["stack", "encoder"]
    toks, frames = _round_batches(1)[0]
    aset, _, _ = ttr.round_step(ttr.base, ttr.adapters, ttr.opt_state,
                                {"tokens": torch.from_numpy(toks),
                                 "frames": torch.from_numpy(frames)}, 0)
    for (path, name, new), old in zip(_walk_ab(aset.lora),
                                      tree_leaves(ttr.lora)):
        if _unread(path):
            assert torch.equal(new, old), path
        elif name == "b":
            assert bool(new.any()), path


def test_round_step_over_an_int4_base_matches_jax(models):
    """One round over an int4 base (every attn, cross and MLP projection
    of the decoder and the encoder packed, group 32): loss, grad-norm and
    the decoder's q / v leaves of the last layer within 1e-4 of JAX's."""
    jtr, ttr = _trainers(models, quant="int4")
    assert tquant.has_quantized(ttr.base)
    ja, ta, hist = _run_round_steps(jtr, ttr, 1)
    (jm_, tm_), = hist
    for key in ("loss", "grad_norm"):
        _close(tm_[key], jm_[key])
    for sub, proj in (("attn", "q"), ("attn", "v"), ("cross", "q")):
        for ab in ("a", "b"):
            _close(ta.lora["stack"]["repeat"]["p0"][sub][proj][ab],
                   ja.lora["stack"]["repeat"]["p0"][sub][proj][ab])


# ---------------------------------------------------------- checkpoints

def test_adapter_checkpoints_cross_both_ways(models, tmp_path):
    """A whisper trainer's state after a round_step, saved by either
    package in the flat npz format, loads in the other: the base
    (encoder included), the stacked adapters and their gamma."""
    jtr, ttr = _trainers(models)
    ja, ta, _ = _run_round_steps(jtr, ttr, 1)
    jtr.lora, ttr.lora = ja.lora, ta.lora
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jtr.save(jpath)
    ttr.save(tpath)
    base, aset = tio.load_adapter_state(jpath, device="cpu")
    assert aset.gamma == jio.load_adapter_state(jpath)[1].gamma
    assert set(base["encoder"]) == {"stack", "encfinal_scale",
                                    "encfinal_bias"}
    for g, w in zip(tree_leaves(base), jax.tree.leaves(jtr.base)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(tree_leaves(aset.lora), jax.tree.leaves(jtr.lora)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jb, jset = jio.load_adapter_state(tpath)
    assert jset.gamma == tio.load_adapter_state(tpath, device="cpu")[1].gamma
    for g, w in zip(jax.tree.leaves(jset.lora), tree_leaves(ttr.lora)):
        np.testing.assert_array_equal(np.asarray(g), w.numpy())
    assert len(jax.tree.leaves(jb)) == len(tree_leaves(ttr.base))


# ------------------------------------------------------------------ CLIs

SERVE = ["--arch", "whisper-medium", "--reduced", "--device", "cpu",
         "--steps", "3", "--batch", "2"]


@pytest.mark.parametrize("extra", [
    [], ["--quant", "int8"], ["--quant", "int4", "--quant-group", "32"],
    ["--merge", "0"], ["--arrival-trace", "poisson:50:5"],
    ["--arrival-trace", "poisson:50:5", "--quant", "int4", "--quant-group",
     "32", "--hot-slots", "2", "--deadline-steps", "2", "--max-batch", "2"],
], ids=["fixed", "int8", "int4", "merge", "scheduled", "scheduled-int4"])
def test_serve_cli_runs_on_cpu(extra, capsys):
    """The serve CLI runs the decoder alone, as JAX's does (no encoder
    output: the cache's zero cross K/V)."""
    out = tserve.main(SERVE + extra)
    text = capsys.readouterr().out
    if "--arrival-trace" in extra:
        assert len(out) == 5
        assert "# whisper-medium scheduled serve: 5 requests" in text
    else:
        assert tuple(out.shape) == (2, 7)
        assert "# whisper-medium" in text
