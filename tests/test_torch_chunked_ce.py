"""repro_torch's chunked cross-entropy (``Model._loss_chunked`` behind the
``chunked_ce`` switch of ``repro_torch.sharding.opts``) against the JAX
package, on the CPU.

A reduced gemma-2b (dense) and a reduced paligemma-3b (VLM: 8 patches
before the text), d_model 64, 2 layers, vocab 256, 16 text tokens (15
predicting positions), with the JAX ``Model.init`` draw and a JAX
``init_adapter_set`` draw (B made nonzero) carried across.

Held within 1e-4 (relative to max(1, max|ref|)): the chunked loss and its
LoRA gradients against JAX's ``_loss_chunked`` at one chunk (512), at
three (5) and at four with a ragged last one (4); the chunked against the
plain loss in the port; 2 trainer rounds with the switch on against JAX's.
Exactly: the switches' names and defaults, their errors, the encoder's
loss with the switch on and off.  And, with a ``saved_tensors_hooks``
probe, no tensor saved for the backward holds the (b, s, V) logits under
the switch (the plain loss saves them: the probe's control).

Tolerance, with its reason: fp32 on both sides, sums taken in another
order by XLA and by PyTorch's CPU kernels."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.sharding import opts as jopts                       # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy        # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.sharding import opts as topts                 # noqa: E402
from repro_torch.tree import tree_leaves, tree_map              # noqa: E402

TOL = 1e-4
VOCAB = 256
D = 64
S = 16
ARCHS = {"dense": "gemma-2b", "vlm": "paligemma-3b"}
UNPORTED = sorted(set(jopts.OPTS) - {"chunked_ce"})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its small ops gain nothing
    from more, and the suite's parallel workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reset_opts():
    jopts.reset()
    topts.reset()
    yield
    jopts.reset()
    topts.reset()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _pair(arch):
    """(jax model, jax params, port model, port params, jax set, port set)
    for a reduced ``arch``; one rank-4 adapter set with nonzero B."""
    jm, tm = (api.build_model(c.get_config(arch).reduced(
        d_model=D, vocab_size=VOCAB)) for api, c in ((japi, jconfigs),
                                                     (tapi, tconfigs)))
    jp = jm.init(jax.random.key(0))
    js = jlora.init_adapter_set(jp, jax.random.key(30),
                                jbase.LoRAConfig(rank=4), n_clients=2)
    rng = np.random.default_rng(5)
    lora = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(
        x.shape).astype(np.float32), _np(js.lora))
    js = dataclasses.replace(js, lora=jax.tree.map(jnp.asarray, lora))
    ts = tlora.AdapterSet(lora=params_from_numpy(lora, "cpu"),
                          gamma=js.gamma, rank=4, alpha=js.alpha)
    return jm, jp, tm, params_from_numpy(_np(jp), "cpu"), js, ts


@pytest.fixture(scope="module")
def pairs():
    return {fam: _pair(arch) for fam, arch in ARCHS.items()}


def _batch(cfg, b=2, seed=3):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, VOCAB, (b, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.num_patches, tapi.PATCH_EMBED_DIM)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _port_grads(tm, tp, ts, tb, fn):
    leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                      ts.lora)
    loss, met = fn(tm, tp, tb, dataclasses.replace(ts, lora=leaves))
    return loss, met, torch.autograd.grad(loss, tree_leaves(leaves))


# ------------------------------------------------------------------ opts

def test_opts_mirror_jax():
    assert topts.OPTS == jopts.OPTS
    assert list(topts.OPTS) == list(jopts.OPTS)
    assert not any(topts.OPTS.values())
    topts.set_opts(["chunked_ce"])
    assert topts.enabled("chunked_ce")
    topts.set_opts(["chunked_ce"], False)
    assert not topts.enabled("chunked_ce")
    topts.set_opts(["chunked_ce"])
    topts.reset()
    assert not any(topts.OPTS.values())
    for mod in (jopts, topts):
        with pytest.raises(ValueError, match="unknown opt 'nope'"):
            mod.set_opts(["nope"])


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_opts_raise(name):
    """The switches that raised on set before the mesh slice (the JAX
    package takes them) are set now, alongside ``chunked_ce``, as in the
    JAX package; an unknown name still raises and sets nothing."""
    jopts.set_opts([name])
    topts.set_opts(["chunked_ce", name])
    assert topts.enabled(name) and topts.enabled("chunked_ce")
    topts.reset()
    with pytest.raises(ValueError, match="unknown opt"):
        topts.set_opts(["chunked_ce", name, "nope"])
    assert not any(topts.OPTS.values())


# ----------------------------------------------------------- parity

@pytest.mark.parametrize("chunk", [512, 5, 4], ids=["one", "three",
                                                    "ragged"])
@pytest.mark.parametrize("fam", list(ARCHS))
def test_chunked_loss_and_grads_match_jax(pairs, fam, chunk):
    """``_loss_chunked`` at ``chunk`` (15 predicting positions: one chunk,
    three of 5, or four of 4 with the last one 3 real and 1 padded): the
    loss, "ce" and the LoRA gradients within 1e-4 of JAX's, and within
    1e-4 of the port's plain loss."""
    jm, jp, tm, tp, js, ts = pairs[fam]
    jb, tb = _batch(tm.cfg)
    (jl, jmet), jg = jax.value_and_grad(lambda lo: jm._loss_chunked(
        jp, jb, dataclasses.replace(js, lora=lo), chunk=chunk),
        has_aux=True)(js.lora)
    tl, tmet, tg = _port_grads(tm, tp, ts, tb, lambda m, p, b, a:
                               m._loss_chunked(p, b, a, chunk=chunk))
    _close(tl, jl)
    _close(tmet["ce"], jmet["ce"])
    for g, w in zip(tg, jax.tree.leaves(jg), strict=True):
        _close(g, w)
    pl, _, pg = _port_grads(tm, tp, ts, tb,
                            lambda m, p, b, a: m.loss(p, b, a))
    _close(tl, pl.detach().numpy())
    for g, w in zip(tg, pg):
        _close(g, w.numpy())


@pytest.mark.parametrize("fam", list(ARCHS))
def test_switch_routes_loss_as_jax(pairs, fam, monkeypatch):
    """With the switch on, ``loss`` is JAX's ``loss`` with its switch on,
    and goes through ``_loss_chunked`` at the default chunk."""
    jm, jp, tm, tp, js, ts = pairs[fam]
    jb, tb = _batch(tm.cfg, seed=8)
    jopts.set_opts(["chunked_ce"])
    topts.set_opts(["chunked_ce"])
    want, _ = jm.loss(jp, jb, adapters=js)
    calls = []
    orig = tapi.Model._loss_chunked

    def spy(self, *args, **kw):
        calls.append(kw.get("chunk", 512))
        return orig(self, *args, **kw)

    monkeypatch.setattr(tapi.Model, "_loss_chunked", spy)
    got, _ = tm.loss(tp, tb, adapters=ts)
    assert calls == [512]
    _close(got, want)


def test_encoder_ignores_the_switch(monkeypatch):
    """The MLM branch comes first: roberta's loss is the same with the
    switch on, bit for bit, and never reaches ``_loss_chunked``."""
    m = tapi.build_model(tconfigs.get_config("roberta-large").reduced(
        d_model=D, vocab_size=VOCAB))
    p = m.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, VOCAB, (2, S)).astype(np.int32))
    off, _ = m.loss(p, {"tokens": toks})
    topts.set_opts(["chunked_ce"])
    monkeypatch.setattr(tapi.Model, "_loss_chunked", None)
    on, _ = m.loss(p, {"tokens": toks})
    assert torch.equal(on, off)


@pytest.mark.parametrize("chunked", [False, True], ids=["plain", "chunked"])
def test_no_saved_tensor_holds_the_logits(chunked):
    """Every tensor autograd saves for the backward of a LoRA loss on a
    reduced VLM (vocab 1000, padded to 1024, apart from every other
    width; 2 x (8 + 16) positions, 15 predicting), recorded by a
    ``saved_tensors_hooks`` probe: under the switch none has the padded
    vocabulary as its last dim and more than b x 15 x V / 3 elements (the
    chunks' logits are recomputed in the backward, never saved); the
    plain loss, the control, saves the (b, 15, V) logits."""
    tm = tapi.build_model(tconfigs.get_config("paligemma-3b").reduced(
        d_model=D, vocab_size=1000))
    gen = torch.Generator().manual_seed(0)
    tp = tm.init(gen, "cpu")
    ts = tlora.init_adapter_set(tp, gen, tbase.LoRAConfig(rank=4),
                                n_clients=2)
    _, tb = _batch(tm.cfg, seed=9)
    if chunked:
        topts.set_opts(["chunked_ce"])
    b, v = 2, tm.vocab_padded
    assert v == 1024 and v not in (D, 4 * D, tapi.PATCH_EMBED_DIM)
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                      ts.lora)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = tm.loss(tp, tb, dataclasses.replace(ts, lora=leaves))
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    big = [s for s in saved
           if s and s[-1] == v and np.prod(s) > b * (S - 1) * v // 3]
    if chunked:
        assert big == [], big
    else:
        assert (b, S - 1, v) in big


# ------------------------------------------------------------ training

def test_trainer_rounds_with_the_switch_match_jax(pairs):
    """2 rounds of ``run`` on the dense model (2 clients x 2 local steps of
    2 x 16, fedsa + sfedlora, SGD) with the switch on in both packages:
    loss, grad-norm and the LoRA leaves within 1e-4 of JAX's."""
    jm, jp, tm, *_ = pairs["dense"]
    n = 2
    ds_kw = dict(seq_len=S, batch_per_client=2, seed=0)

    def kw(mod):
        return dict(lora_cfg=mod.LoRAConfig(rank=4, alpha=8.0),
                    fed_cfg=mod.FederatedConfig(num_clients=n,
                                                local_steps=2),
                    opt_cfg=mod.OptimizerConfig(name="sgd", lr=0.5), seed=0)

    jopts.set_opts(["chunked_ce"])
    topts.set_opts(["chunked_ce"])
    jtr = jfed.FederatedTrainer(jm, jsyn.FederatedDataset(VOCAB, n, **ds_kw),
                                **kw(jbase), base_params=jp)
    ttr = tfed.FederatedTrainer(
        tapi.build_model(tm.cfg), tsyn.FederatedDataset(VOCAB, n, **ds_kw),
        **kw(tbase), base_params=_np(jp),
        lora_init=jax.tree.map(lambda x: np.asarray(x[0]), jtr.lora),
        device="cpu")
    jtr.run(2)
    ttr.run(2)
    for th, jh in zip(ttr.history, jtr.history, strict=True):
        for key in ("loss", "grad_norm"):
            _close(th[key], jh[key])
    for g, w in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora),
                    strict=True):
        _close(g, w)
