"""repro_torch's VLM family (paligemma-3b: precomputed SigLIP patches
projected by ``patch_proj`` and prepended to the tokens) against the JAX
package, on the CPU.

The reduced paligemma-3b (d_model 64: 4 heads on 1 kv head of 16, 2
layers, GeGLU, vocab 256, 8 patches of 1152).  The weights are the JAX
``Model.init`` draw and the adapters JAX's ``init_adapter_set`` draws (B
made nonzero), carried across with ``params_from_numpy``; every other
input comes from a numpy seed.

Held within 1e-4 (relative to max(1, max|ref|)):
- ``_embed`` (the projected patches, then the token embeddings) and
  ``forward`` logits with no adapters, one AdapterSet and a banked set, the
  positions spanning the patches and the text (RoPE over the whole
  sequence, the prefix causal, as in JAX);
- ``loss`` over the text segment and the LoRA gradients of every leaf;
- 2 rounds of ``round_step`` over caller-made ``{"tokens", "patches"}``
  batches: loss, grad-norm and every LoRA leaf.
Exactly: the serve CLI's tokens, fixed and scheduled, both CLIs serving
one checkpoint written by the JAX trainer (serving reads no patches, in
either package); the train CLI's ``KeyError('patches')``, as JAX's.

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
from repro.launch import serve as jserve                       # noqa: E402
from repro.launch import train as jtrain                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint import io as tio                   # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy        # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.kernels import dispatch                       # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.launch import train as ttrain                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.tree import tree_leaves, tree_map              # noqa: E402

ARCH = "paligemma-3b"
TOL = 1e-4
VOCAB = 256
D = 64
P = 8                                   # the reduced config's patches


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


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params, jax sets, port
    sets, jax bank, port bank), built once: two tenants of ranks 4 and 8
    with nonzero B."""
    jcfg, tcfg = (c.get_config(ARCH).reduced(d_model=D, vocab_size=VOCAB)
                  for c in (jconfigs, tconfigs))
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


def _batch(b, s, seed=3):
    """(jax batch, port batch) of tokens (b, s) and patches (b, P, 1152)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, (b, s)).astype(np.int32)
    patches = rng.standard_normal((b, P, tapi.PATCH_EMBED_DIM)).astype(
        np.float32)
    return ({"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)},
            {"tokens": torch.from_numpy(toks),
             "patches": torch.from_numpy(patches)})


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


# ------------------------------------------------------------------ pieces

def test_config_and_patch_proj_follow_the_jax_tree(models):
    for red in (False, True):
        j, t = (c.get_config(ARCH) for c in (jconfigs, tconfigs))
        if red:
            j, t = j.reduced(), t.reduced()
        j, t = dataclasses.asdict(j), dataclasses.asdict(t)
        j.pop("use_pallas")
        assert j == t
    assert tconfigs.get_config(ARCH).reduced().num_patches == P
    assert ARCH in tconfigs.ARCHS and tconfigs.NOT_YET_PORTED == ()
    assert tapi.PATCH_EMBED_DIM == japi.PATCH_EMBED_DIM == 1152
    jm, _, tm, *_ = models
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert _shapes(tp) == _shapes(jax.eval_shape(jm.init,
                                                 jax.random.key(0)))
    proj = tp["patch_proj"]
    assert tuple(proj.shape) == (1152, D) and proj.dtype == torch.float32
    # N(0, 1) scaled by 1152^-0.5, as JAX draws it
    assert abs(float(proj.std()) * 1152 ** 0.5 - 1.0) < 0.02
    # no LoRA target: init_lora draws no adapter for it
    assert "patch_proj" not in tlora.init_lora(
        tp, torch.Generator().manual_seed(1), tbase.LoRAConfig())


def test_embed_and_positions_span_the_prefix(models):
    jm, jp, tm, tp, *_ = models
    jb, tb = _batch(2, 6)
    x = tm._embed(tp, tb)
    assert tuple(x.shape) == (2, P + 6, D)
    _close(x, jm._embed(jp, jb))
    _close(x[:, :P], tb["patches"] @ tp["patch_proj"])
    _close(x[:, P:], tp["embed"][tb["tokens"]])
    pos = tm._positions(x)
    assert pos.tolist() == [list(range(P + 6))] * 2
    # a batch without patches raises KeyError('patches') in both packages
    for m, p, b in ((jm, jp, {"tokens": jb["tokens"]}),
                    (tm, tp, {"tokens": tb["tokens"]})):
        with pytest.raises(KeyError, match="patches"):
            m.forward(p, b)


@pytest.mark.parametrize("adapters", ["none", "set", "banked"])
def test_forward_matches_jax(models, adapters):
    """Logits over the patches and the text within 1e-4 of JAX's (RoPE from
    position 0 at the first patch); other patches move the text's
    logits."""
    jm, jp, tm, tp, jsets, tsets, jbank, tbank = models
    jb, tb = _batch(3, 7, seed=4)
    ids = np.asarray([1, 0, 1], np.int32)
    jad, tad = {"none": (None, None), "set": (jsets[1], tsets[1]),
                "banked": (jbank.requests(jnp.asarray(ids)),
                           tbank.requests(ids))}[adapters]
    want, _ = jm.forward(jp, jb, adapters=jad)
    got, aux = tm.forward(tp, tb, adapters=tad)
    assert tuple(got.shape) == (3, P + 7, VOCAB) and float(aux) == 0.0
    _close(got, want)
    zeroed, _ = tm.forward(tp, {**tb, "patches": torch.zeros_like(
        tb["patches"])}, adapters=tad)
    assert float((zeroed[:, P:] - got[:, P:]).abs().max()) > 1e-3


def test_loss_and_lora_grads_match_jax(models):
    jm, jp, tm, tp, jsets, tsets, *_ = models
    jb, tb = _batch(2, 9, seed=6)
    js = jsets[0]
    (jl, jmet), jg = jax.value_and_grad(lambda lo: jm.loss(
        jp, jb, adapters=dataclasses.replace(js, lora=lo)),
        has_aux=True)(js.lora)
    leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                      tsets[0].lora)
    dispatch.reset_stats()
    tl, tmet = tm.loss(tp, tb, adapters=dataclasses.replace(tsets[0],
                                                            lora=leaves))
    assert dispatch.stats["lora_matmul"] == 2 * tm.cfg.num_layers
    _close(tl, jl)
    _close(tmet["ce"], jmet["ce"])
    grads = torch.autograd.grad(tl, tree_leaves(leaves))
    for g, w in zip(grads, jax.tree.leaves(jg), strict=True):
        assert float(np.abs(np.asarray(w)).max()) > 0
        _close(g, w)


# ------------------------------------------------------------ round_step

def _trainer_kw(mod, n):
    return dict(lora_cfg=mod.LoRAConfig(rank=4, alpha=8.0,
                                        scaling="sfedlora"),
                fed_cfg=mod.FederatedConfig(num_clients=n, local_steps=2,
                                            aggregation="fedsa"),
                opt_cfg=mod.OptimizerConfig(name="sgd", lr=0.5), seed=0)


def test_round_step_with_patches_matches_jax(models):
    """2 rounds of ``round_step`` (2 clients x 2 local steps of 2 x (8
    patches + 8 tokens), fedsa + sfedlora, SGD): loss, grad-norm and every
    LoRA leaf within 1e-4 of JAX's; ``patch_proj`` takes no adapter and
    stays as it was."""
    jm, jp, tm, *_ = models
    n = 2
    ds_kw = dict(seq_len=8, batch_per_client=2, seed=0)
    jtr = jfed.FederatedTrainer(jm, jsyn.FederatedDataset(VOCAB, n, **ds_kw),
                                **_trainer_kw(jbase, n), base_params=jp)
    ttr = tfed.FederatedTrainer(
        tapi.build_model(tm.cfg), tsyn.FederatedDataset(VOCAB, n, **ds_kw),
        **_trainer_kw(tbase, n), base_params=_np(jp),
        lora_init=jax.tree.map(lambda x: np.asarray(x[0]), jtr.lora),
        device="cpu")
    proj = ttr.base["patch_proj"].clone()
    rng = np.random.default_rng(12)
    ja, jo, ta, to = jtr.adapters, jtr.opt_state, ttr.adapters, ttr.opt_state
    dispatch.reset_stats()
    for r in range(2):
        toks = rng.integers(0, VOCAB, (n, 2, 2, 8)).astype(np.int32)
        patches = rng.standard_normal((n, 2, 2, P, 1152)).astype(np.float32)
        ja, jo, jmet = jtr.round_step(jtr.base, ja, jo,
                                      {"tokens": jnp.asarray(toks),
                                       "patches": jnp.asarray(patches)},
                                      jnp.asarray(r))
        ta, to, tmet = ttr.round_step(ttr.base, ta, to,
                                      {"tokens": torch.from_numpy(toks),
                                       "patches": torch.from_numpy(patches)},
                                      r)
        for key in ("loss", "grad_norm"):
            _close(tmet[key], jmet[key])
    # q and v of the 2 layers, per client local step, in the forward and
    # in the backward's recompute
    assert dispatch.stats["lora_matmul"] == 2 * 2 * 2 * n * 2 * 2
    for g, w in zip(tree_leaves(ta.lora), jax.tree.leaves(ja.lora),
                    strict=True):
        _close(g, w)
    assert max(float(b.abs().max()) for b in tree_leaves(
        tlora.split_ab(ta.lora)[1])) > 0
    assert torch.equal(ttr.base["patch_proj"], proj)


# ------------------------------------------------------------------ CLIs

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A checkpoint written by the JAX trainer for the CLIs' reduced
    paligemma-3b (2 clients), with B drawn nonzero so that serving applies
    the adapters; ``patch_proj`` travels in the base like any leaf."""
    cfg = jconfigs.get_config(ARCH).reduced()
    m = japi.build_model(cfg)
    tr = jfed.FederatedTrainer(
        m, jsyn.FederatedDataset(cfg.vocab_size, 2, seq_len=16,
                                 batch_per_client=4, seed=0),
        **_trainer_kw(jbase, 2))
    rng = np.random.default_rng(9)
    tr.lora = {**tr.lora, "stack": jax.tree.map(
        lambda x: jnp.asarray(x + 0.05 * rng.standard_normal(x.shape)
                              .astype(np.float32)), tr.lora["stack"])}
    path = str(tmp_path_factory.mktemp("ck") / "paligemma.npz")
    tr.save(path)
    base, _ = tio.load_adapter_state(path, device="cpu")
    np.testing.assert_array_equal(base["patch_proj"].numpy(),
                                  np.asarray(tr.base["patch_proj"]))
    return path


@pytest.mark.parametrize("extra", [[], ["--arrival-trace", "poisson:50:5"]],
                         ids=["fixed", "scheduled"])
def test_serve_cli_tokens_match_jax(checkpoint, extra, monkeypatch, capsys):
    """Both serve CLIs serving the JAX checkpoint: the same tokens, the
    fixed batch from the port CLI's prompt, the scheduled stream from the
    seeded requests both CLIs make.  Neither reads patches."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
            "--resume", checkpoint] + extra
    got = tserve.main(argv + ["--device", "cpu"])
    if extra:
        want = jserve.main(argv)
        assert [r.tokens for r in got] == [r.tokens for r in want]
        assert all(len(r.tokens) == 3 for r in got)
    else:
        prompt = got[:, :4].numpy()

        def randint(key, shape, lo, hi):
            assert tuple(shape) == prompt.shape and hi == 512
            return jnp.asarray(prompt)

        monkeypatch.setattr(jax.random, "randint", randint)
        want = jserve.main(argv)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert f"# {ARCH}" in capsys.readouterr().out


def test_train_cli_fails_on_patches_as_jax_does():
    """The federated dataset is tokens-only: both train CLIs fail at the
    first local step with the same KeyError('patches')."""
    argv = ["--arch", ARCH, "--reduced", "--rounds", "1", "--seq", "8",
            "--clients", "2"]
    with pytest.raises(KeyError, match="patches") as want:
        jtrain.main(argv)
    with pytest.raises(KeyError, match="patches") as got:
        ttrain.main(argv + ["--device", "cpu"])
    assert got.value.args == want.value.args == ("patches",)
