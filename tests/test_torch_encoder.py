"""repro_torch's encoder family (roberta-large: a bidirectional forward and
the MLM loss) against the JAX package, on the CPU.

The reduced roberta-large (d_model 64: 4 heads of 16, 2 layers, vocab
256, LayerNorm, GELU).  The weights are the JAX ``Model.init`` draw and
the adapters JAX's ``init_adapter_set`` draws (B made nonzero), carried
across with ``params_from_numpy``; every other input comes from a numpy
seed.

Held within 1e-4 (relative to max(1, max|ref|)):
- ``forward`` logits with no adapters, one AdapterSet and a banked set;
  a later token moves position 0's logits, in both packages;
- the MLM ``loss`` and the LoRA gradients of every leaf;
- 2 rounds of ``run_round`` with adamw over a Dirichlet(0.5) partition
  (the accuracy table's encoder setting): loss, grad-norm, every LoRA leaf
  and the held-out perplexity;
- the train CLI's round lines and final perplexity, both CLIs resumed from
  one checkpoint written by the JAX trainer (to the 4 decimals printed).
Exactly: the serve CLI's tokens, fixed and scheduled, both CLIs serving
that checkpoint (the encoder decodes causally there, as in JAX).

Tolerance, with its reason: fp32 on both sides, sums taken in another
order by XLA and by PyTorch's CPU kernels."""
import dataclasses
import re

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

ARCH = "roberta-large"
TOL = 1e-4
VOCAB = 256
D = 64


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


def _tokens(b, s, seed=3):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, s)).astype(
        np.int32)


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


# ------------------------------------------------------------------ pieces

def test_config_and_params_follow_the_jax_tree(models):
    for red in (False, True):
        j, t = (c.get_config(ARCH) for c in (jconfigs, tconfigs))
        if red:
            j, t = j.reduced(), t.reduced()
        j, t = dataclasses.asdict(j), dataclasses.asdict(t)
        j.pop("use_pallas")
        assert j == t
    assert ARCH in tconfigs.ARCHS and tconfigs.NOT_YET_PORTED == ()
    jm, _, tm, *_ = models
    assert tm.vocab_padded == jm.vocab_padded == 256
    assert tapi.build_model(tconfigs.get_config(ARCH)).vocab_padded == 50432
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert _shapes(tp) == _shapes(jax.eval_shape(jm.init,
                                                 jax.random.key(0)))


@pytest.mark.parametrize("adapters", ["none", "set", "banked"])
def test_forward_is_bidirectional_and_matches_jax(models, adapters):
    """Logits within 1e-4 of JAX's; changing the last token moves position
    0's logits in both packages (a causal forward would leave them)."""
    jm, jp, tm, tp, jsets, tsets, jbank, tbank = models
    toks = _tokens(3, 10)
    ids = np.asarray([1, 0, 1], np.int32)
    jad, tad = {"none": (None, None), "set": (jsets[1], tsets[1]),
                "banked": (jbank.requests(jnp.asarray(ids)),
                           tbank.requests(ids))}[adapters]
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, adapters=jad)
    got, aux = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                          adapters=tad)
    assert float(aux) == 0.0
    _close(got, want)
    other = toks.copy()
    other[:, -1] = (other[:, -1] + 1) % VOCAB
    jo, _ = jm.forward(jp, {"tokens": jnp.asarray(other)}, adapters=jad)
    to, _ = tm.forward(tp, {"tokens": torch.from_numpy(other)},
                       adapters=tad)
    _close(to, jo)
    for a, b in ((got.detach().numpy(), to.detach().numpy()),
                 (np.asarray(want), np.asarray(jo))):
        assert float(np.abs(a[:, 0] - b[:, 0]).max()) > 1e-4


def test_mlm_loss_and_lora_grads_match_jax(models):
    """The MLM loss (every 5th position from 2 masked to the padded
    vocabulary's last row, CE there over (masked positions) x b) and the
    LoRA gradients of every leaf; the mask's input is live (the loss with
    the mask row's embedding changed moves)."""
    jm, jp, tm, tp, jsets, tsets, *_ = models
    toks = _tokens(2, 12, seed=6)
    js = jsets[0]
    (jl, jmet), jg = jax.value_and_grad(lambda lo: jm.loss(
        jp, {"tokens": jnp.asarray(toks)},
        adapters=dataclasses.replace(js, lora=lo)), has_aux=True)(js.lora)
    leaves = tree_map(lambda x: x.detach().clone().requires_grad_(True),
                      tsets[0].lora)
    dispatch.reset_stats()
    tl, tmet = tm.loss(tp, {"tokens": torch.from_numpy(toks)},
                       adapters=dataclasses.replace(tsets[0], lora=leaves))
    assert dispatch.stats["lora_matmul"] == 2 * tm.cfg.num_layers
    assert set(tmet) == {"ce", "aux"}
    _close(tl, jl)
    _close(tmet["ce"], jmet["ce"])
    grads = torch.autograd.grad(tl, tree_leaves(leaves))
    for g, w in zip(grads, jax.tree.leaves(jg)):
        assert float(np.abs(np.asarray(w)).max()) > 0
        _close(g, w)
    # the masked positions read the mask row (vocab_padded - 1)
    tp2 = {**tp, "embed": tp["embed"].clone()}
    tp2["embed"][-1] += torch.randn(D, generator=torch.Generator()
                                    .manual_seed(0))
    moved, _ = tm.loss(tp2, {"tokens": torch.from_numpy(toks)})
    assert abs(float(moved) - float(tm.loss(tp, {"tokens": torch.from_numpy(
        toks)})[0])) > 1e-3


# ------------------------------------------------------------ training

def _trainer_kw(mod, n):
    return dict(lora_cfg=mod.LoRAConfig(rank=8, alpha=8.0,
                                        scaling="sfedlora"),
                fed_cfg=mod.FederatedConfig(num_clients=n, local_steps=2,
                                            aggregation="fedsa",
                                            partition="dirichlet",
                                            dirichlet_alpha=0.5),
                opt_cfg=mod.OptimizerConfig(name="adamw", lr=5e-3),
                seed=0)


def test_adamw_dirichlet_trajectory_matches_jax(models):
    """2 rounds of ``run_round`` (3 clients x 2 local steps of 2 x 16,
    fedsa + sfedlora, adamw, Dirichlet(0.5)): every round's loss and
    grad-norm, the LoRA leaves and the held-out perplexity within 1e-4."""
    jm, jp, tm, *_ = models
    n = 3
    ds_kw = dict(seq_len=16, batch_per_client=2, seed=0,
                 partition="dirichlet", dirichlet_alpha=0.5)
    jtr = jfed.FederatedTrainer(jm, jsyn.FederatedDataset(VOCAB, n, **ds_kw),
                                **_trainer_kw(jbase, n), base_params=jp)
    ttr = tfed.FederatedTrainer(
        tapi.build_model(tm.cfg), tsyn.FederatedDataset(VOCAB, n, **ds_kw),
        **_trainer_kw(tbase, n), base_params=_np(jp),
        lora_init=jax.tree.map(lambda x: np.asarray(x[0]), jtr.lora),
        device="cpu")
    jtr.run(2)
    ttr.run(2)
    for th, jh in zip(ttr.history, jtr.history, strict=True):
        for key in ("loss", "grad_norm"):
            _close(th[key], jh[key])
    for g, w in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)):
        _close(g, w)
    _close(ttr.eval_perplexity(batch=4), jtr.eval_perplexity(batch=4))


# ------------------------------------------------------------------ CLIs

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A checkpoint written by the JAX trainer at round 0 for the CLIs'
    reduced roberta-large (their adamw and fedsa over 2 clients), with B
    drawn nonzero so that serving applies the adapters."""
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
    path = str(tmp_path_factory.mktemp("ck") / "roberta.npz")
    tr.save(path)
    return path


_ROUND = re.compile(r"round\s+(\d+)\s+loss ([\d.]+)\s+\|g\| ([\d.e+-]+)\s+"
                    r"ppl ([\d.]+)")


def _numbers(text):
    rounds = [tuple(float(x) for x in m.groups())
              for m in _ROUND.finditer(text)]
    ppl = float(text.split("# final held-out perplexity: ")[1].split()[0])
    return rounds, ppl


def test_train_cli_matches_jax(checkpoint, capsys):
    """Both train CLIs resumed from the JAX checkpoint, 2 rounds of adamw
    over a Dirichlet(0.5) partition: the same round lines and final
    perplexity, to the printed digits."""
    argv = ["--arch", ARCH, "--reduced", "--rounds", "2", "--seq", "16",
            "--clients", "2", "--optimizer", "adamw", "--partition",
            "dirichlet", "--resume", checkpoint]
    jtrain.main(argv)
    jout = capsys.readouterr().out
    tr = ttrain.main(argv + ["--device", "cpu"])
    tout = capsys.readouterr().out
    assert tout.splitlines()[1].startswith(f"# {ARCH} (reduced)  "
                                           "strategy=fedsa scaling=sfedlora")
    (jrounds, jppl), (trounds, tppl) = _numbers(jout), _numbers(tout)
    assert len(trounds) == len(jrounds) == 2 and len(tr.history) == 2
    for (ti, *tv), (ji, *jv) in zip(trounds, jrounds):
        assert ti == ji
        # loss and ppl to 4 and 2 decimals, |g| to 4 significant digits
        np.testing.assert_allclose(tv, jv, rtol=2e-3, atol=2e-4)
    assert abs(tppl - jppl) <= 2e-3 * jppl


@pytest.mark.parametrize("extra", [[], ["--arrival-trace", "poisson:50:5"]],
                         ids=["fixed", "scheduled"])
def test_serve_cli_tokens_match_jax(checkpoint, extra, monkeypatch, capsys):
    """Both serve CLIs serving the JAX checkpoint (2 tenants): the same
    tokens, the fixed batch from the port CLI's prompt, the scheduled
    stream from the seeded requests both CLIs make.  Both decode the
    encoder causally."""
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
