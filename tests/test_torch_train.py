"""repro_torch's federated training path against the JAX package on the CPU.

The loss and its adapter gradients on reduced gemma-2b, the optimizers and
schedules step for step, the four strategies' server step, the synthetic
data stream, and the slice as a whole: 3-round trajectories of
``FederatedTrainer`` against the JAX trainer for the paper's four fig2
methods (``benchmarks/common.py:METHODS``).  JAX-drawn state (base
parameters, the ``init_lora`` draw, participation masks) is carried across
as numpy.

Tolerances, with their reason: fp32 on both sides, sums taken in another
order by XLA and by PyTorch's CPU kernels.  The loss gradients use the JAX
package's own fused-vs-reference bound (``tests/test_dispatch.py``: rtol
2e-3, atol 2e-5).  Trajectories: per-round loss and grad-norm within
1e-4 x max(1, |ref|), final adapters within 1e-4 x max(1, max|ref|) -- six
SGD steps at lr 0.5 carry the 1e-7-level differences of one step forward
without amplifying them past 1e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import aggregation as jagg                     # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.optim import optimizers as jopt                     # noqa: E402
from repro.optim import schedules as jsched                    # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy        # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import aggregation as tagg               # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.core import quant as tquant                   # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.kernels import dispatch, lora_matmul          # noqa: E402
from repro_torch.launch import train as ttrain                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.optim import optimizers as topt               # noqa: E402
from repro_torch.optim import schedules as tsched              # noqa: E402
from repro_torch.sharding import opts as topts                 # noqa: E402
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


TRAJ_RTOL = 1e-4
# the paper's fig2 methods: (strategy, scaling), benchmarks/common.py
METHODS = {"RoLoRA": ("rolora", "lora"), "FedSA-LoRA": ("fedsa", "lora"),
           "FedSA-rsLoRA": ("fedsa", "rslora"),
           "SFed-LoRA": ("fedsa", "sfedlora")}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree(rng, shapes):
    return {k: (_tree(rng, v) if isinstance(v, dict)
                else rng.standard_normal(v).astype(np.float32))
            for k, v in shapes.items()}


# -------------------------------------------------------------- Model.loss

def test_loss_and_adapter_grads_match_jax():
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()
    jm, tm = japi.build_model(jcfg), tapi.build_model(tcfg)
    jparams = jm.init(jax.random.key(0))
    tparams = params_from_numpy(_np(jparams), "cpu")
    rng = np.random.default_rng(3)
    lora = jlora.init_lora(jparams, jax.random.key(1),
                           jbase.LoRAConfig(rank=8))
    # nonzero B, so the gradients of A are not zero
    lora = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(
        x.shape).astype(np.float32), lora)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    gamma = 2.0

    def jloss(l):
        return jm.loss(jparams, {"tokens": jnp.asarray(toks)},
                       adapters=jlora.AdapterSet(lora=l, gamma=gamma))[0]

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, lora))
    leaves = params_from_numpy(lora, "cpu")
    for t in tree_leaves(leaves):
        t.requires_grad_(True)
    dispatch.reset_stats()
    tl, aux = tm.loss(tparams, {"tokens": torch.from_numpy(toks)},
                      adapters=tlora.AdapterSet(lora=leaves, gamma=gamma))
    assert dispatch.stats["lora_matmul"] == 2 * tcfg.num_layers
    assert set(aux) == {"ce", "aux"}
    grads = torch.autograd.grad(tl, tree_leaves(leaves))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3,
                               atol=2e-5)
    for got, want in zip(grads, jax.tree.leaves(jg)):
        assert float(np.abs(np.asarray(want)).max()) > 0
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-5)
    # the chunked CE (opts "chunked_ce") gives the same loss and gradients
    topts.set_opts(["chunked_ce"])
    try:
        cl, _ = tm.loss(tparams, {"tokens": torch.from_numpy(toks)},
                        adapters=tlora.AdapterSet(lora=leaves, gamma=gamma))
        cgrads = torch.autograd.grad(cl, tree_leaves(leaves))
    finally:
        topts.reset()
    np.testing.assert_allclose(float(cl.detach()), float(jl), rtol=2e-3,
                               atol=2e-5)
    for got, want in zip(cgrads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-5)


# ---------------------------------------------------- optimizers, schedules

@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"momentum": 0.9}),
    ("adamw", {"weight_decay": 0.01}),
    ("sgd", {"lr_schedule": "warmup_cosine",
             "lr_schedule_kwargs": {"warmup_steps": 2, "total_steps": 5}}),
    ("adamw", {"lr_schedule": "step",
               "lr_schedule_kwargs": {"decay": 0.5, "every": 2}}),
    ("sgd", {"grad_clip": 0.5}),
])
def test_optimizer_steps_match_jax(name, kw):
    cfg_kw = dict(name=name, lr=0.05, **kw)
    jo = jopt.make_optimizer(jbase.OptimizerConfig(**cfg_kw))
    to = topt.make_optimizer(tbase.OptimizerConfig(**cfg_kw))
    rng = np.random.default_rng(5)
    shapes = {"q": {"a": (3, 6), "b": (5, 3)}, "v": {"a": (3, 6)}}
    params = _tree(rng, shapes)
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params,
                                                                   "cpu")
    js, ts = jo[0](jp), to[0](tp)
    assert set(js) == set(ts)
    for _ in range(5):
        grads = _tree(rng, shapes)
        jg, tg = jax.tree.map(jnp.asarray, grads), params_from_numpy(grads,
                                                                     "cpu")
        if kw.get("grad_clip"):
            jg = jopt.clip_by_global_norm(jg, kw["grad_clip"])
            tg = topt.clip_by_global_norm(tg, kw["grad_clip"])
        np.testing.assert_allclose(float(topt.global_norm(tg)),
                                   float(jopt.global_norm(jg)), rtol=1e-6)
        ju, js = jo[1](jg, js, jp)
        tu, ts = to[1](tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-7)
        assert int(ts["t"]) == int(js["t"])


@pytest.mark.parametrize("name,kw", [
    ("constant", {}), ("warmup_cosine", {"warmup_steps": 10,
                                         "total_steps": 60}),
    ("step", {"decay": 0.7, "every": 9}),
])
def test_schedules_match_jax(name, kw):
    js, ts = (jsched.make_schedule(name, 0.3, **kw),
              tsched.make_schedule(name, 0.3, **kw))
    for t in range(0, 80, 3):
        np.testing.assert_allclose(
            float(ts(torch.tensor(t, dtype=torch.int32))),
            float(js(jnp.asarray(t, jnp.int32))), rtol=1e-6, atol=1e-9)


# --------------------------------------------------------------- strategies

@pytest.mark.parametrize("strategy", ["fedit", "ffa", "fedsa", "rolora"])
@pytest.mark.parametrize("weighted", [False, True])
def test_strategy_aggregate_matches_jax(strategy, weighted):
    rng = np.random.default_rng(9)
    n = 4
    stacked = _tree(rng, {"l0": {"q": {"a": (n, 2, 3, 8), "b": (n, 2, 6, 3)}},
                          "l1": {"v": {"a": (n, 3, 8), "b": (n, 4, 3)}}})
    weights = (np.asarray([1.0, 0.0, 0.5, 2.0], np.float32) if weighted
               else None)
    js, ts = jagg.get_strategy(strategy), tagg.get_strategy(strategy)
    for round_idx in (0, 1):
        want = js.aggregate(jax.tree.map(jnp.asarray, stacked), round_idx,
                            weights=None if weights is None
                            else jnp.asarray(weights))
        got = ts.aggregate(params_from_numpy(stacked, "cpu"), round_idx,
                           weights=None if weights is None
                           else torch.from_numpy(weights))
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
        jm = js.mask_grads(jax.tree.map(jnp.asarray, stacked), round_idx)
        tm = ts.mask_grads(params_from_numpy(stacked, "cpu"), round_idx)
        for g, w in zip(tree_leaves(tm), jax.tree.leaves(jm)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        tstacked = params_from_numpy(stacked, "cpu")
        assert (ts.upload_bytes(tstacked, round_idx)
                == js.upload_bytes(stacked, round_idx))
        np.testing.assert_array_equal(
            ts.upload_bytes_per_client(tstacked, round_idx, ranks=(1, 2, 3, 3)),
            js.upload_bytes_per_client(stacked, round_idx, ranks=(1, 2, 3, 3)))
        receive = np.asarray([True, False, True, True])
        fa, fb = js.agg_leaf_flags(round_idx)
        want = jagg.combine_received(jax.tree.map(jnp.asarray, stacked), want,
                                     jnp.asarray(receive), fa, fb)
        got = tagg.combine_received(tstacked, got, torch.from_numpy(receive),
                                    *ts.agg_leaf_flags(round_idx))
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def test_unported_strategies_and_async_fields_raise():
    """The async fields and the buffered wrapper were unported and raised;
    they are ported now (``tests/test_torch_faults.py`` holds them against
    the JAX package), so this checks that they build what JAX's do."""
    s = tagg.buffered("fedsa", buffer_size=2)
    assert isinstance(s, tagg.BufferedStrategy)
    assert (s.name, s.buffer_size) == (jagg.buffered("fedsa").name, 2)
    fed = tbase.FederatedConfig(buffer_size=2, staleness_beta=1.0)
    jfed_cfg = jbase.FederatedConfig(buffer_size=2, staleness_beta=1.0)
    assert dataclasses.asdict(fed) == dataclasses.asdict(jfed_cfg)


# --------------------------------------------------------------------- data

@pytest.mark.parametrize("partition", ["iid", "dirichlet"])
def test_federated_dataset_is_bit_identical(partition):
    kw = dict(seq_len=12, batch_per_client=3, partition=partition,
              dirichlet_alpha=0.3, seed=4)
    jd = jsyn.FederatedDataset(97, 5, **kw)
    td = tsyn.FederatedDataset(97, 5, **kw)
    for _ in range(3):
        np.testing.assert_array_equal(td.round_batch(2), jd.round_batch(2))
    np.testing.assert_array_equal(td.eval_batch(16), jd.eval_batch(16))
    np.testing.assert_array_equal(td.size_weights, jd.size_weights)
    assert td.rng_state() == jd.rng_state()
    assert td.partition_state() == jd.partition_state()


# ------------------------------------------------------- the slice as whole

N_CLIENTS, ROUNDS = 3, 3


@pytest.fixture(scope="module")
def small():
    """A narrow reduced gemma-2b (2 layers, d_model 64, vocab 256) and its
    JAX-drawn base parameters."""
    jcfg = jconfigs.get_config("gemma-2b").reduced(d_model=64, vocab_size=256)
    tcfg = tconfigs.get_config("gemma-2b").reduced(d_model=64, vocab_size=256)
    jm = japi.build_model(jcfg)
    return jcfg, tcfg, jm, jm.init(jax.random.key(0))


def _trainers(small, strategy, scaling, *, n=N_CLIENTS, participation=1.0):
    jcfg, tcfg, jm, jparams = small
    lcfg = dict(rank=8, alpha=8.0, scaling=scaling)
    fcfg = dict(num_clients=n, local_steps=2, aggregation=strategy,
                participation=participation)
    ocfg = dict(name="sgd", lr=0.5)
    ds_kw = dict(seq_len=16, batch_per_client=2, seed=0)
    jtr = jfed.FederatedTrainer(
        jm, jsyn.FederatedDataset(jcfg.vocab_size, n, **ds_kw),
        lora_cfg=jbase.LoRAConfig(**lcfg),
        fed_cfg=jbase.FederatedConfig(**fcfg),
        opt_cfg=jbase.OptimizerConfig(**ocfg), seed=0, base_params=jparams,
        track_stability=True)
    lora1 = jax.tree.map(lambda x: np.asarray(x[0]), jtr.lora)
    ttr = tfed.FederatedTrainer(
        tapi.build_model(tcfg),
        tsyn.FederatedDataset(tcfg.vocab_size, n, **ds_kw),
        lora_cfg=tbase.LoRAConfig(**lcfg),
        fed_cfg=tbase.FederatedConfig(**fcfg),
        opt_cfg=tbase.OptimizerConfig(**ocfg), seed=0,
        base_params=_np(jparams), lora_init=lora1, device="cpu",
        track_stability=True)
    assert ttr.gamma == jtr.gamma
    return jtr, ttr


def _assert_same_run(jtr, ttr):
    assert len(ttr.history) == len(jtr.history) == ROUNDS
    for th, jh in zip(ttr.history, jtr.history):
        assert set(th) == set(jh)
        for key in ("loss", "grad_norm", "update_norm"):
            assert abs(th[key] - jh[key]) <= TRAJ_RTOL * max(1.0,
                                                             abs(jh[key])), \
                (key, th, jh)
    for got, want in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=TRAJ_RTOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("method", list(METHODS))
def test_trainer_trajectory_matches_jax(small, method):
    strategy, scaling = METHODS[method]
    jtr, ttr = _trainers(small, strategy, scaling)
    jtr.run(ROUNDS)
    lora_matmul.reset_launches()
    dispatch.reset_stats()
    ttr.run(ROUNDS)
    # every adapted projection of every local step took the Function,
    # twice: the forward, and the backward's recompute of its repeat unit
    n_proj = 2 * small[1].num_layers
    assert dispatch.stats == {"bgmv": 0, "plain": 0, "lora_matmul":
                              2 * n_proj * N_CLIENTS * 2 * ROUNDS, "quant": 0,
                              "paged": 0}
    _assert_same_run(jtr, ttr)
    b_max = max(float(t.abs().max()) for t in tree_leaves(
        tlora.split_ab(ttr.lora)[1]))
    assert b_max > 0, "B stayed zero: no training happened"
    np.testing.assert_allclose(ttr.eval_perplexity(batch=8),
                               jtr.eval_perplexity(batch=8), rtol=1e-4)


def test_trainer_with_injected_participation_matches_jax(small):
    """Partial participation: the JAX engine's draws (its carried key,
    split per round as in ``make_run_chunk``) are injected into the port's
    rounds."""
    n, p = 4, 0.5
    jtr, ttr = _trainers(small, "fedsa", "sfedlora", n=n, participation=p)
    num_sampled = max(1, int(round(p * n)))
    key = jax.random.key(0 + 31337)
    parts = []
    for _ in range(ROUNDS):
        key, k_round = jax.random.split(key)
        _, k_sample = jax.random.split(k_round)
        parts.append(np.asarray(jfed.participation_weights(k_sample, n,
                                                           num_sampled)))
    assert any(not part.all() for part in parts)
    jtr.run(ROUNDS)
    for part in parts:
        ttr.run_round(weights=part)
    _assert_same_run(jtr, ttr)


def test_participation_weights_sample_without_replacement():
    gen = torch.Generator().manual_seed(3)
    for _ in range(5):
        w = tfed.participation_weights(gen, 7, 3)
        assert w.dtype == torch.float32 and float(w.sum()) == 3.0
        assert set(w.tolist()) <= {0.0, 1.0}


def test_adapter_api_for_training(small):
    _, tcfg, _, jparams = small
    model = tapi.build_model(tcfg)
    gen = torch.Generator().manual_seed(0)
    tree = tlora.lora_tree_for_model(model, gen, tbase.LoRAConfig(rank=4),
                                     device="cpu")
    want = jlora.lora_tree_for_model(japi.build_model(small[0]),
                                     jax.random.key(0),
                                     jbase.LoRAConfig(rank=4))
    assert jax.tree.map(lambda x: tuple(x.shape), want) == \
        {k: v for k, v in _shapes(tree).items()}
    assert tlora.num_lora_params(tree) == jlora.num_lora_params(want)
    a_only, b_only = tlora.split_ab(tree)
    assert set(tree_leaves(_shapes(a_only))) == set(
        tree_leaves(_shapes({"x": {"a": t} for t in
                             tree_leaves(jlora.split_ab(want)[0])})))
    sets = [tlora.AdapterSet(lora=tree, gamma=1.0, rank=4,
                             rank_mask=np.array([1, 1, 0, 0], np.float32)),
            tlora.AdapterSet(lora=tree, gamma=2.0, rank=4)]
    stacked = tlora.AdapterSet.stack(sets)
    assert isinstance(stacked.gamma, np.ndarray)
    np.testing.assert_array_equal(stacked.rank_mask,
                                  [[1, 1, 0, 0], [1, 1, 1, 1]])
    assert stacked.client(0).rank_mask.tolist() == [1, 1, 0, 0]
    back = stacked.unstack()
    assert [s.gamma for s in back] == [1.0, 2.0]
    for got, want_ in zip(tree_leaves(back[1].lora), tree_leaves(tree)):
        assert torch.equal(got, want_)
    assert stacked.num_params() == 2 * tlora.num_lora_params(tree)


def _shapes(tree):
    return {k: (_shapes(v) if isinstance(v, dict) else tuple(v.shape))
            for k, v in tree.items()}


def test_trainer_rejects_unported_modes(small):
    _, tcfg, _, _ = small
    model = tapi.build_model(tcfg)
    ds = tsyn.FederatedDataset(tcfg.vocab_size, 2, seq_len=8,
                               batch_per_client=1)
    kw = dict(lora_cfg=tbase.LoRAConfig(), fed_cfg=tbase.FederatedConfig(
        num_clients=2), opt_cfg=tbase.OptimizerConfig(), device="cpu")
    # the one mode still refused on a mesh: a packed base
    packed = tquant.quantize_tree(model.init(torch.Generator().manual_seed(0),
                                             "cpu"), "int8", 64)
    with pytest.raises(NotImplementedError, match="packed base on a mesh"):
        tfed.FederatedTrainer(model, ds, **kw, base_params=packed,
                              mesh=object())


# ---------------------------------------------------------------------- CLI

def test_cli_trains_on_cpu(capsys):
    tr = ttrain.main(["--reduced", "--device", "cpu", "--rounds", "2",
                      "--seq", "16", "--clients", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# gemma-2b (reduced)  strategy=fedsa "
                             "scaling=sfedlora gamma=")
    assert [line.split()[:2] for line in out[1:3]] == [["round", "1"],
                                                      ["round", "2"]]
    assert out[-1].startswith("# final held-out perplexity: ")
    assert len(tr.history) == 2
    assert all(np.isfinite(h["loss"]) for h in tr.history)


@pytest.mark.parametrize("flags", [
    # the ids name the cases before the hybrid, device data, the MoE
    # family, xLSTM, whisper, roberta and paligemma were ported
    pytest.param(["--arch", "roberta-large"], id="--arch-hybrid"),
    ["--mesh", "4x2"],
    pytest.param(["--arch", "whisper-medium"], id="--data-mode"),
    pytest.param(["--arch", "paligemma-3b"], id="--arch"),
], ids=lambda f: f[0])
def test_cli_unported_flags_raise(flags, capsys):
    """``--mesh`` runs now (the mesh slice): without a launcher the CLI
    starts a group of one, and a 4x2 mesh over it raises, naming both
    sizes.  Of the archs, ported since,
    roberta-large trains through its MLM loss, and whisper-medium and
    paligemma-3b fail as the JAX CLI does: the federated dataset is
    tokens-only, so the first local step finds no frames, or no
    patches."""
    argv = ["--reduced", "--device", "cpu", "--rounds", "1", *flags]
    missing = {"whisper-medium": "frames", "paligemma-3b": "patches"}
    if flags[-1] in missing:
        with pytest.raises(KeyError, match=missing[flags[-1]]):
            ttrain.main(argv + ["--seq", "8", "--clients", "2"])
    elif flags[-1] in tconfigs.ARCHS:
        tr = ttrain.main(argv + ["--seq", "8", "--clients", "2"])
        assert len(tr.history) == 1 and np.isfinite(tr.history[0]["loss"])
        assert "# final held-out perplexity: " in capsys.readouterr().out
    else:
        with pytest.raises(ValueError, match="mesh '4x2' has 8 devices but "
                           "the process group's world size is 1"):
            ttrain.main(argv)
        assert not torch.distributed.is_initialized()


def test_jax_cli_fails_on_whisper_as_the_port_does():
    """The reference the case above holds the port to: JAX's train CLI on
    whisper-medium raises KeyError('frames') too."""
    from repro.launch import train as jtrain
    with pytest.raises(KeyError, match="frames"):
        jtrain.main(["--arch", "whisper-medium", "--reduced", "--rounds",
                     "1", "--seq", "8", "--clients", "2"])


def test_jax_cli_fails_on_paligemma_as_the_port_does():
    """The same for paligemma-3b: JAX's train CLI raises
    KeyError('patches')."""
    from repro.launch import train as jtrain
    with pytest.raises(KeyError, match="patches"):
        jtrain.main(["--arch", "paligemma-3b", "--reduced", "--rounds",
                     "1", "--seq", "8", "--clients", "2"])


@pytest.mark.parametrize("flags", [
    ["--faults", "dropout=0.1"], ["--buffer", "2"], ["--watchdog", "2"],
    pytest.param(["--faults", "straggle=geom:0.3", "--buffer", "2"],
                 id="--faults-buffered"),
], ids=lambda f: f[0])
def test_cli_async_flags_run(flags, capsys):
    """The flags that raised "not yet ported" before the fault-tolerant
    engine was ported now run, with the JAX CLI's header suffixes."""
    tr = ttrain.main(["--reduced", "--device", "cpu", "--rounds", "2",
                      "--seq", "8", "--clients", "2", *flags])
    head = capsys.readouterr().out.splitlines()[0]
    assert len(tr.history) == 2
    assert tr.async_mode == (flags != ["--watchdog", "2"])
    assert ("buffer=" in head) == tr.async_mode
    assert ("watchdog(retries=2)" in head) == ("--watchdog" in flags)


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain.main(["--reduced", "--rounds", "1"])


def test_dataclass_fields_match_jax():
    for name in ("FederatedConfig", "OptimizerConfig"):
        jf = [f.name for f in dataclasses.fields(getattr(jbase, name))]
        tf = [f.name for f in dataclasses.fields(getattr(tbase, name))]
        assert tf == jf
