"""repro_torch's fault-tolerant federated engine against the JAX package,
on the CPU: the repaired client mean, fault injection, buffered
aggregation with screening, the Theorem 4.2 staleness correction, the
collapse watchdog and checkpoints under faults.

  * ``aggregate_clients`` equals JAX's bit for bit at N = 3, 5 and 7, with
    and without weights and rank masks (the client mean is ``sum * (1/n)``
    as JAX lowers ``mean``, and the weights' total is summed in client
    order).
  * The buffered engine at null faults and no cap is the synchronous
    engine bit for bit, for the five strategies at N = 3, under
    participation 0.5 and under Dirichlet sizes with ``weight_by_size``:
    the port's mirror of ``tests/test_conformance.py``.
  * Under the JAX engine's own draws (participation, fault masks and noise
    leaves, derived from its key stream as ``make_run_chunk`` derives
    them), 4-round faulted trajectories equal the JAX trainer's: loss,
    grad-norm, update-norm, n_eff and gamma_scale within 1e-4 x max(1,
    |ref|) a round, adapters within 1e-4 x max(1, max|ref|); the delivered,
    rejected and stale counts and gamma_eff exactly.
  * The watchdog's events (rescale and backoff) and its gamma_eff equal
    JAX's exactly.
  * The behaviour tests of ``tests/test_faults.py`` run on the port's own
    draws: chunking invariance, crash-resume, legacy checkpoints, screening
    and its negative control, the buffer cap, rollback, backoff, bounded
    retries and a quiet healthy run.

Tolerances, with their reason: fp32 on both sides, sums taken in another
order by XLA and by PyTorch's CPU kernels; the faulted runs use SGD at lr
0.05 on a 1-layer model, which carries 1e-7-level differences of a step
forward without amplifying them past 1e-5."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import base as jbase                        # noqa: E402
from repro.core import aggregation as jagg                     # noqa: E402
from repro.core import faults as jfaults                       # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro_torch.analysis.stability_check import \
    ScalingCollapseError                                       # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy        # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import aggregation as tagg               # noqa: E402
from repro_torch.core import faults as tfaults                 # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.launch import train as ttrain                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.tree import tree_leaves                        # noqa: E402

VOCAB = 64
TRAJ_RTOL = 1e-4
TINY = dict(name="faults-tiny", family="dense", num_layers=1, d_model=32,
            num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
            vocab_size=VOCAB)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small-tensor runs: the suite runs
    several workers a machine, and torch's default of one thread a core
    each makes the many tiny ops of a client loop wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """The 1-layer model of ``tests/test_faults.py`` in both packages, and
    its JAX-drawn base."""
    jm = japi.build_model(jbase.ModelConfig(**TINY))
    tm = tapi.build_model(tbase.ModelConfig(**TINY))
    return jm, tm, jm.init(jax.random.key(0))


def _cfgs(n, rank, alpha, scaling, local_steps, participation, fed_kw):
    lcfg = dict(rank=rank, alpha=alpha, scaling=scaling)
    fcfg = dict(num_clients=n, local_steps=local_steps, aggregation="fedsa",
                participation=participation)
    fcfg.update(fed_kw)
    return lcfg, fcfg, dict(name="sgd", lr=0.05)


def port_trainer(tiny, *, n=4, rank=4, alpha=8.0, scaling="sfedlora",
                 local_steps=1, chunk_rounds=0, seed=0, watchdog=None,
                 participation=1.0, lora_init=None, track_stability=False,
                 **fed_kw):
    """``tests/test_faults.py``'s ``make_trainer`` for the port."""
    _, tm, jparams = tiny
    lcfg, fcfg, ocfg = _cfgs(n, rank, alpha, scaling, local_steps,
                             participation, fed_kw)
    return tfed.FederatedTrainer(
        tm, tsyn.FederatedDataset(VOCAB, n, seq_len=8, batch_per_client=1,
                                  seed=seed),
        lora_cfg=tbase.LoRAConfig(**lcfg),
        fed_cfg=tbase.FederatedConfig(**fcfg),
        opt_cfg=tbase.OptimizerConfig(**ocfg), seed=seed,
        base_params=_np(jparams), lora_init=lora_init, device="cpu",
        chunk_rounds=chunk_rounds, watchdog=watchdog,
        track_stability=track_stability)


def trainer_pair(tiny, *, watchdog=None, faults=None, **kw):
    """The JAX trainer and the port's on the same config, the port
    starting from the JAX trainer's adapters."""
    jm, _, jparams = tiny
    n = kw.get("n", 4)
    lcfg, fcfg, ocfg = _cfgs(n, kw.get("rank", 4), kw.get("alpha", 8.0),
                             kw.get("scaling", "sfedlora"),
                             kw.get("local_steps", 1),
                             kw.get("participation", 1.0),
                             {k: v for k, v in kw.items() if k in (
                                 "buffer_size", "staleness_beta",
                                 "screen_updates", "screen_norm_mult")})
    jtr = jfed.FederatedTrainer(
        jm, jsyn.FederatedDataset(VOCAB, n, seq_len=8, batch_per_client=1,
                                  seed=0),
        lora_cfg=jbase.LoRAConfig(**lcfg),
        fed_cfg=jbase.FederatedConfig(
            **fcfg, faults=None if faults is None
            else jfaults.FaultConfig(**faults)),
        opt_cfg=jbase.OptimizerConfig(**ocfg), seed=0, base_params=jparams,
        chunk_rounds=kw.get("chunk_rounds", 0), track_stability=True,
        watchdog=None if watchdog is None else jfed.WatchdogConfig(**watchdog))
    ttr = port_trainer(
        tiny, lora_init=jax.tree.map(lambda x: np.asarray(x[0]), jtr.lora),
        track_stability=True,
        watchdog=None if watchdog is None else tfed.WatchdogConfig(**watchdog),
        faults=None if faults is None else tfaults.FaultConfig(**faults),
        **kw)
    return jtr, ttr


def jax_draws(jtr):
    """round index -> the JAX engine's draws for that round, as
    ``make_run_chunk`` derives them from the trainer's carried key (split
    once a round, participation from the second half of the round key,
    faults from the round key folded with 7, noise leaves from that folded
    with 1 and the leaf index), converted for the port.  Reads the
    trainer's config at call time, so a watchdog backoff (participation,
    fault seed) changes the draws as it changes JAX's."""
    shapes = [x.shape for x in jax.tree.leaves(jtr.lora)]
    key0 = jax.random.key(0 + 31337)

    def draws(ridx):
        fed = jtr.fed_cfg
        n = fed.num_clients
        key = key0
        for _ in range(ridx + 1):
            key, k_round = jax.random.split(key)
        _, k_sample = jax.random.split(k_round)
        out = {}
        if fed.participation < 1.0:
            out["weights"] = np.asarray(jfed.participation_weights(
                k_sample, n, max(1, int(round(fed.participation * n)))))
        if fed.faults is not None and not fed.faults.null:
            k_fault = jax.random.fold_in(k_round, 7)
            fm = jfaults.FaultModel(fed.faults)
            masks = fm.sample(k_fault, n)
            f = {k: torch.from_numpy(np.array(v)) for k, v in masks.items()}
            f["noise"] = None
            if fed.faults.corrupt > 0 and fed.faults.corrupt_mode == "noise":
                k_noise = jax.random.fold_in(k_fault, 1)
                f["noise"] = [torch.from_numpy(np.array(jax.random.normal(
                    jax.random.fold_in(k_noise, i), s, jnp.float32)))
                    for i, s in enumerate(shapes)]
            out["faults"] = f
        return out
    return draws


def assert_same_run(jtr, ttr, keys=("loss", "grad_norm", "update_norm")):
    assert len(ttr.history) == len(jtr.history)
    for th, jh in zip(ttr.history, jtr.history):
        assert set(th) == set(jh)
        for key in keys:
            assert abs(th[key] - jh[key]) <= TRAJ_RTOL * max(
                1.0, abs(jh[key])), (key, th, jh)
    for got, want in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora),
                         strict=True):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=TRAJ_RTOL * max(1.0, float(np.abs(want).max())))


def assert_state_bitequal(a, b):
    for x, y in zip(tree_leaves({"l": a.lora, "o": a.opt_state}),
                    tree_leaves({"l": b.lora, "o": b.opt_state}),
                    strict=True):
        assert torch.equal(x, y)


# ------------------------------------------------ the repaired client mean

def _stacked(rng, n):
    return {"l0": {"q": {"a": rng.standard_normal((n, 2, 8, 64)),
                         "b": rng.standard_normal((n, 2, 32, 8))}},
            "l1": {"v": {"a": rng.standard_normal((n, 8, 64)),
                         "b": rng.standard_normal((n, 16, 8))}}}


@pytest.mark.parametrize("n", [3, 5, 7])
@pytest.mark.parametrize("weights", [None, "ones", "sampled", "sizes"])
@pytest.mark.parametrize("masked", [False, True])
def test_aggregate_clients_bit_identical_to_jax(n, weights, masked):
    rng = np.random.default_rng(n)
    tree = jax.tree.map(lambda x: x.astype(np.float32), _stacked(rng, n))
    w = {None: None, "ones": np.ones(n),
         "sampled": (np.arange(n) % 2 == 0) * 1.0,
         "sizes": rng.random(n) + 0.1}[weights]
    w = None if w is None else np.asarray(w, np.float32)
    mask = ((rng.random((n, 8)) > 0.3).astype(np.float32) if masked
            else None)
    for flags in ((True, True), (True, False)):
        want = jagg.aggregate_clients(
            jax.tree.map(jnp.asarray, tree), *flags,
            weights=None if w is None else jnp.asarray(w),
            rank_mask=None if mask is None else jnp.asarray(mask))
        got = tagg.aggregate_clients(
            params_from_numpy(tree, "cpu"), *flags,
            weights=None if w is None else torch.from_numpy(w),
            rank_mask=mask)
        for g, j in zip(tree_leaves(got), jax.tree.leaves(want),
                        strict=True):
            assert np.array_equal(g.numpy(), np.asarray(j))


def test_weighted_mean_with_unit_weights_is_the_fast_path():
    """The staleness-0 identity of the buffered engine rests on it."""
    for n in (3, 5, 7):
        tree = params_from_numpy(jax.tree.map(
            lambda x: x.astype(np.float32),
            _stacked(np.random.default_rng(n), n)), "cpu")
        fast = tagg.aggregate_clients(tree, True, True)
        ones = tagg.aggregate_clients(tree, True, True,
                                      weights=torch.ones(n))
        for a, b in zip(tree_leaves(fast), tree_leaves(ones)):
            assert torch.equal(a, b)


# ------------------------------------------------------ strategy helpers

def test_per_client_screens_match_jax():
    rng = np.random.default_rng(2)
    tree = jax.tree.map(lambda x: x.astype(np.float32), _stacked(rng, 5))
    tree["l1"]["v"]["a"][1, 0, 0] = np.nan
    tree["l0"]["q"]["b"][3, 1, 2, 0] = np.inf
    jt, tt = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    np.testing.assert_array_equal(tagg.per_client_finite(tt).numpy(),
                                  np.asarray(jagg.per_client_finite(jt)))
    clean = params_from_numpy(_stacked(rng, 5), "cpu", torch.float32)
    want = jagg.per_client_norm(jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), clean))
    np.testing.assert_allclose(tagg.per_client_norm(clean).numpy(),
                               np.asarray(want), rtol=1e-6)


def test_negate_flag_and_strategy_flags_match_jax():
    assert tagg.negate_flag(True) is False and tagg.negate_flag(False) is True
    for name in ("fedit", "ffa", "fedsa", "rolora"):
        for ridx in (0, 1):
            assert (tagg.strategy_flags(name, ridx)
                    == jagg.strategy_flags(name, ridx))
    with pytest.raises(ValueError, match="not flag-expressible"):
        tagg.strategy_flags("flora", 0)


@pytest.mark.parametrize("name", ["fedit", "ffa", "fedsa", "rolora", "flora"])
def test_buffered_strategy_delegates_to_inner(name):
    s, j = tagg.buffered(name, buffer_size=2, beta=1.0), jagg.buffered(name)
    assert s.name == j.name == f"buffered:{name}"
    assert isinstance(s, tagg.BufferedStrategy) and s.inner.name == name
    for ridx in (0, 1):
        assert s.train_flags(ridx) == j.train_flags(ridx)
        assert s.agg_leaf_flags(ridx) == j.agg_leaf_flags(ridx)
    with pytest.raises(ValueError, match="buffer_size"):
        tagg.buffered(name, buffer_size=-1)
    with pytest.raises(ValueError, match="inner"):
        tagg.BufferedStrategy(name="x")


# ------------------------------------------------------------- the faults

def test_parse_faults_matches_jax():
    spec = "dropout=0.1,straggle=geom:0.3,corrupt=0.01,mode=noise,noise=5,seed=3"
    assert (dataclasses.asdict(tfaults.parse_faults(spec))
            == dataclasses.asdict(jfaults.parse_faults(spec)))
    assert tfaults.parse_faults(spec) == tfaults.FaultConfig(
        dropout=0.1, straggle=0.3, corrupt=0.01, corrupt_mode="noise",
        noise_scale=5.0, seed=3)
    assert tfaults.parse_faults("").null
    assert tfaults.parse_faults("dropout=0.1").null is False
    with pytest.raises(ValueError, match="key=value"):
        tfaults.parse_faults("dropout")
    with pytest.raises(ValueError, match="unknown --faults key"):
        tfaults.parse_faults("jitter=0.5")
    with pytest.raises(ValueError, match="in \\[0, 1\\]"):
        tfaults.parse_faults("dropout=1.5")
    with pytest.raises(ValueError, match="corrupt_mode"):
        tfaults.FaultConfig(corrupt=0.1, corrupt_mode="bitflip")


def test_fault_masks_deterministic_and_seed_dependent():
    fm = tfaults.FaultModel(tfaults.FaultConfig(dropout=0.5, straggle=0.5,
                                                corrupt=0.5))
    a = fm.sample(fm.round_generator(0, 3, "cpu"), 64)
    b = fm.sample(fm.round_generator(0, 3, "cpu"), 64)
    for k in ("drop", "straggle", "corrupt"):
        assert torch.equal(a[k], b[k])
        assert a[k].shape == (64,) and a[k].dtype == torch.bool
    other = tfaults.FaultModel(dataclasses.replace(fm.cfg, seed=1))
    for g in (other.round_generator(0, 3, "cpu"),
              fm.round_generator(1, 3, "cpu"),
              fm.round_generator(0, 4, "cpu")):
        c = fm.sample(g, 64)
        assert any(not torch.equal(a[k], c[k]) for k in a)


def test_zero_rate_masks_draw_nothing():
    fm = tfaults.FaultModel(tfaults.FaultConfig(dropout=0.5))
    gen = torch.Generator().manual_seed(0)
    masks = fm.sample(gen, 256)
    assert not masks["straggle"].any() and not masks["corrupt"].any()
    assert 0.3 < float(masks["drop"].float().mean()) < 0.7
    null = tfaults.FaultModel()
    state = gen.get_state()
    out = null.draw(gen, {"a": torch.ones(3, 2)})
    assert torch.equal(gen.get_state(), state)
    assert not any(out[k].any() for k in ("drop", "straggle", "corrupt"))
    assert out["noise"] is None


def test_corrupt_tree_nan_mode_matches_jax():
    tree = {"b": np.ones((4, 2), np.float32),
            "a": np.ones((4, 3, 2), np.float32),
            "c": {"x": np.ones((4, 5), np.float32)}}
    mask = np.asarray([True, False, True, False])
    cfg = dict(corrupt=0.5, corrupt_mode="nan")
    want = jfaults.FaultModel(jfaults.FaultConfig(**cfg)).corrupt_tree(
        jax.random.key(0), jax.tree.map(jnp.asarray, tree), jnp.asarray(mask))
    got = tfaults.FaultModel(tfaults.FaultConfig(**cfg)).corrupt_tree(
        params_from_numpy(tree, "cpu"), torch.from_numpy(mask))
    assert list(got) == list(tree)                 # key order kept
    kinds = set()
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g[1].numpy(), 1.0)
        kinds.add(str(g[0].flatten()[0].item()))
    assert kinds == {"nan", "inf"}


def test_corrupt_tree_noise_mode_matches_jax_on_its_draws():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": rng.standard_normal((4, 3, 2)).astype(np.float32)}
    mask = np.asarray([True, False, False, True])
    cfg = dict(corrupt=0.5, corrupt_mode="noise", noise_scale=50.0)
    key = jax.random.key(0)
    want = jfaults.FaultModel(jfaults.FaultConfig(**cfg)).corrupt_tree(
        key, jax.tree.map(jnp.asarray, tree), jnp.asarray(mask))
    noise = [torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key, i), x.shape, jnp.float32)))
        for i, x in enumerate(jax.tree.leaves(tree))]
    fm = tfaults.FaultModel(tfaults.FaultConfig(**cfg))
    got = fm.corrupt_tree(params_from_numpy(tree, "cpu"),
                          torch.from_numpy(mask), noise)
    for g, w, x in zip(tree_leaves(got), jax.tree.leaves(want),
                       jax.tree.leaves(tree), strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_array_equal(g[1:3].numpy(), x[1:3])
        assert np.isfinite(g.numpy()).all()
        assert float(g[0].norm()) > 10 * float(np.linalg.norm(x[0]))
    own = fm.draw(torch.Generator().manual_seed(1),
                  params_from_numpy(tree, "cpu"))["noise"]
    assert [t.shape for t in own] == [t.shape for t in noise]
    with pytest.raises(ValueError, match="noise"):
        fm.corrupt_tree(params_from_numpy(tree, "cpu"),
                        torch.from_numpy(mask))


def test_corrupt_tree_zero_rate_returns_input():
    tree = {"a": torch.ones(2, 2)}
    assert tfaults.FaultModel().corrupt_tree(
        tree, torch.ones(2, dtype=torch.bool)) is tree


def test_quantize_rho_matches_jax():
    for rho in (1.0, 0.996, 0.995, 0.994, 0.707, 0.5, 0.004, 0.0,
                np.float32(0.8660254)):
        assert tfed._quantize_rho(rho) == jfed._quantize_rho(rho)
    assert isinstance(tfed._quantize_rho(torch.tensor(0.5)), float)


# ------------------------------- staleness 0: buffered == sync, bit for bit

@pytest.mark.parametrize("strategy", ["fedit", "ffa", "fedsa", "rolora",
                                      "flora"])
def test_buffered_staleness0_bit_identical_to_sync(tiny, strategy):
    kw = dict(n=3, local_steps=2, chunk_rounds=2, aggregation=strategy,
              track_stability=True)
    sync = port_trainer(tiny, **kw)
    sync.run(4)
    buf = port_trainer(tiny, buffer_size=0, **kw)
    buf.run(4)
    assert buf.async_mode and not sync.async_mode
    assert_state_bitequal(sync, buf)
    assert buf.gamma_eff == sync.adapters.gamma
    for hs, hb in zip(sync.history, buf.history):
        for k in ("loss", "grad_norm", "update_norm"):
            assert hs[k] == hb[k]
        assert (hb["n_eff"], hb["gamma_scale"], hb["stale"],
                hb["rejected"], hb["delivered"]) == (3.0, 1.0, 0.0, 0.0, 3.0)
    assert int(buf.async_state["tau"].sum()) == 0
    assert float(buf.async_state["rho"]) == 1.0


@pytest.mark.parametrize("kw", [dict(participation=0.5),
                                dict(partition="dirichlet",
                                     weight_by_size=True)],
                         ids=["participation", "weight_by_size"])
def test_buffered_staleness0_composes_with_sampling_and_weights(tiny, kw):
    base = dict(n=3, chunk_rounds=2, **kw)
    sync = port_trainer(tiny, **base)
    sync.run(4)
    buf = port_trainer(tiny, buffer_size=0, **base)
    buf.run(4)
    assert_state_bitequal(sync, buf)
    assert [h["loss"] for h in sync.history] == [h["loss"] for h in
                                                 buf.history]


# ------------------------------------ faulted trajectories under JAX draws

FAULTED = {
    "nan": dict(faults=dict(dropout=0.2, straggle=0.3, corrupt=0.25, seed=4),
                buffer_size=0),
    "noise": dict(faults=dict(corrupt=0.25, corrupt_mode="noise",
                              noise_scale=1e3, seed=3), buffer_size=0),
    "cap": dict(faults=dict(straggle=0.3, corrupt=0.2, seed=1),
                buffer_size=2, participation=0.75, staleness_beta=1.0),
}


@pytest.mark.parametrize("case", list(FAULTED))
def test_faulted_trajectory_matches_jax(tiny, case):
    kw = dict(FAULTED[case])
    jtr, ttr = trainer_pair(tiny, chunk_rounds=2, local_steps=2, **kw)
    draws = jax_draws(jtr)
    jtr.run(4)
    ttr.run(4, draws=draws)
    assert_same_run(jtr, ttr, keys=("loss", "grad_norm", "update_norm",
                                    "n_eff", "gamma_scale"))
    for th, jh in zip(ttr.history, jtr.history):
        for key in ("delivered", "rejected", "stale"):
            assert th[key] == jh[key], (key, th, jh)
    assert ttr.gamma_eff == jtr.gamma_eff
    np.testing.assert_array_equal(ttr.async_state["tau"].numpy(),
                                  np.asarray(jtr.async_state["tau"]))
    counts = {k: sum(h[k] for h in ttr.history)
              for k in ("rejected", "stale")}
    if case in ("nan", "noise"):
        assert counts["rejected"] > 0, counts
    if case == "cap":
        assert max(h["delivered"] for h in ttr.history) == 2
        assert counts["stale"] > 0


def test_jax_async_checkpoint_restores_in_port(tiny, tmp_path):
    """A buffered JAX trainer's checkpoint (async_state under its keys)
    resumes in the port at participation 1.0: tau and the fold mirror come
    across, and the next rounds follow the JAX trainer's."""
    kw = dict(FAULTED["nan"], chunk_rounds=2)
    jtr, ttr = trainer_pair(tiny, **kw)
    draws = jax_draws(jtr)
    jtr.run(2)
    path = str(tmp_path / "jax_async.npz")
    jtr.save(path)
    ttr.restore(path)
    np.testing.assert_array_equal(ttr.async_state["tau"].numpy(),
                                  np.asarray(jtr.async_state["tau"]))
    assert ttr._rho_host == jtr._rho_host and ttr.round_idx == 2
    jtr.run(2)
    ttr.run(2, draws=draws)
    for th, jh in zip(ttr.history, jtr.history[2:]):
        assert th["round"] == jh["round"]
        assert abs(th["loss"] - jh["loss"]) <= TRAJ_RTOL * max(
            1.0, abs(jh["loss"]))
        assert th["delivered"] == jh["delivered"]


# ------------------------------------------------------------ the watchdog

def test_watchdog_rescale_events_match_jax(tiny):
    """``tests/test_faults.py``'s acceptance scenario (classic gamma =
    alpha / r at r = 64, N = 8, corrupted uploads) under JAX's draws: the
    same rescale event, the same adopted gamma and gamma_eff, a stabilized
    final report, and the trajectory of the rescued run."""
    kw = dict(n=8, rank=64, scaling="lora", buffer_size=0, chunk_rounds=4,
              faults=dict(corrupt=0.25, seed=1),
              watchdog=dict(max_retries=2))
    jtr, ttr = trainer_pair(tiny, **kw)
    assert ttr.adapters.gamma == pytest.approx(8.0 / 64)
    draws = jax_draws(jtr)
    jtr.run(8)
    ttr.run(8, draws=draws)
    assert ttr.watchdog_events == jtr.watchdog_events
    ev = ttr.watchdog_events[0]
    assert ev["verdict"] == "collapse" and ev["action"] == "rescale"
    assert ttr.adapters.gamma == jtr.adapters.gamma == pytest.approx(
        8.0 * (8 / 64) ** 0.5)
    assert ttr.gamma_eff == jtr.gamma_eff
    assert ttr.lora_cfg.scaling == "sfedlora"
    assert ttr.stability_report().verdict == "stabilized"
    assert_same_run(jtr, ttr)


def test_watchdog_backoff_events_match_jax(tiny):
    """With the rescue disabled a config-half collapse backs off and then
    raises: the same events, participation and round as JAX's."""
    kw = dict(n=4, rank=64, scaling="lora", buffer_size=0, chunk_rounds=2,
              faults=dict(dropout=0.25, seed=2),
              watchdog=dict(max_retries=1, rescale_gamma=False))
    jtr, ttr = trainer_pair(tiny, **kw)
    draws = jax_draws(jtr)
    from repro.analysis.stability_check import \
        ScalingCollapseError as JCollapse
    with pytest.raises(JCollapse, match="collapse"):
        jtr.run(4)
    with pytest.raises(ScalingCollapseError, match="collapse"):
        ttr.run(4, draws=draws)
    assert ttr.watchdog_events == jtr.watchdog_events
    assert ttr.watchdog_events[0]["action"] == "backoff"
    assert ttr.fed_cfg.participation == jtr.fed_cfg.participation == 0.5
    assert ttr.fed_cfg.faults.seed == jtr.fed_cfg.faults.seed == 3
    assert ttr.round_idx == jtr.round_idx == 2


def test_watchdog_rollback_restores_chunk_start_state(tiny):
    """A failed chunk leaves no trace: the snapshot's state, generator,
    data stream, history and round come back, and the retry starts from
    them with only gamma changed."""
    kw = dict(n=4, rank=64, scaling="lora", buffer_size=0, chunk_rounds=2,
              participation=0.5)
    tr = port_trainer(tiny, watchdog=tfed.WatchdogConfig(), **kw)
    tr.run(2)                                   # a healthy-looking start
    snap = tr._snapshot()
    before = (tr.dataset.rng_state(), tr._part_gen.get_state().clone(),
              [t.clone() for t in tree_leaves(tr.lora)])
    tr._run_one_chunk(2)
    assert tr.round_idx == 4 and len(tr.history) == 4
    tr._rollback(snap)
    assert tr.round_idx == 2 and len(tr.history) == 2
    assert tr.dataset.rng_state() == before[0]
    assert torch.equal(tr._part_gen.get_state(), before[1])
    for a, b in zip(tree_leaves(tr.lora), before[2]):
        assert torch.equal(a, b)
    ref = port_trainer(tiny, **kw)
    wd = port_trainer(tiny, watchdog=tfed.WatchdogConfig(max_retries=2),
                      **kw)
    ref.run(2)
    wd.run(2)
    assert wd.watchdog_events and wd.round_idx == 2 and len(wd.history) == 2
    assert wd.adapters.gamma != ref.adapters.gamma


def test_watchdog_quiet_on_healthy_run(tiny):
    tr = port_trainer(tiny, buffer_size=0, chunk_rounds=2,
                      watchdog=tfed.WatchdogConfig(max_retries=2))
    tr.run(4)
    assert tr.watchdog_events == []
    assert tr.gamma_eff == tr.adapters.gamma
    assert tr.stability_report().ok


def test_backoff_reseeds_the_fault_stream():
    f0 = tfaults.FaultConfig(dropout=0.5, seed=7)
    f1 = dataclasses.replace(f0, seed=f0.seed + 1)
    fm0, fm1 = tfaults.FaultModel(f0), tfaults.FaultModel(f1)
    assert not torch.equal(fm0.sample(fm0.round_generator(0, 0, "cpu"),
                                      64)["drop"],
                           fm1.sample(fm1.round_generator(0, 0, "cpu"),
                                      64)["drop"])


# ------------------------------------ the engine under the port's own draws

def test_dropout_shrinks_n_eff_and_gamma_eff(tiny):
    tr = port_trainer(tiny, buffer_size=0, chunk_rounds=2,
                      faults=tfaults.FaultConfig(dropout=0.5, seed=2))
    tr.run(6)
    n_eff = np.asarray([h["n_eff"] for h in tr.history])
    assert (n_eff < tr.fed_cfg.num_clients).any()
    assert tr.gamma_eff < tr.adapters.gamma
    assert tr.gamma_eff == tr.adapters.gamma * tr._rho_host
    assert all(np.isfinite(h["loss"]) for h in tr.history)


def test_stragglers_deliver_late_with_staleness(tiny):
    tr = port_trainer(tiny, buffer_size=0, chunk_rounds=2,
                      faults=tfaults.FaultConfig(straggle=0.5, seed=1))
    tr.run(8)
    stale = np.asarray([h["stale"] for h in tr.history])
    delivered = np.asarray([h["delivered"] for h in tr.history])
    assert stale.sum() > 0
    assert (delivered < tr.fed_cfg.num_clients).any() and delivered.sum() > 0


def test_nan_corruption_is_screened_and_unscreened_poisons(tiny):
    """Rejected server-side, the run stays finite; with screening off the
    same schedule reaches the aggregate (the negative control)."""
    faults = tfaults.FaultConfig(corrupt=0.4, seed=3)
    tr = port_trainer(tiny, buffer_size=0, chunk_rounds=2, faults=faults)
    tr.run(6)
    assert sum(h["rejected"] for h in tr.history) > 0
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    for leaf in tree_leaves({"l": tr.lora, "o": tr.opt_state}):
        assert torch.isfinite(leaf.float()).all()
    off = port_trainer(tiny, buffer_size=0, chunk_rounds=2, faults=faults,
                       screen_updates=False)
    off.run(6)
    assert any(not torch.isfinite(x).all() for x in tree_leaves(off.lora))


def test_noise_corruption_is_screened_as_norm_outlier(tiny):
    tr = port_trainer(tiny, n=8, buffer_size=0, chunk_rounds=2,
                      faults=tfaults.FaultConfig(corrupt=0.25,
                                                 corrupt_mode="noise",
                                                 noise_scale=1e4, seed=3))
    tr.run(6)
    assert sum(h["rejected"] for h in tr.history) > 0
    assert max(float(x.abs().max()) for x in tree_leaves(tr.lora)) < 1e3


def test_buffer_cap_limits_delivered(tiny):
    tr = port_trainer(tiny, n=4, buffer_size=2, chunk_rounds=2,
                      faults=tfaults.FaultConfig(straggle=0.3, seed=1))
    tr.run(6)
    delivered = np.asarray([h["delivered"] for h in tr.history])
    assert (delivered <= 2).all() and delivered.max() == 2


def test_fault_schedule_chunking_invariant(tiny):
    faults = tfaults.FaultConfig(dropout=0.3, straggle=0.3, seed=5)
    one = port_trainer(tiny, buffer_size=0, chunk_rounds=2, faults=faults)
    one.run(6)
    many = port_trainer(tiny, buffer_size=0, chunk_rounds=2, faults=faults)
    for _ in range(3):
        many.run(2)
    assert_state_bitequal(one, many)
    for k in ("delivered", "stale", "n_eff"):
        assert [h[k] for h in one.history] == [h[k] for h in many.history]


def test_crash_resume_under_faults_bit_exact(tiny, tmp_path):
    path = str(tmp_path / "faulty.npz")
    kw = dict(buffer_size=0, chunk_rounds=3, participation=0.75,
              faults=tfaults.FaultConfig(dropout=0.3, straggle=0.4,
                                         corrupt=0.2, seed=4))
    full = port_trainer(tiny, **kw)
    full.run(6)
    half = port_trainer(tiny, **kw)
    half.run(3)
    half.save(path)
    payload = np.load(path)
    assert "async_state::tau" in payload.files
    assert "async_state::rho" in payload.files
    res = port_trainer(tiny, **kw)
    res.restore(path)
    assert res.round_idx == 3
    assert torch.equal(res.async_state["tau"], half.async_state["tau"])
    assert res._rho_host == half._rho_host
    res.run(3)
    assert_state_bitequal(full, res)
    assert res.history == full.history[3:]


def test_restore_legacy_checkpoint_resets_async_state(tiny, tmp_path):
    path = str(tmp_path / "legacy.npz")
    sync = port_trainer(tiny, chunk_rounds=2)
    sync.run(2)
    sync.save(path)
    assert "async_state::tau" not in np.load(path).files
    buf = port_trainer(tiny, buffer_size=0, chunk_rounds=2)
    buf.async_state = {"tau": torch.ones(4, dtype=torch.int32),
                       "rho": torch.tensor(0.5)}
    buf._rho_host = 0.5
    buf.restore(path)
    assert int(buf.async_state["tau"].sum()) == 0
    assert float(buf.async_state["rho"]) == 1.0 and buf._rho_host == 1.0


def test_make_buffered_round_body_needs_a_buffered_strategy(tiny):
    with pytest.raises(ValueError, match="BufferedStrategy"):
        tfed.make_buffered_round_body(tiny[1], strategy="fedsa",
                                      opt_cfg=tbase.OptimizerConfig())


# -------------------------------------------------------------------- CLI

CLI = ["--reduced", "--device", "cpu", "--rounds", "8", "--chunk-rounds",
       "4", "--buffer", "3", "--faults",
       "dropout=0.2,straggle=geom:0.3,corrupt=0.1", "--watchdog", "2",
       "--seq", "16", "--batch-per-client", "2"]


def test_cli_buffered_faulted_watched(capsys):
    tr = ttrain.main([*CLI, "--clients", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith(
        "N=4 buffer=3 faults[dropout=0.2,straggle=geom:0.3,corrupt=0.1] "
        "watchdog(retries=2)")
    line = next(x for x in out if x.startswith("# async: "))
    gamma_eff = float(line.split()[2].split("=")[1])
    assert gamma_eff == round(tr.gamma_eff, 4) and tr.gamma_eff < tr.gamma
    assert out[-1].startswith("# final held-out perplexity: ")
    assert len(tr.history) == 8


def test_cli_watchdog_rescues_collapsed_lora_scaling(capsys):
    tr = ttrain.main([*CLI, "--clients", "8", "--scaling", "lora", "--rank",
                      "64"])
    out = capsys.readouterr().out.splitlines()
    events = [x for x in out if x.startswith("# watchdog: ")]
    assert events[0] == ("# watchdog: round 0 verdict=collapse -> rescale "
                         "(gamma->2.828 (sfedlora), retry 1)")
    assert tr.lora_cfg.scaling == "sfedlora" and len(tr.history) == 8
