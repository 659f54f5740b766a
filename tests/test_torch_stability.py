"""repro_torch's stability instrumentation against the JAX package, on the
CPU: the Definition 4.1 probes (``core/stability.py``), the Theorem 4.2
sentinel (``analysis/stability_check.py``) and the trainer's
``stability_report``.

  * The sentinel gives the same verdict, ``predicted``, trend and messages
    as the JAX package's for the same norms (both are float arithmetic on
    the host: identical, not close).
  * The probes equal JAX's within 1e-5 relative on injected probes (JAX's
    ``jax.random.normal`` draws passed across as the probe matrices; fp32
    matmuls summed in another order).
  * ``activation_moments`` on reduced gemma-2b within 1e-5 relative.
  * ``FederatedTrainer.stability_report`` on reduced gemma-2b: the same
    verdict and ``predicted`` as the JAX trainer's, its norms within 1e-4
    (the trajectory tolerance of ``tests/test_torch_train.py``), and the
    behaviour of ``tests/test_analysis.py``'s trainer tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.analysis import stability_check as jsc              # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.core import stability as jst                        # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.analysis import stability_check as tsc        # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy        # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.core import stability as tst                  # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402

ALPHA = 8.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small-tensor runs: the suite runs
    several workers a machine, and torch's default of one thread a core
    each makes the many tiny ops of a client loop wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _report_fields(rep):
    return (rep.ok, rep.verdict, rep.predicted, rep.trend, rep.norms,
            rep.messages, str(rep))


# (norms, gamma, r, N, reference): the sentinel's cases in
# tests/test_analysis.py and tests/test_faults.py, and one of each verdict
SENTINEL_CASES = {
    "sfedlora flat": ([1.0, 1.01, 0.99, 1.0], ALPHA * (8 / 64) ** 0.5, 64,
                      8, None),
    "lora collapse": ([1.0, 1.01, 0.99, 1.0], ALPHA / 64, 64, 8, None),
    "zb explosion": ([1.0, 1.0], 8 ** 2 / 64 ** 0.5, 64, 8, None),
    "measured explosion": ([1.0, 4.0, 16.0, 64.0], ALPHA * (4 / 16) ** 0.5,
                           16, 4, None),
    "measured decay": ([64.0, 16.0, 4.0, 1.0], ALPHA * (4 / 16) ** 0.5, 16,
                       4, None),
    "reference drift": ([100.0, 100.0, 100.0], ALPHA * (4 / 16) ** 0.5, 16,
                        4, ([1.0, 1.0, 1.0], ALPHA * (4 / 16) ** 0.5, 16, 4)),
    "reference agrees": ([2.0, 2.1, 1.9], ALPHA * (4 / 16) ** 0.5, 16, 4,
                         ([2.0, 2.0], ALPHA * (4 / 16) ** 0.5)),
    "collapse and drift": ([1.0, 0.01], ALPHA / 64, 64, 8, None),
}


@pytest.mark.parametrize("case", list(SENTINEL_CASES))
def test_stability_report_identical_to_jax(case):
    norms, gamma, r, n, ref = SENTINEL_CASES[case]
    kw = dict(gamma=gamma, r=r, n_clients=n, alpha=ALPHA, reference=ref)
    got, want = tsc.stability_report(norms, **kw), jsc.stability_report(
        norms, **kw)
    assert _report_fields(got) == _report_fields(want)
    assert tsc.recovery_action(got) == jsc.recovery_action(want)
    if got.ok:
        assert tsc.assert_stabilized(norms, **kw).ok
    else:
        with pytest.raises(tsc.ScalingCollapseError, match=got.verdict):
            tsc.assert_stabilized(norms, **kw)


def test_sentinel_flags_lora_scaling_collapse_at_high_rank():
    r, n = 64, 8
    flat = [1.0, 1.01, 0.99, 1.0]
    sfed = tsc.stability_report(flat, gamma=ALPHA * np.sqrt(n / r), r=r,
                                n_clients=n, alpha=ALPHA)
    assert sfed.ok and sfed.predicted == pytest.approx(1.0)
    lora = tsc.stability_report(flat, gamma=ALPHA / r, r=r, n_clients=n,
                                alpha=ALPHA)
    assert lora.verdict == "collapse"
    assert lora.predicted == pytest.approx(1.0 / (r * n))
    assert "gamma=alpha*sqrt(N/r)" in str(lora)
    assert tsc.recovery_action(lora) == "rescale"
    with pytest.raises(ValueError, match=">= 2"):
        tsc.stability_report([1.0], gamma=1.0, r=4, n_clients=4, alpha=ALPHA)


def test_scaling_flatness_and_predicted_scale_match_jax():
    for moments in ({(4, 8): 1.0, (8, 16): 1.2, (16, 64): 0.9},
                    [1.0, 100.0], [3.0]):
        assert tsc.scaling_flatness(moments) == jsc.scaling_flatness(moments)
    with pytest.raises(ValueError, match="at least one"):
        tsc.scaling_flatness([])
    for n in (2, 8, 32):
        for r in (4, 16, 64):
            for gamma in (ALPHA * np.sqrt(n / r), ALPHA / r):
                assert (tsc.predicted_scale(gamma, r, n, ALPHA)
                        == jsc.predicted_scale(gamma, r, n, ALPHA))


# ------------------------------------------------------------- the probes

@pytest.mark.parametrize("h", [1, 2, 4])
def test_probes_match_jax_on_injected_probes(h):
    rng = np.random.default_rng(h)
    r, d_in, d_out, n_probe = 8, 48, 40, 64
    a = (0.02 * rng.standard_normal((r, d_in))).astype(np.float32)
    b = (0.05 * rng.standard_normal((d_out, r))).astype(np.float32)
    key = jax.random.key(h)
    gamma = 2.5
    want_f = jst.adapter_forward_moment(jnp.asarray(a), jnp.asarray(b),
                                        gamma, key, h=h, n_probe=n_probe)
    want_b = jst.adapter_backward_moment(jnp.asarray(a), jnp.asarray(b),
                                         gamma, key, n_probe=n_probe)
    x = torch.from_numpy(np.array(jax.random.normal(key, (n_probe, d_in),
                                                    jnp.float32)))
    v = torch.from_numpy(np.array(jax.random.normal(key, (n_probe, d_out),
                                                    jnp.float32)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got_f = tst.adapter_forward_moment(ta, tb, gamma, x, h=h,
                                       n_probe=n_probe)
    got_b = tst.adapter_backward_moment(ta, tb, gamma, v, n_probe=n_probe)
    np.testing.assert_allclose(float(got_f), float(want_f), rtol=1e-5)
    np.testing.assert_allclose(float(got_b), float(want_b), rtol=1e-5)
    gen = torch.Generator().manual_seed(0)
    own = tst.adapter_forward_moment(ta, tb, gamma, gen, h=h)
    assert float(own) > 0
    with pytest.raises(ValueError, match="shape"):
        tst.adapter_forward_moment(ta, tb, gamma, v)


def test_aggregated_moment_sweep_matches_theory():
    """``tests/test_scaling.py``'s App. A claims on the port's own draws:
    sfedlora flat in r, lora decaying like 1/r.  One sweep is one draw of
    a statistic whose spread at r = 8, N = 8 is about its mean (seven
    cross terms of r products each), so the claims are checked on the root
    mean square over 8 seeded sweeps; and every scaling sees the same
    draws, so within one sweep the ratio of two is exactly gamma's."""
    squares = {}
    for seed in range(8):
        sweep = tst.aggregated_moment_sweep(
            torch.Generator().manual_seed(seed), d=256, ranks=(8, 128),
            clients=(1, 8))
        for key in sweep["sfedlora"]:
            n, r = key
            ratio = sweep["sfedlora"][key] / sweep["rslora"][key]
            assert ratio == pytest.approx(n, rel=1e-4)
        for name, res in sweep.items():
            for key, v in res.items():
                squares.setdefault(name, {}).setdefault(key, []).append(v * v)
    rms = {name: {k: float(np.sqrt(np.mean(v))) for k, v in res.items()}
           for name, res in squares.items()}
    s, lo = rms["sfedlora"], rms["lora"]
    for n in (1, 8):
        assert 0.3 < s[(n, 8)] / s[(n, 128)] < 3.0, (n, s)
    assert lo[(8, 8)] / max(lo[(8, 128)], 1e-12) > 8
    flat, _ = tsc.scaling_flatness({k: v for k, v in s.items() if k[0] == 8})
    assert flat


# --------------------------------------------- reduced gemma-2b, both ways

@pytest.fixture(scope="module")
def small():
    jcfg = jconfigs.get_config("gemma-2b").reduced(d_model=64, vocab_size=256)
    tcfg = tconfigs.get_config("gemma-2b").reduced(d_model=64, vocab_size=256)
    jm = japi.build_model(jcfg)
    return jcfg, tcfg, jm, jm.init(jax.random.key(0))


def test_activation_moments_match_jax(small):
    jcfg, tcfg, jm, jparams = small
    rng = np.random.default_rng(3)
    aset = jlora.init_adapter_set(jparams, jax.random.key(1),
                                  jbase.LoRAConfig(rank=8), n_clients=4)
    lora = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(
        x.shape).astype(np.float32), aset.lora)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    want = jst.activation_moments(
        jm, jparams, {"tokens": jnp.asarray(toks)},
        jlora.AdapterSet(lora=jax.tree.map(jnp.asarray, lora),
                         gamma=aset.gamma))
    got = tst.activation_moments(
        tapi.build_model(tcfg), params_from_numpy(jax.tree.map(
            np.asarray, jparams), "cpu"), {"tokens": torch.from_numpy(toks)},
        tlora.AdapterSet(lora=params_from_numpy(lora, "cpu"),
                         gamma=aset.gamma))
    assert set(got) == {"mean", "var"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7)


def _trainers(small, *, track=True, scaling="sfedlora", rank=8):
    jcfg, tcfg, jm, jparams = small
    n = 3
    lcfg = dict(rank=rank, alpha=ALPHA, scaling=scaling)
    fcfg = dict(num_clients=n, local_steps=1, aggregation="fedsa")
    ds_kw = dict(seq_len=16, batch_per_client=2, seed=0)
    jtr = jfed.FederatedTrainer(
        jm, jsyn.FederatedDataset(jcfg.vocab_size, n, **ds_kw),
        lora_cfg=jbase.LoRAConfig(**lcfg),
        fed_cfg=jbase.FederatedConfig(**fcfg),
        opt_cfg=jbase.OptimizerConfig(name="sgd", lr=0.05), seed=0,
        base_params=jparams, chunk_rounds=2, track_stability=track)
    ttr = tfed.FederatedTrainer(
        tapi.build_model(tcfg),
        tsyn.FederatedDataset(tcfg.vocab_size, n, **ds_kw),
        lora_cfg=tbase.LoRAConfig(**lcfg),
        fed_cfg=tbase.FederatedConfig(**fcfg),
        opt_cfg=tbase.OptimizerConfig(name="sgd", lr=0.05), seed=0,
        base_params=jax.tree.map(np.asarray, jparams),
        lora_init=jax.tree.map(lambda x: np.asarray(x[0]), jtr.lora),
        device="cpu", chunk_rounds=2, track_stability=track)
    return jtr, ttr


@pytest.mark.parametrize("scaling,rank", [("sfedlora", 8), ("lora", 64)])
def test_trainer_stability_report_matches_jax(small, scaling, rank):
    jtr, ttr = _trainers(small, scaling=scaling, rank=rank)
    with pytest.raises(ValueError, match="track_stability"):
        ttr.stability_report()                     # no history yet
    jtr.run(4)
    ttr.run(4)
    want, got = jtr.stability_report(), ttr.stability_report()
    assert (got.ok, got.verdict, got.predicted) == (want.ok, want.verdict,
                                                    want.predicted)
    assert len(got.norms) == 4
    np.testing.assert_allclose(got.norms, want.norms, rtol=1e-4)
    assert got.ok == (scaling == "sfedlora")
    ref = ttr.stability_report(reference=(want.norms, jtr.gamma))
    assert ref.verdict == got.verdict


def test_track_stability_preserves_metric_values(small):
    """The opt-in update_norm does not perturb training: losses and state
    are bit-identical with and without it."""
    _, a = _trainers(small, track=False)
    _, b = _trainers(small, track=True)
    a.run(2)
    b.run(2)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    assert "update_norm" not in a.history[0]
    assert all("update_norm" in h for h in b.history)
    for x, y in zip(tlora.tree_leaves(a.lora), tlora.tree_leaves(b.lora)):
        assert torch.equal(x, y)
