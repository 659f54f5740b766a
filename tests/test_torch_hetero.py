"""Heterogeneous per-client ranks and FLoRA's stacking in repro_torch,
against the JAX package on the CPU: the cases of ``tests/test_conformance.py``
for all five strategies, on the port.

- Uniform ranks (mask all ones, one gamma) run the homogeneous engine, bit
  for bit, for every strategy, also under participation sampling.
- Mixed ranks (4, 8, 16, 16) give 3-round trajectories within 1e-4 of the
  JAX trainer (SGD), and with AdamW, a Dirichlet partition and
  ``weight_by_size`` (the flag strategies).  FLoRA's singular vectors are
  fixed only up to a sign per pair (LAPACK and the port's QR-reduced SVD
  may pick either), which flips a row of A with the column of B it
  multiplies: losses and gradient norms do not see it, so FLoRA compares
  by them and by each client's B A.  Its ``update_norm`` (the distance
  from the round's start, sign-dependent) and an AdamW run (whose moments
  keep the old signs) would compare LAPACK's sign choices, not the port.
- Masked rows stay exactly zero under SGD and AdamW.
- FLoRA's stacked product equals the brute-force weighted sum, and each
  client gets its top r_i components.
- Checkpoints: a heterogeneous file written by the port is read by the JAX
  ``load_federated_state`` and restored by the JAX trainer, and the
  reverse; a mismatched mask (or a mask on one side only) is refused.
- ``--ranks`` trains through the CLI.

Tolerances: per-round loss, grad-norm and update-norm within 1e-4 x max(1,
|ref|), final adapters (FLoRA: B A products) within 1e-4 x max(1,
max|ref|): fp32 on both sides, sums in another order."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.checkpoint import io as jio                         # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import aggregation as jagg                     # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint import io as tio                   # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import aggregation as tagg               # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.launch import train as ttrain                 # noqa: E402
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


TRAJ_RTOL = 1e-4
STRATEGIES = ("fedit", "ffa", "fedsa", "rolora", "flora")
RANKS = (4, 8, 16, 16)
ROUNDS = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def small():
    """Reduced gemma-2b (2 layers, d_model 64, vocab 256) and its JAX-drawn
    base."""
    jcfg = jconfigs.get_config("gemma-2b").reduced(d_model=64, vocab_size=256)
    tcfg = tconfigs.get_config("gemma-2b").reduced(d_model=64, vocab_size=256)
    jm = japi.build_model(jcfg)
    return jcfg, tcfg, jm, jm.init(jax.random.key(0))


def _cfgs(strategy, ranks, n, optimizer, partition, weight_by_size,
          participation, rank=8):
    return (dict(rank=rank, ranks=ranks, alpha=8.0, scaling="sfedlora"),
            dict(num_clients=n, local_steps=2, aggregation=strategy,
                 partition=partition, weight_by_size=weight_by_size,
                 participation=participation),
            dict(name=optimizer, lr=0.5 if optimizer == "sgd" else 0.01),
            dict(seq_len=16, batch_per_client=2, partition=partition,
                 seed=0))


def _port(small, strategy, ranks=None, *, n=len(RANKS), optimizer="sgd",
          partition="iid", weight_by_size=False, participation=1.0,
          lora_init=None, track=True):
    _, tcfg, _, jparams = small
    lcfg, fcfg, ocfg, ds_kw = _cfgs(strategy, ranks, n, optimizer, partition,
                                    weight_by_size, participation)
    return tfed.FederatedTrainer(
        tapi.build_model(tcfg),
        tsyn.FederatedDataset(tcfg.vocab_size, n, **ds_kw),
        lora_cfg=tbase.LoRAConfig(**lcfg),
        fed_cfg=tbase.FederatedConfig(**fcfg),
        opt_cfg=tbase.OptimizerConfig(**ocfg), seed=0,
        base_params=_np(jparams), lora_init=lora_init, device="cpu",
        track_stability=track)


def _pair(small, strategy, ranks=RANKS, **kw):
    """The JAX trainer and the port's, from the JAX trainer's adapter
    draw (the unmasked row of a client at the padded rank)."""
    jcfg, _, jm, jparams = small
    n = len(ranks)
    lcfg, fcfg, ocfg, ds_kw = _cfgs(strategy, ranks, n,
                                    kw.get("optimizer", "sgd"),
                                    kw.get("partition", "iid"),
                                    kw.get("weight_by_size", False), 1.0)
    jtr = jfed.FederatedTrainer(
        jm, jsyn.FederatedDataset(jcfg.vocab_size, n, **ds_kw),
        lora_cfg=jbase.LoRAConfig(**lcfg),
        fed_cfg=jbase.FederatedConfig(**fcfg),
        opt_cfg=jbase.OptimizerConfig(**ocfg), seed=0, base_params=jparams,
        track_stability=True)
    full = ranks.index(max(ranks))
    lora1 = jax.tree.map(lambda x: np.asarray(x[full]), jtr.lora)
    ttr = _port(small, strategy, ranks, lora_init=lora1, **kw)
    return jtr, ttr


def _products(tree):
    """B A of every client and layer, (N, ..., d_out, d_in) per node."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            if set(node) == {"a", "b"}:
                a, b = (np.asarray(x.numpy() if isinstance(x, torch.Tensor)
                                   else x) for x in (node["a"], node["b"]))
                out.append(np.einsum("...or,...ri->...oi", b, a))
                return
            for k in sorted(node):
                walk(node[k])
    walk(tree)
    return out


def _assert_same_run(jtr, ttr, strategy):
    keys = ("loss", "grad_norm") + (("update_norm",)
                                    if strategy != "flora" else ())
    assert len(ttr.history) == len(jtr.history) == ROUNDS
    for th, jh in zip(ttr.history, jtr.history):
        for key in keys:
            assert abs(th[key] - jh[key]) <= TRAJ_RTOL * max(
                1.0, abs(float(jh[key]))), (key, th, jh)
    if strategy == "flora":
        pairs = zip(_products(ttr.lora), _products(jtr.lora))
    else:
        pairs = ((g.numpy(), np.asarray(w)) for g, w in
                 zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)))
    for got, want in pairs:
        np.testing.assert_allclose(
            got, want, rtol=0,
            atol=TRAJ_RTOL * max(1.0, float(np.abs(want).max())))


def _masked_coords_zero(tr):
    for node in (tr.lora["stack"]["repeat"]["p0"]["attn"][p]
                 for p in ("q", "v")):
        for i, r_i in enumerate(tr.ranks):
            assert torch.all(node["a"][i][..., r_i:, :] == 0), ("a", i, r_i)
            assert torch.all(node["b"][i][..., :, r_i:] == 0), ("b", i, r_i)


def _assert_bitequal(tr_a, tr_b):
    assert tr_a.history == tr_b.history
    for x, y in zip(tree_leaves({"l": tr_a.lora, "o": tr_a.opt_state}),
                    tree_leaves({"l": tr_b.lora, "o": tr_b.opt_state})):
        assert torch.equal(x, y)


# ------------------------------ uniform ranks == the homogeneous engine

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_uniform_ranks_bit_identical_to_homogeneous(small, strategy):
    hom = _port(small, strategy)
    het = _port(small, strategy, (8,) * len(RANKS))
    assert het.rank_mask is not None and het.rank_mask.all()
    assert het.gamma == hom.gamma and het.ranks == (8,) * len(RANKS)
    for tr in (hom, het):
        tr.run(ROUNDS)
    _assert_bitequal(hom, het)


def test_uniform_ranks_bit_identical_with_participation(small):
    hom = _port(small, "fedsa", participation=0.5)
    het = _port(small, "fedsa", (8,) * len(RANKS), participation=0.5)
    for tr in (hom, het):
        tr.run(4)
    _assert_bitequal(hom, het)


# ------------------------------------ mixed ranks against the JAX trainer

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_mixed_rank_trajectory_matches_jax(small, strategy):
    jtr, ttr = _pair(small, strategy)
    assert ttr.lora_cfg.rank == jtr.lora_cfg.rank == 16
    assert ttr.gamma is None and jtr.gamma is None
    assert ttr.gammas == pytest.approx(jtr.gammas, rel=1e-7)
    np.testing.assert_array_equal(ttr.rank_mask, np.asarray(jtr.rank_mask))
    for got, want in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jtr.run(ROUNDS)
    ttr.run(ROUNDS)
    _assert_same_run(jtr, ttr, strategy)
    _masked_coords_zero(ttr)
    for c in (0, 3):
        np.testing.assert_allclose(ttr.eval_perplexity(batch=8, client=c),
                                   jtr.eval_perplexity(batch=8, client=c),
                                   rtol=1e-4)


@pytest.mark.parametrize("strategy", ("fedit", "ffa", "fedsa", "rolora"))
def test_mixed_rank_adamw_dirichlet_weighted_matches_jax(small, strategy):
    jtr, ttr = _pair(small, strategy, optimizer="adamw",
                     partition="dirichlet", weight_by_size=True)
    np.testing.assert_array_equal(ttr.client_weights.numpy(),
                                  np.asarray(jtr.client_weights))
    jtr.run(ROUNDS)
    ttr.run(ROUNDS)
    _assert_same_run(jtr, ttr, strategy)
    _masked_coords_zero(ttr)


def test_mixed_rank_flora_dirichlet_weighted_matches_jax(small):
    jtr, ttr = _pair(small, "flora", partition="dirichlet",
                     weight_by_size=True)
    jtr.run(ROUNDS)
    ttr.run(ROUNDS)
    _assert_same_run(jtr, ttr, "flora")
    _masked_coords_zero(ttr)


def test_client_adapters_carry_rank_gamma_and_mask(small):
    jtr, ttr = _pair(small, "fedsa")
    for i, r in enumerate(RANKS):
        ts, js = ttr.client_adapters(i), jtr.client_adapters(i)
        assert ts.rank == js.rank == r
        assert ts.gamma == pytest.approx(js.gamma, rel=1e-7)
        assert ts.gamma == pytest.approx(8.0 * (len(RANKS) / r) ** 0.5)
        if r == max(RANKS):
            assert ts.rank_mask is None          # all ones: canonical None
        else:
            np.testing.assert_array_equal(ts.rank_mask,
                                          np.asarray(js.rank_mask))
    stacked = ttr.adapters
    assert isinstance(stacked.gamma, np.ndarray)
    np.testing.assert_array_equal(stacked.rank_mask, ttr.rank_mask)


# ------------------------------------------------- masked rows stay zero

@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("optimizer", ("sgd", "adamw"))
def test_mixed_rank_masked_rows_stay_zero(small, strategy, optimizer):
    tr = _port(small, strategy, (2, 4, 4), n=3, optimizer=optimizer,
               partition="dirichlet", weight_by_size=True)
    assert tr.gamma is None and len(set(tr.gammas)) > 1
    _masked_coords_zero(tr)
    for _ in range(ROUNDS):
        tr.run_round()
        _masked_coords_zero(tr)
    assert all(np.isfinite(h["loss"]) for h in tr.history)


def test_ranks_length_mismatch_raises(small):
    with pytest.raises(ValueError, match="num_clients"):
        _port(small, "fedsa", (4, 8), n=3)


# ------------------------------------ the server step against the JAX one

def _rand_lora(rng, n, r, d_out=6, d_in=7, stack=()):
    return {"x": {"attn": {"q": {
        "a": rng.standard_normal((n,) + stack + (r, d_in)).astype(
            np.float32),
        "b": rng.standard_normal((n,) + stack + (d_out, r)).astype(
            np.float32)}}}}


@pytest.mark.parametrize("strategy", ("fedit", "ffa", "fedsa", "rolora"))
@pytest.mark.parametrize("weighted", [False, True])
def test_rank_aware_aggregate_matches_jax(strategy, weighted):
    """Each rank row averages over the clients active in it (composed with
    the weights; a row no weighted client holds keeps its values)."""
    rng = np.random.default_rng(1)
    ranks = (1, 2, 3, 3)
    mask = tlora.rank_mask(ranks)
    lora = jax.tree.map(lambda x: x * 1.0, _rand_lora(rng, 4, 3,
                                                      stack=(2,)))
    lora = _np(jlora.apply_rank_mask(jax.tree.map(jnp.asarray, lora),
                                     jnp.asarray(mask)))
    w = np.array([0.0, 2.0, 1.0, 0.5], np.float32) if weighted else None
    for round_idx in (0, 1):
        want = jagg.get_strategy(strategy).aggregate(
            jax.tree.map(jnp.asarray, lora), round_idx,
            weights=None if w is None else jnp.asarray(w),
            rank_mask=jnp.asarray(mask))
        got = tagg.get_strategy(strategy).aggregate(
            tio.params_from_numpy(lora, "cpu"), round_idx,
            weights=None if w is None else torch.from_numpy(w),
            rank_mask=mask)
        for g, x in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_flora_aggregate_matches_jax_by_product(weighted, masked):
    """FLoRA's server step: the same B A per client as the JAX package's
    (a full SVD of m there, the stacked factors' here), at a square and a
    wide adapter and with a rank past the smaller side (zero components)."""
    rng = np.random.default_rng(2)
    ranks = (1, 2, 4, 4)
    mask = tlora.rank_mask(ranks) if masked else None
    w = np.array([0.5, 2.0, 1.0, 0.0], np.float32) if weighted else None
    for d_out, d_in, stack in ((6, 6, ()), (3, 9, (2,)), (12, 5, ())):
        lora = _rand_lora(rng, 4, 4, d_out, d_in, stack)
        if masked:
            lora = _np(jlora.apply_rank_mask(jax.tree.map(jnp.asarray, lora),
                                             jnp.asarray(mask)))
        want = jagg.get_strategy("flora").aggregate(
            jax.tree.map(jnp.asarray, lora), 0,
            weights=None if w is None else jnp.asarray(w),
            rank_mask=None if mask is None else jnp.asarray(mask))
        got = tagg.get_strategy("flora").aggregate(
            tio.params_from_numpy(lora, "cpu"), 0,
            weights=None if w is None else torch.from_numpy(w),
            rank_mask=mask)
        for g, x in zip(_products(got), _products(_np(want))):
            np.testing.assert_allclose(g, x, rtol=1e-5, atol=1e-5)
        node = got["x"]["attn"]["q"]
        if masked:
            for i, r in enumerate(ranks):
                assert torch.all(node["a"][i][..., r:, :] == 0)
                assert torch.all(node["b"][i][..., :, r:] == 0)


def test_flora_stacked_product_equals_bruteforce_weighted_sum():
    rng = np.random.default_rng(7)
    n, r, d = 3, 4, 8
    a = rng.standard_normal((n, r, d)).astype(np.float32)
    # rank-1 per-client B: the weighted mean update has rank <= n <= r, so
    # the rank-r redistribution is exact
    b = np.zeros((n, d, r), np.float32)
    b[:, :, :1] = rng.standard_normal((n, d, 1))
    w = (rng.random(n) + 0.1).astype(np.float32)
    lora = {"x": {"attn": {"q": {"a": torch.from_numpy(a),
                                 "b": torch.from_numpy(b)}}}}
    out = tagg.get_strategy("flora").aggregate(lora, 0,
                                               weights=torch.from_numpy(w))
    wn = w / w.sum()
    want = sum(wn[i] * (b[i] @ a[i]) for i in range(n))
    for got in _products(out)[0]:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_flora_heterogeneous_clients_get_their_top_ranks():
    """Each client receives the mean update truncated at its own rank: the
    top-r_i SVD components, with its inactive rows and columns zero."""
    rng = np.random.default_rng(11)
    ranks = (2, 3, 4)
    n, r, d = len(ranks), max(ranks), 8
    mask = tlora.rank_mask(ranks)
    a = np.zeros((n, r, d), np.float32)
    b = np.zeros((n, d, r), np.float32)
    a[:, :2] = rng.standard_normal((n, 2, d))
    b[:, :, :2] = rng.standard_normal((n, d, 2))
    lora = {"x": {"attn": {"q": {"a": torch.from_numpy(a),
                                 "b": torch.from_numpy(b)}}}}
    out = tagg.get_strategy("flora").aggregate(lora, 0, rank_mask=mask)
    want = np.mean([b[i] @ a[i] for i in range(n)], axis=0)
    u, s, vh = np.linalg.svd(want, full_matrices=False)
    node = out["x"]["attn"]["q"]
    for i, r_i in enumerate(ranks):
        assert torch.all(node["a"][i][r_i:] == 0)
        assert torch.all(node["b"][i][:, r_i:] == 0)
        trunc = (u[:, :r_i] * s[:r_i]) @ vh[:r_i]
        np.testing.assert_allclose((node["b"][i] @ node["a"][i]).numpy(),
                                   trunc, rtol=1e-5, atol=1e-5)


def test_flora_identical_clients_keep_their_product():
    rng = np.random.default_rng(3)
    one = _rand_lora(rng, 1, 3)
    lora = tio.params_from_numpy(jax.tree.map(
        lambda x: np.repeat(x, 4, axis=0), one), "cpu")
    strat = tagg.get_strategy("flora")
    out = strat.aggregate(lora, 0)
    for got, want in zip(_products(out), _products(lora)):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    out2 = strat.aggregate(out, 0)
    for x, y in zip(tree_leaves(out), tree_leaves(out2)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert strat.agg_leaf_flags(0) == (True, True)
    assert strat.upload_bytes(lora) == jagg.get_strategy(
        "flora").upload_bytes(jax.tree.map(jnp.asarray, one))


# ------------------------------------------------------------ checkpoints

def test_port_checkpoint_is_read_by_jax(small, tmp_path):
    """The port's heterogeneous file: JAX's load_federated_state reads its
    rank mask and adapter metadata, and a JAX trainer restored from it
    continues as the port does."""
    jtr, ttr = _pair(small, "fedsa", partition="dirichlet",
                     weight_by_size=True)
    ttr.run(2)
    path = str(tmp_path / "port.npz")
    ttr.save(path)
    *_, extras = jio.load_federated_state(path, full=True)
    np.testing.assert_array_equal(extras["rank_mask"], ttr.rank_mask)
    meta = extras["adapter_meta"]
    np.testing.assert_array_equal(meta["ranks"], RANKS)
    np.testing.assert_allclose(meta["gammas"], ttr.gammas, rtol=1e-7)
    assert int(meta["rank"]) == 16 and str(meta["scaling"]) == "sfedlora"
    _, aset = jio.load_adapter_state(path)
    assert aset.rank_mask is not None
    jtr.restore(path)
    assert jtr.round_idx == 2
    jtr.run(1)
    ttr.run(1)
    assert abs(jtr.history[-1]["loss"] - ttr.history[-1]["loss"]) <= \
        TRAJ_RTOL * max(1.0, abs(float(jtr.history[-1]["loss"])))
    for got, want in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TRAJ_RTOL
                                   * max(1.0, float(np.abs(want).max())))


def test_jax_checkpoint_is_restored_by_the_port(small, tmp_path):
    jtr, ttr = _pair(small, "flora")
    jtr.run(2)
    path = str(tmp_path / "jax.npz")
    jtr.save(path)
    ttr.restore(path)
    assert ttr.round_idx == 2
    for got, want in zip(
            tree_leaves({"l": ttr.lora, "o": ttr.opt_state}),
            jax.tree.leaves({"l": jtr.lora, "o": jtr.opt_state})):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _masked_coords_zero(ttr)
    jtr.run(1)
    ttr.run(1)
    assert abs(jtr.history[-1]["loss"] - ttr.history[-1]["loss"]) <= \
        TRAJ_RTOL * max(1.0, abs(float(jtr.history[-1]["loss"])))


def test_port_resume_is_bit_exact(small, tmp_path):
    kw = dict(partition="dirichlet", weight_by_size=True, participation=0.5)
    full = _port(small, "fedsa", RANKS, **kw)
    full.run(4)
    half = _port(small, "fedsa", RANKS, **kw)
    half.run(2)
    path = str(tmp_path / "het.npz")
    half.save(path)
    res = _port(small, "fedsa", RANKS, **kw)
    res.restore(path)
    res.run(2)
    assert [h["round"] for h in res.history] == [3, 4]
    assert res.history == full.history[2:]
    for x, y in zip(tree_leaves({"l": full.lora, "o": full.opt_state}),
                    tree_leaves({"l": res.lora, "o": res.opt_state})):
        assert torch.equal(x, y)
    _masked_coords_zero(res)


@pytest.mark.parametrize("saved,restored", [
    (RANKS, (4, 8, 8, 16)), (RANKS, None), (None, RANKS)])
def test_mismatched_rank_mask_is_refused(small, tmp_path, saved, restored):
    src = _port(small, "fedsa", saved)
    path = str(tmp_path / "ck.npz")
    src.save(path)
    dst = _port(small, "fedsa", restored)
    with pytest.raises(ValueError, match="rank mask"):
        dst.restore(path)


# -------------------------------------------------------------------- CLI

@pytest.mark.parametrize("strategy", ["fedsa", "flora"])
def test_cli_trains_mixed_ranks_on_cpu(capsys, strategy):
    tr = ttrain.main(["--reduced", "--device", "cpu", "--rounds", "2",
                      "--seq", "16", "--clients", "3", "--ranks", "2,4,8",
                      "--strategy", strategy])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"# gemma-2b (reduced)  strategy={strategy} "
                             "scaling=sfedlora gammas=")
    assert out[0].endswith("ranks=2,4,8 N=3")
    assert tr.ranks == (2, 4, 8) and tr.lora_cfg.rank == 8
    assert len(tr.history) == 2
    assert all(np.isfinite(h["loss"]) for h in tr.history)
    _masked_coords_zero(tr)


def test_cli_ranks_must_match_clients():
    with pytest.raises(ValueError, match="num_clients"):
        ttrain.main(["--reduced", "--device", "cpu", "--rounds", "1",
                     "--clients", "3", "--ranks", "4,8"])


def test_padded_lora_config_is_shown(small):
    tr = _port(small, "fedsa", RANKS)
    assert dataclasses.replace(tr.lora_cfg, rank=8) == tbase.LoRAConfig(
        rank=8, ranks=RANKS, alpha=8.0, scaling="sfedlora")
