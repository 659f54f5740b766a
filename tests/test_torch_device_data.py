"""repro_torch's on-device federated data (``DeviceFederatedData``,
``FederatedTrainer(data_mode="device")``, ``--data-mode device``) on the
CPU.

The sampler draws from a ``torch.Generator``, whose bits cannot equal
``jax.random``'s, so it is held against the JAX package's sampler by
distribution: over 200 rounds of a Dirichlet partition, each client's
topic frequencies lie within 4 binomial sigmas of its mixture (by the
exact binomial tail where the mean is too small for the normal bound; a
batch's topic is the table that explains its transitions), and so do the
share of noisy transitions and the first tokens' uniformity, for both
samplers.
The trainer in device mode is held to bit-identity under chunking,
rollback and save / restore, runs under partial participation, size
weights, the buffered engine and the watchdog, and refuses a JAX-written
device-mode checkpoint, whose ``jax.random`` key it cannot continue."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import base as jbase                        # noqa: E402
from repro.checkpoint import io as jio                         # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
from repro_torch.launch import train as ttrain                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.tree import tree_leaves                        # noqa: E402

VOCAB = 64
TINY = dict(name="device-data-tiny", family="dense", num_layers=1,
            d_model=32, num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
            vocab_size=VOCAB)
SIGMAS = 4.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small-tensor runs (several test
    workers share a machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset(n=4, seq=16, batch=3, partition="dirichlet", **kw):
    return tsyn.FederatedDataset(VOCAB, n, seq_len=seq, batch_per_client=batch,
                                 partition=partition, dirichlet_alpha=0.5,
                                 seed=0, **kw)


# ---------------------------------------------------------------- sampler

def test_shape_dtype_range_and_device():
    dd = tsyn.DeviceFederatedData.from_host(_dataset(), "cpu")
    toks = dd.sample_round(torch.Generator().manual_seed(0), 3)
    assert tuple(toks.shape) == (4, 3, 3, 16)
    assert toks.dtype == torch.int32 and toks.device.type == "cpu"
    assert int(toks.min()) >= 0 and int(toks.max()) < VOCAB


def test_same_state_same_tokens_other_seed_other_tokens():
    dd = tsyn.DeviceFederatedData.from_host(_dataset(), "cpu")
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    first = dd.sample_round(g, 2)
    second = dd.sample_round(g, 2)
    assert not torch.equal(first, second)
    g.set_state(state)
    assert torch.equal(dd.sample_round(g, 2), first)
    assert not torch.equal(
        dd.sample_round(torch.Generator().manual_seed(6), 2), first)
    global_state = torch.get_rng_state()
    dd.sample_round(torch.Generator().manual_seed(7), 2)
    assert torch.equal(torch.get_rng_state(), global_state), \
        "the sampler touched torch's global RNG"


def test_tables_follow_the_host_dataset():
    ds = _dataset()
    dd = tsyn.DeviceFederatedData.from_host(ds, "cpu")
    jd = jsyn.DeviceFederatedData.from_host(ds)
    np.testing.assert_array_equal(dd.succ.numpy(), np.asarray(jd.succ))
    np.testing.assert_allclose(dd.mix.numpy(), np.asarray(jd.mix))
    assert (dd.noise, dd.batch, dd.seq_len, dd.vocab) == (
        jd.noise, jd.batch, jd.seq_len, jd.vocab)


ROUNDS = 200


def _port_rounds(ds):
    dd = tsyn.DeviceFederatedData.from_host(ds, "cpu")
    g = torch.Generator().manual_seed(11)
    return np.concatenate([dd.sample_round(g, 1).numpy()
                           for _ in range(ROUNDS)], axis=1)


def _jax_rounds(ds):
    jd = jsyn.DeviceFederatedData.from_host(ds)
    sample = jax.jit(lambda k: jd.sample_round(k, 1))
    keys = jax.random.split(jax.random.key(11), ROUNDS)
    return np.concatenate([np.asarray(sample(k)) for k in keys], axis=1)


# the two-sided tail of a normal beyond SIGMAS sigmas
TAIL = math.erfc(SIGMAS / math.sqrt(2))


def _within(count, n, p):
    """``count`` within SIGMAS binomial sigmas of n p: inside the normal
    bound, or (where n p is small and the normal law does not hold) no
    further out than the exact binomial tail of SIGMAS normal sigmas."""
    if abs(count - n * p) <= SIGMAS * math.sqrt(n * p * (1 - p)):
        return True
    pmf = [math.exp(math.lgamma(n + 1) - math.lgamma(j + 1)
                    - math.lgamma(n - j + 1) + j * math.log(p)
                    + (n - j) * math.log1p(-p)) for j in range(n + 1)]
    tail = sum(pmf[count:]) if count > n * p else sum(pmf[:count + 1])
    return 2 * tail >= TAIL


@pytest.mark.parametrize("sampler", ["port", "jax"])
def test_law_topics_noise_and_first_tokens(sampler):
    ds = _dataset()
    toks = (_port_rounds if sampler == "port" else _jax_rounds)(ds)
    n, rounds, b, s = toks.shape                 # (clients, rounds, B, S)
    assert rounds == ROUNDS
    succ = ds.lm.succ                            # (topics, vocab, branch)
    topics = succ.shape[0]
    prev, nxt = toks[..., :-1], toks[..., 1:]
    # member[k, ...]: the transition is one of topic k's successors
    member = np.stack([(succ[k][prev] == nxt[..., None]).any(-1)
                       for k in range(topics)])
    explained = member.sum(axis=(3, 4))          # (topics, clients, rounds)
    topic = explained.argmax(0)                  # (clients, rounds)
    best = np.sort(explained, 0)
    assert (best[-1] > best[-2]).all(), "a batch's topic is ambiguous"
    for i in range(n):
        counts = np.bincount(topic[i], minlength=topics)
        for k in range(topics):
            assert _within(counts[k], rounds, ds.mix[i, k]), \
                (sampler, i, k, counts[k], rounds * ds.mix[i, k])
    # noise: a noisy transition is uniform, so it falls outside the batch
    # topic's successors with probability 1 - |succ[t, prev]| / vocab
    rows = succ[topic[..., None, None], prev]    # (..., branch)
    distinct = np.array([[len(set(r)) for r in rows_k]
                         for rows_k in rows.reshape(-1, rows.shape[-2],
                                                    rows.shape[-1])])
    p_out = (ds.lm.noise * (1 - distinct / VOCAB)).mean()
    unexplained = int((~np.take_along_axis(
        member, topic[None, ..., None, None], 0)[0]).sum())
    assert _within(unexplained, prev.size, p_out), \
        (sampler, unexplained, prev.size * p_out)
    first = np.bincount(toks[..., 0].reshape(-1), minlength=VOCAB)
    for v in range(VOCAB):
        assert _within(first[v], first.sum(), 1 / VOCAB), (sampler, v)


# ---------------------------------------------------------------- trainer

@pytest.fixture(scope="module")
def tiny_base():
    return japi.build_model(jbase.ModelConfig(**TINY)).init(
        jax.random.key(0))


def _trainer(tiny_base, *, n=4, chunk_rounds=0, participation=1.0,
             rank=4, scaling="sfedlora", lr=0.5, watchdog=None, **fed_kw):
    return tfed.FederatedTrainer(
        tapi.build_model(tbase.ModelConfig(**TINY)),
        _dataset(n=n, batch=2),
        lora_cfg=tbase.LoRAConfig(rank=rank, alpha=8.0, scaling=scaling),
        fed_cfg=tbase.FederatedConfig(num_clients=n, local_steps=2,
                                      participation=participation,
                                      partition="dirichlet", **fed_kw),
        opt_cfg=tbase.OptimizerConfig(name="sgd", lr=lr), seed=0,
        base_params=jax.tree.map(np.asarray, tiny_base), data_mode="device",
        chunk_rounds=chunk_rounds, watchdog=watchdog, device="cpu")


def _same(a, b):
    assert a.history == b.history
    for x, y in zip(tree_leaves(a.lora), tree_leaves(b.lora)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(a.opt_state), tree_leaves(b.opt_state)):
        assert torch.equal(x, y)


def test_trainer_draws_on_its_device_and_not_from_the_host(tiny_base,
                                                           monkeypatch):
    tr = _trainer(tiny_base)
    assert tr.device_data is not None and tr._data_gen is not None
    monkeypatch.setattr(tr.dataset, "round_batch", None)   # never called
    tr.run(2)
    assert len(tr.history) == 2


def test_chunks_of_one_equal_one_chunk_of_four(tiny_base):
    one = _trainer(tiny_base, chunk_rounds=1)
    four = _trainer(tiny_base, chunk_rounds=4)
    one.run(4)
    four.run(4)
    _same(one, four)


def test_save_restore_bit_identical(tiny_base, tmp_path):
    full = _trainer(tiny_base, participation=0.5)
    full.run(4)
    first = _trainer(tiny_base, participation=0.5)
    first.run(2)
    path = str(tmp_path / "device.npz")
    first.save(path)
    resumed = _trainer(tiny_base, participation=0.5)
    resumed.restore(path)
    resumed.run(2)
    assert resumed.history == full.history[2:]
    for x, y in zip(tree_leaves(resumed.lora), tree_leaves(full.lora)):
        assert torch.equal(x, y)
    # the JAX package's reader takes the port's device-mode file
    base, lora, _, rnd = jio.load_federated_state(path)
    assert rnd == 2


def test_rollback_redraws_the_same_batches(tiny_base):
    tr = _trainer(tiny_base, chunk_rounds=2)
    tr.run(2)
    snap = tr._snapshot()
    out1 = tr._run_one_chunk(2)
    lora1 = [t.clone() for t in tree_leaves(tr.lora)]
    tr._rollback(snap)
    assert tr.round_idx == 2 and len(tr.history) == 2
    out2 = tr._run_one_chunk(2)
    assert out1 == out2
    for x, y in zip(tree_leaves(tr.lora), lora1):
        assert torch.equal(x, y)


def test_watchdog_rescues_a_collapse_in_device_mode(tiny_base):
    tr = _trainer(tiny_base, n=8, rank=64, scaling="lora", chunk_rounds=2,
                  lr=0.05, watchdog=tfed.WatchdogConfig(max_retries=2))
    tr.run(4)
    assert tr.watchdog_events and tr.round_idx == 4
    assert all(np.isfinite(h["loss"]) for h in tr.history)


@pytest.mark.parametrize("kw", [dict(participation=0.5),
                                dict(weight_by_size=True),
                                dict(buffer_size=2),
                                dict(buffer_size=0, participation=0.5,
                                     weight_by_size=True)],
                         ids=["participation", "weight_by_size", "buffer",
                              "all"])
def test_runs_finite_and_loss_falls(tiny_base, kw):
    tr = _trainer(tiny_base, **kw)
    tr.run(8)
    losses = [h["loss"] for h in tr.history]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses


def test_jax_device_mode_checkpoint_is_refused(tiny_base, tmp_path):
    jm = japi.build_model(jbase.ModelConfig(**TINY))
    ds = jsyn.FederatedDataset(VOCAB, 4, seq_len=16, batch_per_client=2,
                               partition="dirichlet", seed=0)
    jtr = jfed.FederatedTrainer(
        jm, ds, lora_cfg=jbase.LoRAConfig(rank=4),
        fed_cfg=jbase.FederatedConfig(num_clients=4, local_steps=2,
                                      partition="dirichlet"),
        opt_cfg=jbase.OptimizerConfig(name="sgd", lr=0.5), seed=0,
        base_params=tiny_base, data_mode="device")
    jtr.run(1)
    path = str(tmp_path / "jax_device.npz")
    jtr.save(path)
    tr = _trainer(tiny_base)
    with pytest.raises(ValueError, match="JAX trainer"):
        tr.restore(path)
    # a host-mode trainer still reads it (the JAX key is not needed there)
    hosted = tfed.FederatedTrainer(
        tapi.build_model(tbase.ModelConfig(**TINY)), _dataset(batch=2),
        lora_cfg=tbase.LoRAConfig(rank=4),
        fed_cfg=tbase.FederatedConfig(num_clients=4, local_steps=2,
                                      partition="dirichlet"),
        opt_cfg=tbase.OptimizerConfig(name="sgd", lr=0.5), seed=0,
        base_params=jax.tree.map(np.asarray, tiny_base), device="cpu")
    hosted.restore(path)
    assert hosted.round_idx == 1


def test_cli_trains_with_device_data(capsys):
    tr = ttrain.main(["--reduced", "--device", "cpu", "--rounds", "2",
                      "--seq", "16", "--clients", "3", "--data-mode",
                      "device", "--participation", "0.67"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("# gemma-2b (reduced)  strategy=fedsa")
    assert out[-1].startswith("# final held-out perplexity: ")
    assert tr.data_mode == "device" and len(tr.history) == 2
    assert all(np.isfinite(h["loss"]) for h in tr.history)
