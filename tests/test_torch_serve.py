"""repro_torch serving against the JAX package: greedy ``generate_banked``
emits the JAX engine's tokens from the same weights, the CLI runs (and
refuses the architectures that are not ported), the scaling factors are
exactly the JAX package's, and checkpoints move both ways through the
flat-npz format."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.checkpoint import io as jio                         # noqa: E402
from repro.configs.base import (FederatedConfig, LoRAConfig,   # noqa: E402
                                ModelConfig, OptimizerConfig)
from repro.core import lora as jlora                           # noqa: E402
from repro.core import scaling as jscaling                     # noqa: E402
from repro.core.federated import FederatedTrainer              # noqa: E402
from repro.data.synthetic import FederatedDataset              # noqa: E402
from repro.launch import serve as jserve                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint import io as tio                   # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.core import scaling as tscaling               # noqa: E402
from repro_torch.core.quant import apply_quant_flag            # noqa: E402
from repro_torch.kernels import bgmv                           # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def served():
    """Reduced gemma-2b in both packages, same weights, a 3-tenant
    mixed-rank bank with nonzero B, and a numpy prompt."""
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    jm = japi.build_model(jcfg)
    tm = tapi.build_model(tconfigs.get_config("gemma-2b").reduced())
    jp = jm.init(jax.random.key(0))
    tp = tio.params_from_numpy(_np(jp), "cpu")
    rng = np.random.default_rng(11)
    jsets, tsets = [], []
    for i, r in enumerate((8, 4, 16)):
        js = jlora.init_adapter_set(jp, jax.random.key(20 + i),
                                    LoRAConfig(rank=r), n_clients=3)
        lora = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), _np(js.lora))
        jsets.append(dataclasses.replace(
            js, lora=jax.tree.map(jnp.asarray, lora)))
        tsets.append(tlora.AdapterSet(lora=tio.params_from_numpy(lora, "cpu"),
                                      gamma=js.gamma, rank=r,
                                      alpha=js.alpha))
    prompt = rng.integers(0, jcfg.vocab_size, (3, 6)).astype(np.int32)
    return (jm, tm, jp, tp, jlora.AdapterBank.from_sets(jsets),
            tlora.AdapterBank.from_sets(tsets), prompt)


def test_generate_banked_tokens_match_jax_and_hostloop(served):
    jm, tm, jp, tp, jbank, tbank, prompt = served
    ids = np.array([2, 0, 1], np.int32)
    want = np.asarray(jserve.generate_banked(jm, jp, jbank, jnp.asarray(ids),
                                             jnp.asarray(prompt), 8, 14))
    bgmv.reset_launches()
    got = tserve.generate_banked(tm, tp, tbank, ids, torch.from_numpy(prompt),
                                 8, 14)
    assert bgmv.launches == {"bgmv_matmul": 0, "bgmv_gemv": 0,   # CPU: plain
                             "bgmv_matmul_quant": 0, "bgmv_gemv_quant": 0}
    np.testing.assert_array_equal(got.numpy(), want)
    host = tserve.generate_hostloop(tm, tp, torch.from_numpy(prompt), 8, 14,
                                    adapters=tbank.requests(ids))
    np.testing.assert_array_equal(host.numpy(), want)
    assert int(got[:, 6:].max()) < tm.cfg.vocab_size


def test_generate_rejects_bad_ids_and_zero_steps(served):
    _, tm, _, tp, _, tbank, prompt = served
    with pytest.raises(ValueError, match="out of range"):
        tserve.generate_banked(tm, tp, tbank, [0, 3, 1],
                               torch.from_numpy(prompt), 2, 8)
    with pytest.raises(ValueError, match="steps"):
        tserve.generate(tm, tp, torch.from_numpy(prompt), 0, 8)


_CLI = ["--arch", "gemma-2b", "--reduced", "--device", "cpu", "--steps", "2",
        "--batch", "2"]


@pytest.mark.parametrize("extra", [[], ["--merge", "0"],
                                   ["--ranks", "4,8", "--temperature", "0.7"]])
def test_cli_runs_on_cpu(extra, capsys):
    seq = tserve.main(_CLI + extra)
    assert tuple(seq.shape) == (2, 6)
    assert "ms/token on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--arch", "qwen3-8b"], ["--arch", "recurrentgemma-9b"],
    ["--arch", "qwen2-moe-a2.7b"], ["--arch", "whisper-medium"],
    ["--arch", "xlstm-1.3b"]])
def test_cli_unported_flags_raise(flags):
    """--arch values whose block kinds the port does not run yet raise."""
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tserve.main(_CLI + flags)


@pytest.mark.parametrize("extra", [
    ["--arrival-trace", "poisson:50:5"],
    ["--arrival-trace", "poisson:50:5", "--hot-slots", "2",
     "--deadline-steps", "1", "--max-batch", "2"],
    ["--arrival-trace", "poisson:50:5", "--quant", "int4",
     "--quant-group", "32", "--block-size", "2", "--chunk", "1"],
    ["--quant", "int8"], ["--quant", "int4", "--merge", "1"]])
def test_cli_scheduled_and_quant_run_on_cpu(extra, capsys):
    """The flags the continuous-batching and packed-base slice enabled:
    each CLI run completes on the CPU and prints the JAX CLI's summary."""
    out = tserve.main(_CLI + extra)
    text = capsys.readouterr().out
    if "--arrival-trace" in extra:
        deadline = "--deadline-steps" in extra
        assert [len(r.tokens) for r in out] == [1 if deadline else 2] * 5
        assert "scheduled serve: 5 requests, 4 tenants" in text
        assert ("timeouts=5" in text) == deadline
        assert ("promotions" in text) == ("--hot-slots" in extra)
    else:
        assert tuple(out.shape) == (2, 6) and "ms/token on cpu" in text


def test_cli_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("scheme", ["lora", "rslora", "sfedlora", "za", "zb"])
def test_scaling_factor_exactly_jax(scheme):
    for alpha in (1.0, 8.0, 16.0):
        for r in (1, 4, 8, 64, 256):
            for n in (1, 3, 4, 10):
                assert tscaling.scaling_factor(scheme, alpha, r, n) == \
                    jscaling.scaling_factor(scheme, alpha, r, n)
    assert tscaling.per_client_gammas(scheme, 8.0, (4, 8, 16), 3) == \
        jscaling.per_client_gammas(scheme, 8.0, (4, 8, 16), 3)
    for bad in ((0, 3), (4, 0)):
        with pytest.raises(ValueError):
            tscaling.scaling_factor(scheme, 8.0, *bad)


def test_npz_roundtrip_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "stack": {"repeat": {"p0": {"q": rng.standard_normal(
                (2, 4, 4)).astype(np.float32)}}},
            "ids": np.arange(5, dtype=np.int32),
            "hist": [np.float32(1.5), np.ones(2, np.float32)],
            "note": np.asarray("seeded")}
    jio.save_pytree(str(tmp_path / "j.npz"), jax.tree.map(jnp.asarray, {
        k: v for k, v in tree.items() if k != "note"}) | {"note": tree["note"]})
    loaded = tio.load_pytree(str(tmp_path / "j.npz"))
    jax.tree.map(np.testing.assert_array_equal, loaded, tree)
    tio.save_pytree(str(tmp_path / "t.npz"),
                    tio.params_from_numpy(loaded, "cpu"))
    back = jio.load_pytree(str(tmp_path / "t.npz"))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 back, tree)


def test_quantized_checkpoint_raises(tmp_path):
    """A packed checkpoint written by the JAX package loads into the port
    with its bytes; restoring it under a different --quant raises."""
    from repro.core.quant import quantize
    w = jnp.asarray(np.random.default_rng(0).standard_normal((8, 4)),
                    jnp.float32)
    jq = quantize(w, bits=8)
    jio.save_pytree(str(tmp_path / "q.npz"), {"w": jq})
    got = tio.load_pytree(str(tmp_path / "q.npz"))["w"]
    np.testing.assert_array_equal(got.data, np.asarray(jq.data))
    np.testing.assert_array_equal(got.scales, np.asarray(jq.scales))
    assert (got.bits, got.k) == (8, 8)
    with pytest.raises(ValueError, match="--quant int8"):
        apply_quant_flag({"attn": {"q": got}}, "int4")


def test_jax_federated_checkpoint_serves_through_port(tmp_path):
    """A checkpoint the JAX trainer wrote (mixed client ranks, so gammas
    and a rank mask ride along) serves from the port: the port's bank
    reproduces the JAX trainer's per-client logits."""
    jcfg = ModelConfig(name="ck", family="dense", num_layers=2, d_model=32,
                       num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64,
                       vocab_size=64)
    jm = japi.build_model(jcfg)
    ds = FederatedDataset(64, 2, seq_len=16, batch_per_client=2, seed=3)
    tr = FederatedTrainer(jm, ds, lora_cfg=LoRAConfig(rank=4, ranks=(2, 4)),
                          fed_cfg=FederatedConfig(num_clients=2,
                                                  local_steps=1,
                                                  aggregation="fedsa"),
                          opt_cfg=OptimizerConfig(name="sgd", lr=0.05),
                          seed=3)
    tr.run(1)
    path = str(tmp_path / "ck.npz")
    tr.save(path)
    base, aset = tio.load_adapter_state(path, device="cpu")
    assert aset.rank_mask is not None and aset.alpha == tr.lora_cfg.alpha
    bank = tlora.AdapterBank.from_adapter_set(aset)
    assert bank.ranks == (2, 4)
    tm = tapi.build_model(TModelConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(TModelConfig)}))
    toks = np.asarray(tr.dataset.eval_batch(2))
    got, _ = tm.forward(base, {"tokens": torch.from_numpy(toks)},
                        adapters=bank.requests([0, 1]))
    for c in range(2):
        want, _ = jm.forward(tr.base, {"tokens": jnp.asarray(toks[c:c + 1])},
                             adapters=tr.client_adapters(c))
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want[0]),
                                   rtol=1e-4, atol=1e-4)
