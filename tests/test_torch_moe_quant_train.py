"""repro_torch's MoE family trained over a packed base, against the JAX
trainer, on the CPU.

The reduced qwen2-moe-a2.7b (2 layers, d_model 64, 4 experts top-2, 1
shared expert) over int8 and int4, and the reduced granite-moe-1b-a400m
(4 experts top-2, no shared expert) over int4: the JAX-drawn base packed by
both packages to the same bytes (group 32; only q / k / v / o pack, the
experts stay fp), then fedsa + sfedlora under SGD for 3 rounds from the
JAX trainer's adapter draw.  Held within 1e-4 (relative to max(1, |ref|)):
each round's loss and grad-norm, and the final LoRA leaves.

Tolerance, with its reason: fp32 activations on both sides over the same
packed bytes, sums taken in another order by XLA and by PyTorch's CPU
kernels."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs                          # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.core import quant as jquant                         # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy        # noqa: E402
from repro_torch.configs import base as tbase                  # noqa: E402
from repro_torch.core import federated as tfed                 # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.core import quant as tquant                   # noqa: E402
from repro_torch.data import synthetic as tsyn                 # noqa: E402
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
VOCAB = 256
GROUP = 32
ROUNDS = 3
CASES = {"qwen2-moe-int8": ("qwen2-moe-a2.7b", "int8"),
         "qwen2-moe-int4": ("qwen2-moe-a2.7b", "int4"),
         "granite-moe-int4": ("granite-moe-1b-a400m", "int4")}


@pytest.fixture(scope="module")
def bases():
    """(jax config, port config, jax model, jax fp32 base) of an arch,
    drawn once."""
    out = {}

    def get(arch):
        if arch not in out:
            jcfg = jconfigs.get_config(arch).reduced(d_model=64,
                                                     vocab_size=VOCAB)
            tcfg = tconfigs.get_config(arch).reduced(d_model=64,
                                                     vocab_size=VOCAB)
            jm = japi.build_model(jcfg)
            out[arch] = (jcfg, tcfg, jm, jm.init(jax.random.key(0)))
        return out[arch]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_packed_moe_trajectory_matches_jax(bases, case):
    arch, mode = CASES[case]
    jcfg, tcfg, jm, jparams = bases(arch)
    jq = jquant.quantize_tree(jparams, mode, GROUP)
    tq = tquant.quantize_tree(
        params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"), mode,
        GROUP)
    assert tquant.has_quantized(tq)
    for t, j in zip(tree_leaves(tq), jax.tree.leaves(jq)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    moe = tq["stack"]["repeat"]["p0"]["moe"]
    assert not any(isinstance(v, tquant.QuantizedLinear)
                   for v in tree_leaves(moe))
    n = 3
    lcfg = dict(rank=8, alpha=8.0, scaling="sfedlora")
    fcfg = dict(num_clients=n, local_steps=2, aggregation="fedsa")
    ocfg = dict(name="sgd", lr=0.5)
    ds_kw = dict(seq_len=16, batch_per_client=2, seed=0)
    jtr = jfed.FederatedTrainer(
        jm, jsyn.FederatedDataset(VOCAB, n, **ds_kw),
        lora_cfg=jbase.LoRAConfig(**lcfg),
        fed_cfg=jbase.FederatedConfig(**fcfg),
        opt_cfg=jbase.OptimizerConfig(**ocfg), seed=0, base_params=jq)
    lora1 = jax.tree.map(lambda x: np.asarray(x[0]), jtr.lora)
    ttr = tfed.FederatedTrainer(
        tapi.build_model(tcfg), tsyn.FederatedDataset(VOCAB, n, **ds_kw),
        lora_cfg=tbase.LoRAConfig(**lcfg),
        fed_cfg=tbase.FederatedConfig(**fcfg),
        opt_cfg=tbase.OptimizerConfig(**ocfg), seed=0, base_params=tq,
        lora_init=lora1, device="cpu")
    jtr.run(ROUNDS)
    ttr.run(ROUNDS)
    assert len(ttr.history) == len(jtr.history) == ROUNDS
    for th, jh in zip(ttr.history, jtr.history):
        for key in ("loss", "grad_norm"):
            assert abs(th[key] - jh[key]) <= TRAJ_RTOL * max(
                1.0, abs(float(jh[key]))), (key, th, jh)
    for got, want in zip(tree_leaves(ttr.lora), jax.tree.leaves(jtr.lora)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=TRAJ_RTOL * max(1.0, float(np.abs(want).max())))
    b_max = max(float(t.abs().max()) for t in tree_leaves(
        tlora.split_ab(ttr.lora)[1]))
    assert b_max > 0, "B stayed zero: no training happened"
