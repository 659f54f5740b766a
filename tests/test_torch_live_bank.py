"""repro_torch's live adapter bank against the JAX package, on the CPU.

  * ``AdapterBank.publish`` swaps exactly one slot (in place, or into a copy
    with ``donate=False``), as the JAX bank does, and rejects a rank above
    ``r_max``.
  * ``LiveAdapterBank`` promotes, demotes and pins as the JAX live bank does
    through the same ``acquire`` / ``touch`` / ``publish`` sequence.
  * Scheduled tokens over a live bank with host overflow (2 hot slots for 4
    tenants) equal the static bank's.
  * ``publish_adapter_state`` streams a checkpoint's clients into a live bank
    as the JAX package does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import io as jio                         # noqa: E402
from repro.configs.base import LoRAConfig as JLoRAConfig       # noqa: E402
from repro.configs.base import ModelConfig as JModelConfig     # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro_torch.checkpoint import io as tio                   # noqa: E402
from repro_torch.configs.base import ModelConfig               # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.tree import tree_leaves                       # noqa: E402

CFG = dict(name="live", family="dense", num_layers=2, d_model=32,
           num_heads=2, num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """Weights in both packages and 4 adapter sets of ranks 2, 4, 4, 8 (B
    drawn nonzero with numpy) in both."""
    jm = japi.build_model(JModelConfig(**CFG))
    jp = jm.init(jax.random.key(0))
    tm = tapi.build_model(ModelConfig(**CFG))
    tp = tio.params_from_numpy(_np(jp), "cpu")
    rng = np.random.default_rng(9)
    jsets, tsets = [], []
    for i, r in enumerate((2, 4, 4, 8)):
        js = jlora.init_adapter_set(
            jp, jax.random.key(40 + i),
            JLoRAConfig(rank=r, alpha=8.0, targets=jm.cfg.lora_targets),
            n_clients=4)
        lora = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), _np(js.lora))
        jsets.append(dataclasses.replace(
            js, lora=jax.tree.map(jnp.asarray, lora)))
        tsets.append(tlora.AdapterSet(lora=tio.params_from_numpy(lora, "cpu"),
                                      gamma=js.gamma, rank=r, alpha=js.alpha))
    return jm, jp, tm, tp, jsets, tsets


def _assert_bank_equal(tbank, jbank):
    assert tbank.ranks == jbank.ranks
    np.testing.assert_array_equal(tbank.rank_mask, np.asarray(jbank.rank_mask))
    for t, j in zip(tree_leaves(tbank.lora), jax.tree.leaves(jbank.lora),
                    strict=True):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)


def test_publish_swaps_one_slot_and_rejects_rank(setup):
    _, _, _, _, jsets, tsets = setup
    tbank = tlora.AdapterBank.from_sets(tsets[:3])
    jbank = jlora.AdapterBank.from_sets(jsets[:3])
    before = [t.clone() for t in tree_leaves(tbank.lora)]
    # a copy: the old bank stays readable and unchanged
    tnew = tbank.publish(1, tsets[0], donate=False)
    jnew = jbank.publish(1, jsets[0], donate=False)
    assert tnew.version == 1 and tbank.version == 0
    _assert_bank_equal(tnew, jnew)
    for old, now in zip(before, tree_leaves(tbank.lora)):
        assert torch.equal(old, now)
    for old, now in zip(before, tree_leaves(tnew.lora)):
        assert torch.equal(old[0], now[0]) and torch.equal(old[2], now[2])
    # in place (the JAX package donates the leaves)
    tin = tbank.publish(2, tsets[1])
    _assert_bank_equal(tin, jbank.publish(2, jsets[1], donate=False))
    assert all(a is b for a, b in zip(tree_leaves(tin.lora),
                                      tree_leaves(tbank.lora)))
    with pytest.raises(ValueError, match="r_max"):
        tin.publish(0, tsets[3])                       # rank 8 > r_max 4
    with pytest.raises(ValueError, match="out of range"):
        tin.publish(3, tsets[0])


def test_live_bank_lifecycle_follows_jax(setup):
    """The same acquire / touch / publish sequence through both live banks:
    the same slot maps, refusals, residency and counters, and the same
    device bank."""
    _, _, _, _, jsets, tsets = setup
    tl = tlora.LiveAdapterBank.from_sets(tsets, hot_slots=2, device="cpu")
    jl = jlora.LiveAdapterBank.from_sets(jsets, hot_slots=2)
    steps = [("acquire", [0, 1], ()), ("touch", [1]),
             ("acquire", [2], (0,)), ("acquire", [3], (0, 1)),
             ("acquire", [3], (1,)), ("publish", 3, 1),
             ("publish", 2, 0), ("touch", [3, 3]), ("acquire", [0, 2], ()),
             ("acquire", [1, 0], (1,))]
    for step in steps:
        if step[0] == "acquire":
            got = tl.acquire(step[1], step[2])
            assert got == jl.acquire(step[1], step[2])
        elif step[0] == "touch":
            tl.touch(step[1])
            jl.touch(step[1])
        else:
            _, tenant, src = step
            assert tl.publish(tenant, tsets[src]) == \
                jl.publish(tenant, jsets[src])
        assert tl.slot_tenant == jl.slot_tenant
        assert (tl.promotions, tl.demotions, tl.swaps) == \
            (jl.promotions, jl.demotions, jl.swaps)
        _assert_bank_equal(tl.bank, jl.bank)
    assert tl.promotions > 0 and tl.demotions > 0 and tl.swaps > 0
    with pytest.raises(KeyError):
        tl.acquire([7])


def test_scheduled_over_live_bank_equals_static(setup):
    """4 tenants, 2 hot slots: admission defers and promotes, and the tokens
    equal those of the same stream over the static bank."""
    _, _, tm, tp, _, tsets = setup
    static = tlora.AdapterBank.from_sets(tsets)
    live = tlora.LiveAdapterBank.from_bank(static, hot_slots=2)
    prompts = np.random.default_rng(3).integers(0, 64, (6, 5)).astype(
        np.int32)
    ids = [0, 1, 2, 3, 2, 0]

    def run(bank):
        reqs = [tserve.Request(rid=i, prompt=prompts[i], steps=6,
                               adapter_id=ids[i]) for i in range(6)]
        done = tserve.serve_scheduled(tm, tp, reqs, bank=bank, wait=False,
                                      max_batch=4, block_size=4, chunk=3)
        return [r.tokens for r in done]

    assert run(live) == run(static)
    assert live.promotions > 0 and live.demotions > 0


def test_publish_adapter_state_round_trip(setup, tmp_path):
    """A federated checkpoint written by the JAX trainer's saver (3 clients,
    each with its own gamma), streamed into live banks of both packages:
    the same stores, the same resident device slots."""
    _, jp, _, tp, jsets, tsets = setup
    stacked = jlora.AdapterSet.stack(
        [dataclasses.replace(jsets[i], gamma=g)
         for i, g in zip((1, 2, 1), (0.5, 1.5, 2.0))])
    path = str(tmp_path / "ck.npz")
    jio.save_federated_state(
        path, jp, stacked.lora, {}, 1,
        adapter_meta={"gammas": np.asarray(stacked.gamma, np.float32),
                      "rank": 4, "alpha": 8.0})
    tl = tlora.LiveAdapterBank.from_sets(tsets, hot_slots=2, device="cpu")
    jl = jlora.LiveAdapterBank.from_sets(jsets, hot_slots=2)
    base, n = tio.publish_adapter_state(path, tl)
    _, jn = jio.publish_adapter_state(path, jl)
    assert n == jn == 3
    assert tl.swaps == jl.swaps == 2            # clients 0, 1 were resident
    for t in range(4):
        assert tl.tenant_version(t) == jl.tenant_version(t)
        for a, b in zip(tree_leaves(tl.store[t]["lora"]),
                        jax.tree.leaves(jl.store[t]["lora"]), strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    _assert_bank_equal(tl.bank, jl.bank)
    for a, b in zip(tree_leaves(base), tree_leaves(tp), strict=True):
        assert torch.equal(a, b)
