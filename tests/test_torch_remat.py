"""The port's recompute in training against the JAX package, on the CPU.

- Blocked attention (``models/attention.blockwise_attention``, above
  ``BLOCKWISE_THRESHOLD``) checkpoints each kv step, as JAX runs
  ``jax.checkpoint(kv_step)``: at s 4096 (2 heads on 1 kv head, hd 64) its
  output sum and gradients are JAX's within 1e-4 x max(1, max|ref|), and
  the tensors it saves for the backward, counted through
  ``torch.autograd.graph.saved_tensors_hooks``, come to at most 113 MB (a
  quarter of the 452.6 MB the unchecked loops saved; the whole fp32 score
  matrix is 134 MB).
- ``apply_stack(remat=True)``, the default of every caller as in JAX,
  checkpoints each repeat unit: on a 2-layer stack its loss and LoRA
  gradients equal ``remat=False``'s bit for bit and JAX's within 1e-4 x
  max(1, max|ref|), and it saves fewer bytes.

Tolerance, with its reason: fp32 on both sides, sums taken in another
order by XLA and by PyTorch's CPU kernels."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as jconfigs                          # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import lora as jlora                           # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro.models import attention as jattn                    # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy        # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.models import attention as tattn              # noqa: E402
from repro_torch.models import transformer as ttransformer     # noqa: E402
from repro_torch.tree import tree_leaves                       # noqa: E402

TOL = 1e-4
SAVED_BOUND = 113e6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its small ops gain nothing
    from more, and the suite's parallel workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=TOL * max(1.0, float(np.abs(want).max())))


def _saved_bytes(fn):
    """(fn(), bytes of every tensor autograd saved while it ran)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


def test_blocked_attention_saves_only_the_carries():
    s, h, kh, hd = 4096, 2, 1, 64
    rng = np.random.default_rng(0)
    q, k, v, w = (rng.standard_normal(shape).astype(np.float32) for shape in
                  ((1, s, h, hd), (1, s, kh, hd), (1, s, kh, hd),
                   (1, s, h, hd)))
    pos = np.arange(s, dtype=np.int32)[None]
    jcfg = jconfigs.get_config("gemma-2b").reduced()
    tcfg = tconfigs.get_config("gemma-2b").reduced()

    def jloss(q_, k_, v_):
        out = jattn.blockwise_attention(jcfg, q_, k_, v_, jnp.asarray(pos),
                                        jnp.asarray(pos), causal=True,
                                        window=None)
        return jnp.sum(out * w)
    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    tpos = torch.from_numpy(pos).long()
    assert s > tattn.BLOCKWISE_THRESHOLD
    out, saved = _saved_bytes(lambda: tattn.blockwise_attention(
        tcfg, tq, tk, tv, tpos, tpos, causal=True, window=None))
    tl = (out * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(tl, (tq, tk, tv))
    assert saved <= SAVED_BOUND, saved
    _close(tl.detach().numpy(), jl)
    for got, want in zip(grads, jg):
        assert float(np.abs(np.asarray(want)).max()) > 0
        _close(got.numpy(), want)


def _loss_and_grads(tm, tparams, lora, toks, gamma, remat):
    """Model.loss and its LoRA gradients, with ``apply_stack``'s remat on
    (every caller's default) or off; and the bytes saved for the
    backward."""
    leaves = params_from_numpy(lora, "cpu")
    for t in tree_leaves(leaves):
        t.requires_grad_(True)
    stack = functools.partial(ttransformer.apply_stack, remat=remat)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "apply_stack", stack)
        (tl, _), saved = _saved_bytes(lambda: tm.loss(
            tparams, {"tokens": torch.from_numpy(toks)},
            adapters=tlora.AdapterSet(lora=leaves, gamma=gamma)))
        grads = torch.autograd.grad(tl, tree_leaves(leaves))
    return tl.detach(), grads, saved


def test_remat_of_repeat_units_is_bit_for_bit_and_matches_jax():
    jcfg = jconfigs.get_config("gemma-2b").reduced(num_layers=2)
    tcfg = tconfigs.get_config("gemma-2b").reduced(num_layers=2)
    jm, tm = japi.build_model(jcfg), tapi.build_model(tcfg)
    jparams = jm.init(jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert tree_leaves(tparams["stack"]["repeat"])[0].shape[0] == 2
    rng = np.random.default_rng(3)
    lora = jlora.init_lora(jparams, jax.random.key(1),
                           jbase.LoRAConfig(rank=8))
    lora = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(
        x.shape).astype(np.float32), lora)
    toks = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    gamma = 2.0

    def jloss(lo):
        return jm.loss(jparams, {"tokens": jnp.asarray(toks)},
                       adapters=jlora.AdapterSet(lora=lo, gamma=gamma))[0]
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, lora))

    loss, grads, saved = _loss_and_grads(tm, tparams, lora, toks, gamma,
                                         remat=True)
    kept_loss, kept, kept_saved = _loss_and_grads(tm, tparams, lora, toks,
                                                  gamma, remat=False)
    assert torch.equal(loss, kept_loss)
    for a, b in zip(grads, kept, strict=True):
        assert torch.equal(a, b)
    assert saved < kept_saved, (saved, kept_saved)
    _close(loss.numpy(), jl)
    for got, want in zip(grads, jax.tree.leaves(jg), strict=True):
        assert float(np.abs(np.asarray(want)).max()) > 0
        _close(got.numpy(), want)
