"""repro_torch's packed frozen base against the JAX package, on the CPU.

  * ``quantize`` packs the same fp32 weights into the same bytes and scales
    as the JAX package (int8; int4 at group 2, 32, 64 and a k that is not a
    multiple of the group), and ``dequantize`` gives the same weights.
  * The plain versions of kernels #3, #4 (``bgmv_*_quant``) and #11
    (``quant_matmul``) match the JAX Pallas kernels in interpret mode and
    the JAX reference expression within 1e-5.
  * Packed checkpoints move between the packages; ``apply_quant_flag``,
    ``requantize_merged`` and ``quant_footprint`` behave as the JAX ones.
  * Banked ``generate_banked`` and scheduled tokens over an int8 and an int4
    base equal the JAX reference tier's (which dequantizes up front).
  * The dispatcher routes packed weights to the quantized kernels (#3, #4,
    #9, #11); what check_packed tells them per ``out_dtype``.
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
from repro.core import quant as jquant                         # noqa: E402
from repro.kernels.bgmv import (bgmv_gemv_quant,               # noqa: E402
                                bgmv_matmul_quant, bgmv_reference)
from repro.kernels.lora_matmul import quant_matmul_vjp         # noqa: E402
from repro.launch import serve as jserve                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro_torch.checkpoint import io as tio                   # noqa: E402
from repro_torch.configs.base import ModelConfig               # noqa: E402
from repro_torch.core import lora as tlora                     # noqa: E402
from repro_torch.core import quant as tquant                   # noqa: E402
from repro_torch.kernels import bgmv, dispatch, lora_matmul    # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.tree import tree_leaves                       # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its small ops gain nothing
    from more, and the suite's parallel workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5       # plain versions vs the JAX kernels and reference: fp32 sums

CFG = dict(name="quant", family="dense", num_layers=2, d_model=64,
           num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _from_jax(q):
    """A JAX QuantizedLinear as the port's, over CPU tensors."""
    return tquant.QuantizedLinear(torch.from_numpy(np.array(q.data)),
                                  torch.from_numpy(np.array(q.scales)),
                                  q.bits, q.group_size, q.k, q.out_dtype)


def _assert_packed_equal(t, j):
    assert (t.bits, t.group_size, t.k, t.out_dtype) == \
        (j.bits, j.group_size, j.k, j.out_dtype)
    np.testing.assert_array_equal(np.asarray(t.data), np.asarray(j.data))
    np.testing.assert_array_equal(np.asarray(t.scales), np.asarray(j.scales))


@pytest.mark.parametrize("bits,group,shape", [
    (8, 64, (64, 32)), (4, 2, (64, 32)), (4, 32, (3, 96, 24)),
    (4, 64, (128, 48)), (4, 64, (70, 50))])
def test_packed_bytes_equal_jax(bits, group, shape):
    w = (np.random.default_rng(bits + group).standard_normal(shape)
         * 0.1).astype(np.float32)
    t = tquant.quantize(torch.from_numpy(w), bits, group)
    j = jquant.quantize(jnp.asarray(w), bits, group)
    _assert_packed_equal(t, j)
    assert t.shape == j.shape and t.nbytes == j.nbytes
    np.testing.assert_array_equal(tquant.dequantize(t).numpy(),
                                  np.asarray(jquant.dequantize(j)))
    back = tquant.dequantize(_from_jax(j))          # JAX bytes, port deq
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jquant.dequantize(j)))
    assert t.check_layout() == (0 if bits == 8 else group)


def test_check_layout_rejects_bad_bytes():
    q = tquant.quantize(torch.randn(70, 8), 4, 64)
    with pytest.raises(ValueError, match="layout"):
        dataclasses.replace(q, k=130).check_layout()
    with pytest.raises(ValueError, match="layout"):
        dataclasses.replace(q, data=q.data.to(torch.int8)).check_layout()


@pytest.mark.parametrize("bits", [8, 4])
def test_kernels_take_only_a_base_packed_from_fp32(bits):
    """What the packed kernels are told per ``out_dtype``: the group size
    they index scales with (0 for int8) and the flag that makes their
    loaders round each fp32 product to bf16, set for a base packed from
    bf16 weights, which ``dequantize`` rounds so; any other dtype is
    refused before a launch."""
    from repro_torch.kernels.common import check_packed
    w = torch.randn(70, 8)
    group = 0 if bits == 8 else 64
    assert check_packed(tquant.quantize(w, bits, 64), "quant_matmul") == \
        (group, 0)
    assert check_packed(tquant.quantize(w.bfloat16(), bits, 64),
                        "quant_matmul") == (group, 1)
    with pytest.raises(TypeError, match="float16"):
        check_packed(tquant.quantize(w.half(), bits, 64), "quant_matmul")


def _kernel_operands(bits, k, seed=4):
    B, s, n, r, K = 4, 8, 64, 4, 3
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, s, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    a = (rng.standard_normal((K, r, k)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((K, n, r)) * 0.05).astype(np.float32)
    ids = np.asarray([0, 2, 1, 2], np.int32)
    return x, w, a, b, ids


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("k", [128, 100])
def test_bgmv_quant_plain_matches_jax(bits, k):
    """#3 and #4's plain versions against the JAX kernels (interpret mode)
    and the JAX reference expression over the dequantized W."""
    x, w, a, b, ids = _kernel_operands(bits, k)
    jq = jquant.quantize(jnp.asarray(w), bits, 64)
    tq = _from_jax(jq)
    tx, ta, tb, tids = (torch.from_numpy(v) for v in (x, a, b, ids))
    got = bgmv.bgmv_matmul_quant_plain(tx, tq, ta, tb, tids).numpy()
    kern = bgmv_matmul_quant(jnp.asarray(x), jq.data, jq.scales,
                             jnp.asarray(a), jnp.asarray(b), jnp.asarray(ids),
                             bits=bits, interpret=True)
    ref = bgmv_reference(jnp.asarray(x), jquant.dequantize(jq),
                         jnp.asarray(a), jnp.asarray(b), jnp.asarray(ids))
    np.testing.assert_allclose(got, np.asarray(kern), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL, atol=TOL)
    got1 = bgmv.bgmv_gemv_quant_plain(tx[:, 0], tq, ta, tb, tids).numpy()
    kern1 = bgmv_gemv_quant(jnp.asarray(x[:, 0]), jq.data, jq.scales,
                            jnp.asarray(a), jnp.asarray(b), jnp.asarray(ids),
                            bits=bits, interpret=True)
    np.testing.assert_allclose(got1, np.asarray(kern1), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got1, np.asarray(ref)[:, 0], rtol=TOL,
                               atol=TOL)
    # on CPU tensors the wrappers are the plain versions and count nothing
    bgmv.reset_launches()
    assert torch.equal(bgmv.bgmv_matmul_quant(tx, tq, ta, tb, tids),
                       torch.from_numpy(got))
    assert not any(bgmv.launches.values())


@pytest.mark.parametrize("bits,group", [(8, 64), (4, 64), (4, 32)])
def test_quant_matmul_plain_matches_jax(bits, group):
    """#11's plain version against the JAX kernel (interpret mode, operands
    already at its block multiples) and x @ dequantize(W)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 64)) * 0.1).astype(np.float32)
    jq = jquant.quantize(jnp.asarray(w), bits, group)
    got = lora_matmul.quant_matmul_plain(torch.from_numpy(x), _from_jax(jq))
    kern = quant_matmul_vjp(jnp.asarray(x), jq.data, jq.scales, bits=bits,
                            bm=64, bn=64, bk=64, interpret=True)
    ref = jnp.asarray(x) @ jquant.dequantize(jq)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


# ------------------------------------------------------- trees and flags

@pytest.fixture(scope="module")
def models():
    jm = japi.build_model(JModelConfig(**CFG))
    jp = jm.init(jax.random.key(0))
    tm = tapi.build_model(ModelConfig(**CFG))
    tp = tio.params_from_numpy(_np(jp), "cpu")
    rng = np.random.default_rng(8)
    jsets, tsets = [], []
    for i, r in enumerate((4, 8)):
        js = jlora.init_adapter_set(
            jp, jax.random.key(50 + i),
            JLoRAConfig(rank=r, alpha=8.0, targets=jm.cfg.lora_targets),
            n_clients=2)
        lora = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), _np(js.lora))
        jsets.append(dataclasses.replace(
            js, lora=jax.tree.map(jnp.asarray, lora)))
        tsets.append(tlora.AdapterSet(lora=tio.params_from_numpy(lora, "cpu"),
                                      gamma=js.gamma, rank=r, alpha=js.alpha))
    return (jm, jp, tm, tp, jlora.AdapterBank.from_sets(jsets),
            tlora.AdapterBank.from_sets(tsets))


def _packed_pairs(t, j):
    """(port leaf, JAX leaf) for every packed leaf, walking both trees."""
    if isinstance(t, dict):
        return [p for k in t for p in _packed_pairs(t[k], j.get(k, {}))]
    return [(t, j)] if isinstance(t, tquant.QuantizedLinear) else []


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_tree_flags_and_footprint_match_jax(models, mode):
    jm, jp, tm, tp, jbank, tbank = models
    tq = tquant.apply_quant_flag(tp, mode, 32)
    jq = jquant.apply_quant_flag(jp, mode, 32)
    pairs = _packed_pairs(tq, jq)
    assert len(pairs) == 7                  # q, k, v, o, w_up, w_gate, w_down
    for t, j in pairs:
        _assert_packed_equal(t, j)
    assert tquant.tree_quant_mode(tq) == mode and tquant.has_quantized(tq)
    assert tquant.apply_quant_flag(tq, mode) is tq
    other = "int4" if mode == "int8" else "int8"
    with pytest.raises(ValueError, match=f"--quant {mode}"):
        tquant.apply_quant_flag(tq, other)
    assert tquant.quant_footprint(tq) == jquant.quant_footprint(jq)
    assert tquant.quant_footprint(tp) == jquant.quant_footprint(jp)
    for t, j in zip(tree_leaves(tquant.dequantize_tree(tq)),
                    jax.tree.leaves(jquant.dequantize_tree(jq)), strict=True):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_requantize_merged_matches_jax(models):
    """--merge --quant: tenant 1 merged in fp, then packed onto the base's
    grid, as the JAX package does."""
    jm, jp, tm, tp, jbank, tbank = models
    tq, jq = (tquant.quantize_tree(tp, "int4", 32),
              jquant.quantize_tree(jp, "int4", 32))
    tm_ = tquant.requantize_merged(tbank.adapter(1).merge(tq), tq)
    jm_ = jquant.requantize_merged(jbank.adapter(1).merge(jq), jq)
    pairs = _packed_pairs(tm_, jm_)
    assert len(pairs) == 7
    for t, j in pairs:
        np.testing.assert_allclose(np.asarray(t.scales), np.asarray(j.scales),
                                   rtol=1e-6)
        # the merge's fp32 sums may round a value across a grid midpoint
        assert (np.asarray(t.data) != np.asarray(j.data)).mean() < 1e-3


def test_packed_checkpoint_moves_both_ways(models, tmp_path):
    _, jp, _, tp, _, _ = models
    jq = jquant.quantize_tree(jp, "int4", 32)
    jio.save_pytree(str(tmp_path / "j.npz"), {"base": jq})
    loaded = tio.params_from_numpy(tio.load_pytree(str(tmp_path / "j.npz")),
                                   "cpu")["base"]
    pairs = _packed_pairs(loaded, jq)
    assert len(pairs) == 7
    for t, j in pairs:
        _assert_packed_equal(t, j)
        assert isinstance(t.data, torch.Tensor) and t.data.dtype == torch.uint8
    tq = tquant.quantize_tree(tp, "int8")
    tio.save_pytree(str(tmp_path / "t.npz"), {"base": tq})
    back = jio.load_pytree(str(tmp_path / "t.npz"))["base"]
    for t, j in _packed_pairs(tq, back):
        _assert_packed_equal(t, j)


# --------------------------------------------------- tokens over a packed base

@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_tokens_over_packed_base_match_jax(models, mode):
    """The port packs its fp32 weights itself; the JAX reference tier packs
    the same weights and dequantizes up front.  Fixed-batch and scheduled
    greedy tokens are the same in both packages."""
    jm, jp, tm, tp, jbank, tbank = models
    tq = tquant.quantize_tree(tp, mode, 32)
    jq = jquant.quantize_tree(jp, mode, 32)
    prompts = np.random.default_rng(2).integers(0, 64, (3, 6)).astype(
        np.int32)
    ids = np.asarray([1, 0, 1], np.int32)
    want = np.asarray(jserve.generate_banked(jm, jq, jbank, jnp.asarray(ids),
                                             jnp.asarray(prompts), 7, 13))
    got = tserve.generate_banked(tm, tq, tbank, ids,
                                 torch.from_numpy(prompts), 7, 13)
    np.testing.assert_array_equal(got.numpy(), want)
    kw = dict(max_batch=3, block_size=4, chunk=4)
    treqs = [tserve.Request(rid=i, prompt=prompts[i], steps=7,
                            adapter_id=int(ids[i])) for i in range(3)]
    jreqs = [jserve.Request(rid=i, prompt=prompts[i], steps=7,
                            adapter_id=int(ids[i])) for i in range(3)]
    tdone = tserve.serve_scheduled(tm, tq, treqs, bank=tbank, wait=False,
                                   **kw)
    jdone = jserve.serve_scheduled(jm, jq, jreqs, bank=jbank, wait=False,
                                   **kw)
    assert [r.tokens for r in tdone] == [r.tokens for r in jdone]
    np.testing.assert_array_equal(
        np.stack([r.tokens for r in tdone]), want[:, 6:])


def test_dispatch_routes_packed_weights(monkeypatch):
    """With the kernel routes taken (dispatch._use_kernel forced true; the
    wrappers run their plain versions on CPU tensors): no adapter -> #11,
    banked s == 1 -> #4, banked s > 1 -> #3, each counted in
    stats["quant"]; a single adapter over a packed base -> #9 under no grad
    (its training route is in ``tests/test_torch_quant_train.py``)."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.standard_normal((40, 24)) * 0.1).astype(
        np.float32))
    wq = tquant.quantize(w, 4, 32)
    x = torch.from_numpy(rng.standard_normal((2, 3, 40)).astype(np.float32))
    lora = {"a": torch.randn(2, 4, 40) * 0.05, "b": torch.randn(2, 24, 4)}
    plain = {"none": dispatch.lora_linear(x, wq),
             "s3": dispatch.lora_linear(x, wq, lora, 1.0),
             "s1": dispatch.lora_linear(x[:, :1], wq, lora, 1.0)}
    calls = []

    def spy(mod, name):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a: calls.append(name) or orig(*a))

    for mod, name in ((lora_matmul, "quant_matmul"),
                      (bgmv, "bgmv_matmul_quant"),
                      (bgmv, "bgmv_gemv_quant")):
        spy(mod, name)
    monkeypatch.setattr(dispatch, "_use_kernel", lambda t: True)
    dispatch.reset_stats()
    got = {"none": dispatch.lora_linear(x, wq),
           "s3": dispatch.lora_linear(x, wq, lora, 1.0),
           "s1": dispatch.lora_linear(x[:, :1], wq, lora, 1.0)}
    assert calls == ["quant_matmul", "bgmv_matmul_quant", "bgmv_gemv_quant"]
    assert dispatch.stats["quant"] == 3
    for key in plain:
        torch.testing.assert_close(got[key], plain[key], rtol=TOL, atol=TOL)
    torch.testing.assert_close(plain["none"], x @ wq.dequantize())
    single = {"a": lora["a"][0], "b": lora["b"][0]}
    spy(lora_matmul, "lora_fwd_quant")
    got1 = dispatch.lora_linear(x, wq, single, 1.0)
    assert calls[-1] == "lora_fwd_quant" and dispatch.stats["quant"] == 4
    torch.testing.assert_close(
        got1, x @ wq.dequantize() + (x @ single["a"].T) @ single["b"].T,
        rtol=TOL, atol=TOL)
