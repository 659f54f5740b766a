"""repro_torch's public kernel API (``kernels/ops.py``) and the plain
versions of kernels #14 (flash attention) and #15 (RG-LRU scan) against the
JAX package on the CPU.

Inputs are drawn with numpy and handed to both packages.  The JAX Pallas
kernels run in interpret mode, as ``tests/test_kernels.py`` runs them; the
port's wrappers take their plain versions on CPU tensors.  Tolerances are
those of ``tests/test_kernels.py``: flash attention 2e-5 (fp32) / 3e-2
(bf16) relative, with an absolute floor five times that; the scan 1e-5 /
4e-2; the fused LoRA matmul 2e-5 relative, 2e-4 absolute.  fp32 throughout
except the bf16 cases; the two frameworks sum in different orders, and the
JAX model's associative scan in a tree order, so only rounding differs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ops as jops                           # noqa: E402
from repro.kernels import ref                                   # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402,E501
from repro.kernels.rglru_scan import rglru_scan_pallas          # noqa: E402
from repro.models import rglru as jrglru                        # noqa: E402
from repro_torch.kernels import flash_attention as tflash       # noqa: E402
from repro_torch.kernels import lora_matmul as tlm              # noqa: E402
from repro_torch.kernels import ops as tops                     # noqa: E402
from repro_torch.kernels import rglru_scan as tscan             # noqa: E402
from repro_torch.models import rglru as trglru                  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its small ops gain nothing
    from more, and the suite's parallel workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(arr, dtype):
    """The same numpy values as a JAX array and a torch tensor of
    ``dtype`` (both round fp32 to bf16 to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    arr = arr.astype(np.float32)
    return jnp.asarray(arr).astype(jdt), torch.from_numpy(arr).to(tdt)


def _close(got, want, tol, atol=None):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol * 5 if atol is None else atol)


def _scan_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 0.999, shape),
            rng.standard_normal(shape) * 0.5)


# ------------------------------------------------------------- #15 scan

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bt,s,d,bs", [(2, 64, 32, 16), (4, 128, 128, 128),
                                       (1, 256, 64, 64)])
def test_rglru_scan_plain_matches_pallas_and_ref(bt, s, d, bs, dtype):
    a_np, b_np = _scan_inputs((bt, s, d), s * 3 + d)
    ja, ta = _pair(a_np, dtype)
    jb, tb = _pair(b_np, dtype)
    tscan.reset_launches()
    got = tscan.rglru_scan(ta, tb)
    assert tscan.launches["rglru_scan"] == 0          # CPU: the plain version
    assert got.dtype == ta.dtype and got.shape == ta.shape
    tol = 1e-5 if dtype == "float32" else 4e-2
    _close(got, rglru_scan_pallas(ja, jb, block_seq=bs, interpret=True), tol)
    _close(got, ref.rglru_scan_ref(ja, jb), tol)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_model_associative_scan(with_h0):
    """The port's model scan (kernel #15 behind it) against the JAX model's
    ``jax.lax.associative_scan``, with and without an initial state."""
    a_np, b_np = _scan_inputs((2, 64, 32), 5)
    h0 = (np.random.default_rng(6).standard_normal((2, 32)).astype(
        np.float32) if with_h0 else None)
    want = jrglru.rglru_scan(jnp.asarray(a_np, jnp.float32),
                             jnp.asarray(b_np, jnp.float32),
                             None if h0 is None else jnp.asarray(h0))
    tb = torch.from_numpy(b_np.astype(np.float32))
    got = trglru.rglru_scan(torch.from_numpy(a_np.astype(np.float32)), tb,
                            None if h0 is None else torch.from_numpy(h0))
    _close(got, want, 1e-5, atol=1e-5)
    # h0 folds into a new tensor: the caller's b is not touched
    np.testing.assert_array_equal(tb.numpy(), b_np.astype(np.float32))


def test_rglru_scan_op_matches_jax_op():
    a_np, b_np = _scan_inputs((2, 64, 32), 7)
    ja, ta = _pair(a_np, "float32")
    jb, tb = _pair(b_np, "float32")
    _close(tops.rglru_scan_op(ta, tb), jops.rglru_scan_op(ja, jb), 1e-5,
           atol=1e-5)


@pytest.mark.parametrize("s", [100, 256])
def test_rglru_scan_op_keeps_jax_shape_contract(s):
    """The JAX kernel tiles s in blocks of min(128, s): s = 100 is one
    block, s = 256 two; 200 is refused by both."""
    a_np, b_np = _scan_inputs((1, s, 8), 8)
    ja, ta = _pair(a_np, "float32")
    jb, tb = _pair(b_np, "float32")
    _close(tops.rglru_scan_op(ta, tb), jops.rglru_scan_op(ja, jb), 1e-5)
    a2, b2 = _scan_inputs((1, 200, 8), 9)
    with pytest.raises(AssertionError):
        jops.rglru_scan_op(*(_pair(x, "float32")[0] for x in (a2, b2)))
    with pytest.raises(ValueError, match="multiple"):
        tops.rglru_scan_op(*(_pair(x, "float32")[1] for x in (a2, b2)))


# ---------------------------------------------------- #14 flash attention

def _qkv(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,t,d,causal,window", [
    (256, 256, 64, True, None),
    (256, 256, 128, False, None),
    (512, 512, 64, True, 128),    # sliding window
    (128, 512, 64, False, None),  # cross-attention shape
])
def test_flash_attention_plain_matches_pallas_and_ref(s, t, d, causal,
                                                      window, dtype):
    bh = 4
    q, k, v = _qkv([(bh, s, d), (bh, t, d), (bh, t, d)], s + d)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    tflash.reset_launches()
    got = tflash.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert tflash.launches["flash_attention"] == 0    # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-5 if dtype == "float32" else 3e-2
    _close(got, jflash(jq, jk, jv, causal=causal, window=window, bq=128,
                       bk=128, interpret=True), tol)
    _close(got, ref.flash_attention_ref(jq[:, :, None], jk[:, :, None],
                                        jv[:, :, None], causal=causal,
                                        window=window)[:, :, 0], tol)


def test_flash_attention_rows_without_keys_are_zero():
    """Non-causal with a window and t < s: rows past t + window - 1 keep no
    score.  The Pallas kernel's rules give them 0, and so does the port
    (the softmax oracle would give the uniform average)."""
    q, k, v = _qkv([(2, 256, 32), (2, 128, 32), (2, 128, 32)], 3)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, "float32") for x in (q, k, v))
    got = tflash.flash_attention(tq, tk, tv, causal=False, window=64)
    want = jflash(jq, jk, jv, causal=False, window=64, bq=128, bk=128,
                  interpret=True)
    _close(got, want, 2e-5)
    assert not got[:, 128 + 64:].any() and got[:, :128].abs().sum() > 0


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
def test_flash_mha_gqa_matches_jax(causal, window):
    """(b, s, h, d) heads with kh = 2 kv heads: the port folds heads and
    reads kv head i // 4 for query head i instead of repeating K / V."""
    b, s, h, kh, d = 2, 256, 8, 2, 64
    q, k, v = _qkv([(b, s, h, d), (b, s, kh, d), (b, s, kh, d)], 9)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, "float32") for x in (q, k, v))
    got = tops.flash_mha(tq, tk, tv, causal=causal, window=window)
    assert got.shape == (b, s, h, d)
    _close(got, jops.flash_mha(jq, jk, jv, causal=causal, window=window),
           2e-5, atol=1e-4)
    want = ref.flash_attention_ref(jq, jnp.repeat(jk, h // kh, axis=2),
                                   jnp.repeat(jv, h // kh, axis=2),
                                   causal=causal, window=window)
    _close(got, want, 2e-5, atol=1e-4)


@pytest.mark.parametrize("s,t", [(600, 600), (512, 700), (1000, 1024)])
def test_flash_shape_contract_matches_jax(s, t):
    """Lengths the JAX kernel's min(512, n) blocks do not tile: it asserts,
    the port raises ValueError, on every device."""
    q, k, v = _qkv([(1, s, 1, 16), (1, t, 1, 16), (1, t, 1, 16)], 10)
    with pytest.raises(AssertionError):
        jops.flash_mha(*(_pair(x, "float32")[0] for x in (q, k, v)))
    with pytest.raises(ValueError, match="multiples of 512"):
        tops.flash_mha(*(_pair(x, "float32")[1] for x in (q, k, v)))


def test_flash_mha_rejects_bad_heads():
    q, k, v = _qkv([(1, 8, 6, 16), (1, 8, 4, 16), (1, 8, 4, 16)], 11)
    with pytest.raises(ValueError, match="kh dividing h"):
        tops.flash_mha(*(torch.from_numpy(x) for x in (q, k, v)))


# ----------------------------------------------- #5 via fused_lora_matmul

@pytest.mark.parametrize("lead", [(), (4,), (2, 4)])
def test_fused_lora_matmul_matches_jax(lead):
    rng = np.random.default_rng(12)
    x = rng.standard_normal(lead + (128, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 256 ** -0.5).astype(np.float32)
    a = (rng.standard_normal((16, 256)) * 0.02).astype(np.float32)
    b = (rng.standard_normal((128, 16)) * 0.02).astype(np.float32)
    want = jops.fused_lora_matmul(*(jnp.asarray(t) for t in (x, w, a, b)),
                                  2.0)
    tlm.reset_launches()
    got = tops.fused_lora_matmul(*(torch.from_numpy(t) for t in (x, w, a, b)),
                                 2.0)
    assert got.shape == lead + (128, 128) and got.dtype == torch.float32
    assert not any(tlm.launches.values())             # CPU: plain versions
    _close(got, want, 2e-5, atol=2e-4)
