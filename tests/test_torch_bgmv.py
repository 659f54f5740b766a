"""repro_torch BGMV tier: the plain versions against the JAX package's Pallas
BGMV kernels (interpret mode), the dispatcher's device routing, and the
kernel wrappers' argument checks.  The CUDA kernels themselves run only on
the card: ``test_kernels_match_plain_on_card`` (marker ``cuda``) and
``chip_smoke.py`` hold them against the plain versions there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import bgmv as jbgmv                      # noqa: E402
from repro.kernels import dispatch as jdispatch              # noqa: E402
from repro_torch.kernels import bgmv, dispatch               # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)     # the JAX BGMV tests' own bound
NO_LAUNCHES = {"bgmv_matmul": 0, "bgmv_gemv": 0, "bgmv_matmul_quant": 0,
               "bgmv_gemv_quant": 0}


@pytest.fixture(autouse=True)
def _clean_counters():
    bgmv.reset_launches()
    dispatch.reset_stats()
    yield


def _operands(B, s, k, n, K, r, seed, ranks=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, s, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    a = (rng.standard_normal((K, r, k)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((K, n, r)) * 0.05).astype(np.float32)
    if ranks is not None:              # mixed-rank bank: zero-padded to r
        for t, rt in enumerate(ranks):
            a[t, rt:] = 0.0
            b[t, :, rt:] = 0.0
    ids = rng.integers(0, K, B).astype(np.int32)
    return x, w, a, b, ids


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


MATMUL_SHAPES = [
    (4, 8, 64, 64, 4, 8, None),        # block-divisible
    (5, 3, 70, 50, 3, 9, None),        # nothing divides
    (8, 1, 128, 96, 8, 16, None),      # decode shape through the matmul form
    (2, 6, 32, 256, 5, 4, None),       # n spans two TPU blocks
    (6, 4, 64, 64, 3, 16, (4, 16, 7)),  # mixed-rank bank
]
GEMV_SHAPES = [
    (4, 64, 64, 4, 8, None), (7, 70, 50, 3, 5, None),
    (8, 128, 300, 8, 16, None), (6, 64, 96, 3, 16, (4, 16, 7)),
]


@pytest.mark.parametrize("B,s,k,n,K,r,ranks", MATMUL_SHAPES)
def test_bgmv_matmul_plain_matches_jax_kernel(B, s, k, n, K, r, ranks):
    x, w, a, b, ids = _operands(B, s, k, n, K, r, seed=B + r, ranks=ranks)
    want = jbgmv.bgmv_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(a),
                             jnp.asarray(b), jnp.asarray(ids),
                             interpret=True)
    got = bgmv.bgmv_matmul(*_t(x, w, a, b, ids))
    assert got.dtype == torch.float32 and got.shape == (B, s, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert bgmv.launches == NO_LAUNCHES


@pytest.mark.parametrize("B,k,n,K,r,ranks", GEMV_SHAPES)
def test_bgmv_gemv_plain_matches_jax_kernel(B, k, n, K, r, ranks):
    x, w, a, b, ids = _operands(B, 1, k, n, K, r, seed=B, ranks=ranks)
    want = jbgmv.bgmv_gemv(jnp.asarray(x[:, 0]), jnp.asarray(w),
                           jnp.asarray(a), jnp.asarray(b), jnp.asarray(ids),
                           interpret=True)
    got = bgmv.bgmv_gemv(*_t(x[:, 0], w, a, b, ids))
    assert got.shape == (B, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert bgmv.launches == NO_LAUNCHES


def test_ids_none_is_the_identity_map():
    x, w, a, b, _ = _operands(4, 3, 32, 24, 4, 8, seed=1)
    ident = np.arange(4, dtype=np.int32)
    tx, tw, ta, tb, tids = _t(x, w, a, b, ident)
    torch.testing.assert_close(bgmv.bgmv_matmul(tx, tw, ta, tb),
                               bgmv.bgmv_matmul(tx, tw, ta, tb, tids),
                               rtol=0, atol=0)


# ------------------------------------------------------------------ dispatch

@pytest.mark.parametrize("s", [1, 5])
@pytest.mark.parametrize("lazy", [False, True])
def test_dispatch_cpu_takes_plain_and_matches_jax(s, lazy):
    x, w, a, b, ids = _operands(3, s, 48, 40, 5 if lazy else 3, 8, seed=s)
    jl = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    tl = {"a": torch.from_numpy(a), "b": torch.from_numpy(b)}
    if lazy:
        jl["ids"] = jnp.asarray(ids)
        tl["ids"] = torch.from_numpy(ids)
    want = jdispatch.lora_linear_batched(jnp.asarray(x), jnp.asarray(w), jl,
                                         2.0)
    got = dispatch.lora_linear_batched(torch.from_numpy(x),
                                       torch.from_numpy(w), tl, 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert dispatch.stats == {"bgmv": 0, "plain": 1, "lora_matmul": 0,
                              "quant": 0, "paged": 0}
    assert bgmv.launches == NO_LAUNCHES


def test_dispatch_single_adapter_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32)
    w = (rng.standard_normal((48, 40)) * 0.1).astype(np.float32)
    a = (rng.standard_normal((6, 48)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((40, 6)) * 0.1).astype(np.float32)
    want = jdispatch.lora_linear(jnp.asarray(x), jnp.asarray(w),
                                 {"a": jnp.asarray(a), "b": jnp.asarray(b)},
                                 1.5)
    got = dispatch.lora_linear(torch.from_numpy(x), torch.from_numpy(w),
                               {"a": torch.from_numpy(a),
                                "b": torch.from_numpy(b)}, 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert dispatch.lora_linear(torch.from_numpy(x),
                                torch.from_numpy(w)).shape == (2, 7, 40)


@pytest.mark.parametrize("xdt,wdt,want", [
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16, torch.float32),
])
def test_dispatch_output_dtype_is_result_type(xdt, wdt, want):
    x, w, a, b, _ = _operands(2, 3, 16, 8, 2, 4, seed=0)
    lora = {"a": torch.from_numpy(a).to(wdt), "b": torch.from_numpy(b).to(wdt)}
    y = dispatch.lora_linear_batched(torch.from_numpy(x).to(xdt),
                                     torch.from_numpy(w).to(wdt), lora)
    assert y.dtype == want
    assert bgmv.launches == NO_LAUNCHES


def test_dispatch_rejects_other_devices():
    x = torch.zeros(2, 1, 8, device="meta")
    lora = {"a": torch.zeros(2, 4, 8, device="meta"),
            "b": torch.zeros(2, 8, 4, device="meta")}
    with pytest.raises(ValueError, match="CUDA or CPU"):
        dispatch.lora_linear_batched(x, torch.zeros(8, 8, device="meta"),
                                     lora)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bgmv.bgmv_gemv(x[:, 0], torch.zeros(8, 8, device="meta"),
                       lora["a"], lora["b"])


def test_cuda_asked_without_cuda_raises():
    """Where there is no card, asking for one raises: no quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from repro_torch import resolve_device
    from repro_torch.checkpoint.io import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({"w": np.zeros(3, np.float32)})    # default: cuda
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(get_config("gemma-2b").reduced()).init_cache(2, 4)


def test_kernel_build_without_nvcc_raises(monkeypatch):
    from repro_torch.kernels import build
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(build, "library_path",
                        lambda: build.BUILD_DIR / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


# ------------------------------------------------------------ wrapper checks

def _good(dtype=torch.float32):
    x, w, a, b, ids = _operands(3, 1, 16, 8, 4, 4, seed=2)
    return [t.to(dtype) for t in _t(x[:, 0], w, a, b)] + [
        torch.from_numpy(ids)]


@pytest.mark.parametrize("breakage,err", [
    (lambda o: o.__setitem__(1, o[1].double()), TypeError),     # mixed dtype
    (lambda o: o.__setitem__(1, o[1].t().contiguous().t()), ValueError),
    (lambda o: o.__setitem__(3, o[3][:, :4]), ValueError),     # b shape
    (lambda o: o.__setitem__(4, o[4].long()), ValueError),     # ids dtype
    (lambda o: o.__setitem__(4, o[4] + 4), ValueError),        # id range
    (lambda o: o.__setitem__(4, o[4] - 9), ValueError),        # negative id
    (lambda o: o.__setitem__(4, None), ValueError),            # 3 rows, K=4
])
def test_wrapper_checks_reject_what_the_kernel_does_not_take(breakage, err):
    ops = _good()
    breakage(ops)
    x, w, a, b, ids = ops
    with pytest.raises(err):
        bgmv._check(x, w, a, b, ids, x.shape[0])


def test_wrapper_checks_accept_good_operands():
    x, w, a, b, ids = _good(torch.bfloat16)
    assert bgmv._check(x, w, a, b, ids.contiguous(), 3) == ids.data_ptr()


@pytest.mark.parametrize("nreq,k,n", [(4, 2048, 2048), (4, 2048, 256),
                                      (3, 70, 50), (20, 8, 1)])
def test_gemv_split_covers_k(nreq, k, n):
    ksplit, kchunk = bgmv.gemv_split(nreq, k, n, num_sms=132)
    assert ksplit >= 1 and ksplit * kchunk >= k > (ksplit - 1) * kchunk


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 3, 128])
def test_kernels_match_plain_on_card(s, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    dt = getattr(torch, dtype)
    for shape in [(4, 2048, 2048, 4, 8), (4, 70, 50, 3, 9)]:
        B, k, n, K, r = shape
        x, w, a, b, ids = _operands(B, s, k, n, K, r, seed=s)
        x, w, a, b, ids = (t.cuda() for t in _t(x, w, a, b, ids))
        x, w, a, b = (t.to(dt) for t in (x, w, a, b))
        if s == 1:
            got = bgmv.bgmv_gemv(x[:, 0].contiguous(), w, a, b, ids)
            want = bgmv.bgmv_gemv_plain(x[:, 0], w, a, b, ids)
        else:
            got = bgmv.bgmv_matmul(x, w, a, b, ids)
            want = bgmv.bgmv_matmul_plain(x, w, a, b, ids)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
