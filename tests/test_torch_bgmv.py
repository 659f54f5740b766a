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
from repro_torch.kernels import bgmv, common, dispatch       # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its small ops gain nothing
    from more, and the suite's parallel workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-5, atol=2e-5)     # the JAX BGMV tests' own bound
NO_LAUNCHES = {"bgmv_matmul": 0, "bgmv_gemv": 0, "bgmv_matmul_quant": 0,
               "bgmv_gemv_quant": 0}
SMS = 132                            # an H100's SMs, for the host plans


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
    """The dispatcher takes CUDA, the CPU and ``meta`` (shapes only: the
    dry-run's tier, the plain versions); any other device raises, and so
    does a kernel wrapper handed a meta tensor."""
    import types
    x = torch.zeros(2, 1, 8, device="meta")
    lora = {"a": torch.zeros(2, 4, 8, device="meta"),
            "b": torch.zeros(2, 8, 4, device="meta")}
    y = dispatch.lora_linear_batched(x, torch.zeros(8, 8, device="meta"),
                                     lora)
    assert y.device.type == "meta" and tuple(y.shape) == (2, 1, 8)
    assert bgmv.launches == NO_LAUNCHES
    with pytest.raises(ValueError, match="CUDA or CPU"):
        dispatch._use_kernel(types.SimpleNamespace(device=torch.device("xpu")))
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


# The decode GEMV's plan (common.gemv_plan), which #1 and #4 launch with:
# (nreq, k, n, bytes a column takes in a W row).  The paths' q and v over
# fp32, bf16 and packed W at m = 4, recurrentgemma-9b's q / wx / wy and v,
# odd n, k below a slab, and more rows of x than a block takes.
GEMV_PLAN_SHAPES = [(4, 2048, 2048, 4), (4, 2048, 256, 4),
                    (4, 2048, 2048, 2), (4, 2048, 256, 1),
                    (4, 2048, 2048, 1), (4, 4096, 4096, 4),
                    (4, 4096, 256, 4), (3, 70, 51, 4), (5, 99, 33, 1),
                    (2, 8, 40, 2), (1, 1, 1, 4), (11, 2048, 2048, 1),
                    (40, 4096, 256, 4)]


@pytest.mark.parametrize("nreq,k,n,col_bytes", GEMV_PLAN_SHAPES)
def test_gemv_plan_covers_k_from_the_shapes_alone(nreq, k, n, col_bytes):
    """Chunks of whole 16-row slabs, no longer than the rows of x a block
    stages, cover k exactly with none empty; the plan reads only the
    shapes and the SM count, and a bigger card never splits less."""
    import inspect
    assert list(inspect.signature(common.gemv_plan).parameters) == [
        "nreq", "k", "n", "col_bytes", "num_sms"]
    ksplit, kchunk = common.gemv_plan(nreq, k, n, col_bytes, SMS)
    assert (ksplit, kchunk) == common.gemv_plan(nreq, k, n, col_bytes, SMS)
    assert kchunk % 16 == 0 and kchunk <= common.QGEMV_MAX_CHUNK
    assert (ksplit - 1) * kchunk < k <= ksplit * kchunk
    assert common.gemv_plan(nreq, k, n, col_bytes, 2 * SMS)[0] >= ksplit


def test_gemv_plan_at_the_path_shapes():
    """On a 132-SM card at m = 4: gemma-2b's q and v 16 chunks of 128 rows
    (a dense format's narrower column blocks, 64 fp32 or 128 bf16 columns
    against 256 packed, leave that at the 128-row floor) except a packed v,
    one column block, 64 of 32; recurrentgemma-9b's q 8 of 512 (64 column
    blocks, two an SM)."""
    want = {(2048, 2048, 4): (16, 128), (2048, 2048, 2): (16, 128),
            (2048, 2048, 1): (16, 128), (2048, 256, 4): (16, 128),
            (2048, 256, 2): (16, 128), (2048, 256, 1): (64, 32),
            (4096, 4096, 4): (8, 512), (4096, 256, 4): (32, 128)}
    for (k, n, cb), plan in want.items():
        assert common.gemv_plan(4, k, n, cb, SMS) == plan


class _RecordingLib:
    """Stands in for the kernel library: records each entry point's
    arguments and returns 0 (no error)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


def _patch_launch(monkeypatch):
    """A recording kernel library on a 132-SM card, and a record of every
    tensor bgmv allocates (by data pointer)."""
    from repro_torch.kernels import build
    lib = _RecordingLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(bgmv, "route", lambda t, _name: True)
    monkeypatch.setattr(bgmv, "num_sms", lambda device: SMS)
    monkeypatch.setattr(bgmv, "stream", lambda t: None)
    made = {}
    real_empty = torch.empty

    def recording_empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made[t.data_ptr()] = t
        return t
    monkeypatch.setattr(bgmv.torch, "empty", recording_empty)
    return lib, made


GEMV_LAUNCH_SHAPES = [(4, 2048, 2048, 8), (4, 2048, 256, 8),
                      (11, 70, 50, 3), (1, 8, 33, 1)]


def _assert_gemv_buffers(made, args, nreq, n, r, ksplit, out):
    """p (ksplit, nreq, r), partial (ksplit, nreq, n) and the returned out
    (nreq, n), all fp32, at args' p, partial and out pointers."""
    p, partial, y = (made[a] for a in args)
    assert p.shape == (ksplit, nreq, r) and partial.shape == (ksplit, nreq, n)
    assert y is out and y.shape == (nreq, n)
    assert {t.dtype for t in (p, partial, y)} == {torch.float32}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nreq,k,n,r", GEMV_LAUNCH_SHAPES)
def test_bgmv_gemv_launches_with_its_plan_and_scratch(monkeypatch, nreq, k,
                                                      n, r, dtype):
    """#1 hands its entry point gemv_plan's split for its W's column width
    (ksplit, kchunk right after nreq, k, n, r), the rank and base partial
    scratches and the output; then counts one launch."""
    lib, made = _patch_launch(monkeypatch)
    x, w, a, b, ids = _operands(nreq, 1, k, n, 3, r, seed=nreq)
    x, w, a, b = (t.to(dtype) for t in _t(x[:, 0], w, a, b))
    out = bgmv.bgmv_gemv(x, w, a, b, torch.from_numpy(ids))
    (entry, args), = lib.calls
    assert entry == "bgmv_gemv_launch"
    plan = common.gemv_plan(nreq, k, n, 4 if dtype == torch.float32 else 2,
                            SMS)
    assert args[8:14] == (nreq, k, n, r, *plan)
    assert args[14] == common.DTYPES[dtype]
    _assert_gemv_buffers(made, args[5:8], nreq, n, r, plan[0], out)
    assert bgmv.launches == dict(NO_LAUNCHES, bgmv_gemv=1)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("nreq,k,n,r", GEMV_LAUNCH_SHAPES)
def test_bgmv_gemv_quant_launches_with_its_plan_and_scratch(monkeypatch,
                                                            nreq, k, n, r,
                                                            bits):
    """#4 hands its entry point gemv_plan's split for a packed W (one byte
    a column), the rank and base partial scratches, the output and the
    packing (bits, group, bf16 rounding); then counts one launch."""
    from repro_torch.core.quant import quantize
    lib, made = _patch_launch(monkeypatch)
    x, w, a, b, _ = _operands(nreq, 1, k, n, nreq, r, seed=nreq + bits)
    wq = quantize(torch.from_numpy(w), bits, 64)
    xt, at, bt = _t(x[:, 0], a, b)
    out = bgmv.bgmv_gemv_quant(xt, wq, at, bt)
    (entry, args), = lib.calls
    assert entry == "bgmv_gemv_quant_launch"
    plan = common.gemv_plan(nreq, k, n, 1, SMS)
    assert args[5] is None                     # ids=None: no pointer
    assert args[9:15] == (nreq, k, n, r, *plan)
    assert args[15:19] == (bits, 0 if bits == 8 else 64, 0, 0)
    _assert_gemv_buffers(made, args[6:9], nreq, n, r, plan[0], out)
    assert bgmv.launches == dict(NO_LAUNCHES, bgmv_gemv_quant=1)


# The rank-fused forward tile's split plan (common.fwd_split / fwd_plan),
# which #2, #3, #5 and #9 launch with: (m, n, k, r) of each pass.
PATH_SHAPES = [
    (512, 2048, 2048, 8),     # #2 gemma-2b q (4 x 128 prefill rows)
    (512, 256, 2048, 8),      # #2 gemma-2b v
    (512, 4096, 4096, 8),     # #2 recurrentgemma-9b q, wx, wy
    (512, 256, 4096, 8),      # #2 recurrentgemma-9b v
    (512, 2048, 2048, 64),    # #5 / #9 training q
    (512, 256, 2048, 64),     # #5 / #9 training v
]
SPLIT_SHAPES = PATH_SHAPES + [(50, 30, 70, 3), (33, 17, 65, 1),
                              (5000, 50, 12, 9), (1, 1, 1, 1),
                              (16896, 128, 300, 64)]


def _chunks(k, r, ksplit, kchunk):
    """[lo, hi) of each chunk over the pass's range: k padded to a slab,
    then r."""
    total = -(-k // 16) * 16 + r
    return [(z * kchunk, min(total, (z + 1) * kchunk)) for z in range(ksplit)]


@pytest.mark.parametrize("cols", [common.FWD_COLS, common.FWD_PRE_COLS])
@pytest.mark.parametrize("m,n,k,r", SPLIT_SHAPES)
def test_fwd_split_covers_the_range_in_whole_slabs(m, n, k, r, cols):
    ksplit, kchunk = common.fwd_split(m, n, k, r, cols, SMS)
    slabs = -(-k // 16) + -(-r // 16)
    assert ksplit >= 1 and kchunk % 16 == 0
    assert (ksplit - 1) * kchunk < slabs * 16 <= ksplit * kchunk
    assert all(lo < hi for lo, hi in _chunks(k, r, ksplit, kchunk))
    if ksplit > 1:
        assert kchunk >= common.FWD_MIN_SLABS * 16


@pytest.mark.parametrize("group", [16, 32, 64, 128])
@pytest.mark.parametrize("m,n,k,r", SPLIT_SHAPES)
def test_fwd_split_int4_slab_never_straddles_a_group(m, n, k, r, group):
    """Every 16-row slab of every chunk of the base range lies in one int4
    scale group, so the kernel loads one scale row per slab."""
    ksplit, kchunk = common.fwd_split(m, n, k, r, common.FWD_COLS, SMS, 4,
                                      group)
    for lo, hi in _chunks(k, r, ksplit, kchunk):
        for t in range(lo, min(hi, k), 16):
            assert t // group == (min(t + 16, k) - 1) // group


@pytest.mark.parametrize("group", [2, 4, 8])
def test_fwd_split_refuses_int4_groups_below_a_slab(group):
    with pytest.raises(AssertionError, match="slab"):
        common.fwd_split(512, 256, 2048, 8, common.FWD_COLS, SMS, 4, group)
    # the wrappers' plan sends such a W down the element path instead
    assert common.fwd_plan(512, 256, 2048, 8, SMS, 4, group) == \
        common.fwd_plan(512, 256, 2048, 8, SMS)


@pytest.mark.parametrize("m,n", [(16896, 128), (2048, 2048), (512, 33792),
                                 (4096, 4096)])
def test_fwd_split_is_one_when_the_tiles_fill_the_card(m, n):
    assert -(-m // 128) * -(-n // 128) >= SMS
    assert common.fwd_split(m, n, 2048, 64, common.FWD_COLS, SMS) == \
        (1, 2048 + 64)


@pytest.mark.parametrize("m,n,k,r", PATH_SHAPES)
def test_fwd_plan_fills_the_card_at_the_path_shapes(m, n, k, r):
    """Both passes put between 90% of the SMs and all of them to work, one
    block each."""
    ksplit_p, _, ksplit, _ = common.fwd_plan(m, n, k, r, SMS)
    for tiles, split in ((-(-m // 128) * -(-r // 64), ksplit_p),
                         (-(-m // 128) * -(-n // 128), ksplit)):
        assert 0.9 * SMS <= tiles * split <= SMS


@pytest.mark.parametrize("bits,group", [(0, 0), (8, 0), (4, 64), (4, 16)])
@pytest.mark.parametrize("m,n,k,r", PATH_SHAPES)
def test_fwd_plan_depends_only_on_shapes_and_sm_count(m, n, k, r, bits,
                                                      group):
    import inspect
    assert list(inspect.signature(common.fwd_plan).parameters) == [
        "m", "n", "k", "r", "num_sms", "bits", "group"]
    plan = common.fwd_plan(m, n, k, r, SMS, bits, group)
    assert plan == common.fwd_plan(m, n, k, r, SMS, bits, group)
    assert plan == (*common.fwd_split(m, r, 0, k, common.FWD_PRE_COLS, SMS),
                    *common.fwd_split(m, n, k, r, common.FWD_COLS, SMS))
    # a bigger card never splits less
    big = common.fwd_plan(m, n, k, r, 2 * SMS, bits, group)
    assert big[0] >= plan[0] and big[2] >= plan[2]


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
