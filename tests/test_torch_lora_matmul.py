"""repro_torch's fused LoRA matmul (kernels #5-#8 and the LoRAMatmul
Function) against the JAX package's Pallas kernels in interpret mode.

On the CPU each piece runs its plain PyTorch version, wired exactly as the
card wires the kernels.  Tolerances are the JAX package's own for the
fused tier (``tests/test_dispatch.py``): forward rtol 2e-5 / atol 2e-4,
gradients rtol = atol = 1e-4 -- fp32 on both sides, the sums taken in
another order.  The kernels themselves run only on the card:
``tests/test_torch_cuda.py`` (marker ``cuda``) and ``chip_smoke.py`` hold
them against their plain versions there."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import dispatch as jdispatch                # noqa: E402
from repro.kernels import lora_matmul as jlm                   # noqa: E402
from repro_torch.kernels import bgmv, common, dispatch         # noqa: E402
from repro_torch.kernels import lora_matmul                    # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its small ops gain nothing
    from more, and the suite's parallel workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FWD_TOL = dict(rtol=2e-5, atol=2e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
NO_LORA_LAUNCHES = {"lora_fwd": 0, "lora_bwd_dx": 0, "lora_bwd_da": 0,
                    "lora_bwd_db": 0, "lora_fwd_quant": 0,
                    "lora_bwd_dx_quant": 0, "quant_matmul": 0,
                    "quant_matmul_dx": 0}
NO_BGMV_LAUNCHES = {"bgmv_matmul": 0, "bgmv_gemv": 0, "bgmv_matmul_quant": 0,
                    "bgmv_gemv_quant": 0}


@pytest.fixture(autouse=True)
def _clean_counters():
    lora_matmul.reset_launches()
    bgmv.reset_launches()
    dispatch.reset_stats()
    yield
    # the launch tests below fake a launch; leave no count to a test of
    # another file that runs next in the same worker
    lora_matmul.reset_launches()
    bgmv.reset_launches()
    dispatch.reset_stats()


def _operands(m, k, n, r, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    a = (rng.standard_normal((r, k)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((n, r)) * 0.05).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, a, b, g


def _t(*arrs):
    return [torch.from_numpy(np.array(x)) for x in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ------------------------------------------- plain pieces vs Pallas kernels

@pytest.mark.parametrize("m,k,n,r", [(64, 64, 64, 8), (128, 128, 64, 4)])
def test_plain_pieces_match_pallas_kernels(m, k, n, r):
    """Each plain piece against the Pallas body it stands in for, run by its
    ``_*_call`` in interpret mode (block-divisible shapes, as those calls
    need)."""
    x, w, a, b, g = _operands(m, k, n, r, seed=1)
    gamma = 1.7
    kw = dict(bm=64, bn=64, bk=64, interpret=True)
    jx, jw, ja, jb, jg = map(jnp.asarray, (x, w, a, b, g))
    tx, tw, ta, tb, tg = _t(x, w, a, b, g)

    y_want, p_want = jlm._fwd_call(jx, jw, ja, jb, gamma, **kw)
    y, p = lora_matmul.lora_fwd_plain(tx, tw, ta, tb, gamma)
    _close(y, y_want, FWD_TOL)
    _close(p, p_want, FWD_TOL)
    y_scratch = jlm._fwd_call_scratch(jx, jw, ja, jb, gamma, **kw)
    _close(y, y_scratch, FWD_TOL)

    dx_want, q_want = jlm._bwd_dx_call(jg, jw, ja, jb, gamma, **kw)
    dx, q = lora_matmul.lora_bwd_dx_plain(tg, tw, ta, tb, gamma)
    _close(dx, dx_want, GRAD_TOL)
    _close(q, q_want, GRAD_TOL)

    da_want = jlm._bwd_da_call(q_want, jx, gamma, bm=64, bk=64,
                               interpret=True)
    _close(lora_matmul.lora_bwd_da_plain(q, tx, gamma), da_want, GRAD_TOL)
    db_want = jlm._bwd_db_call(jg, p_want, gamma, bm=64, bn=64,
                               interpret=True)
    _close(lora_matmul.lora_bwd_db_plain(tg, p, gamma), db_want, GRAD_TOL)


def _function_vs_jax(x, w, a, b, g, gamma, jax_fn):
    jx, jw, ja, jb, jg = map(jnp.asarray, (x, w, a, b, g))
    y_want, vjp = jax.vjp(lambda *t: jax_fn(*t, gamma), jx, jw, ja, jb)
    dx_want, _, da_want, db_want = vjp(jg)
    tx, tw, ta, tb, tg = _t(x, w, a, b, g)
    for t in (tx, ta, tb):
        t.requires_grad_(True)
    y = lora_matmul.LoRAMatmul.apply(tx, tw, ta, tb, gamma, False)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    y.backward(tg)
    _close(y, y_want, FWD_TOL)
    _close(tx.grad, dx_want, GRAD_TOL)
    _close(ta.grad, da_want, GRAD_TOL)
    _close(tb.grad, db_want, GRAD_TOL)


@pytest.mark.parametrize("m,k,n,r", [(64, 64, 64, 8), (128, 256, 128, 16)])
def test_function_matches_lora_matmul_vjp(m, k, n, r):
    _function_vs_jax(*_operands(m, k, n, r, seed=7), 2.0,
                     lambda *t: jlm.lora_matmul_vjp(*t, bm=64, bn=64, bk=64,
                                                    interpret=True))


@pytest.mark.parametrize("m,k,n,r", [(50, 70, 30, 3), (100, 300, 130, 5),
                                     (33, 65, 17, 1)])
def test_function_matches_jax_on_ragged_shapes(m, k, n, r):
    """Shapes no block divides (and rank 1): the JAX package pads them to
    block multiples (``fused_lora_apply``); the port pads nothing."""
    _function_vs_jax(*_operands(m, k, n, r, seed=3), 1.3,
                     lambda *t: jdispatch.fused_lora_apply(*t,
                                                           interpret=True))


def test_function_gradcheck_float64():
    rng = np.random.default_rng(11)
    x, w, a, b = (torch.from_numpy(rng.standard_normal(s))
                  for s in ((5, 7), (7, 6), (3, 7), (6, 3)))
    for t in (x, a, b):
        t.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x_, a_, b_: lora_matmul.LoRAMatmul.apply(x_, w, a_, b_, 0.7,
                                                        False),
        (x, a, b))


def test_function_refuses_a_trainable_base():
    x, w, a, b, _ = _t(*_operands(8, 16, 8, 2))
    w.requires_grad_(True)
    a.requires_grad_(True)
    with pytest.raises(ValueError, match="never computes dW"):
        lora_matmul.LoRAMatmul.apply(x, w, a, b, 1.0, False)


def test_function_returns_dx_only_where_needed():
    x, w, a, b, g = _t(*_operands(8, 16, 8, 2))
    a.requires_grad_(True)
    b.requires_grad_(True)
    y = lora_matmul.LoRAMatmul.apply(x, w, a, b, 1.0, False)
    da, db = torch.autograd.grad(y, (a, b), g)
    assert da.shape == a.shape and db.shape == b.shape
    assert x.grad is None


# --------------------------------------------------------------- dispatch

def test_single_adapter_goes_through_the_function():
    """A 2-D adapter takes the LoRA matmul route (a grad_fn of the Function,
    its counter moves) and never the BGMV one."""
    x, w, a, b, _ = _operands(14, 48, 40, 6, seed=5)
    tl = {"a": torch.from_numpy(a).requires_grad_(True),
          "b": torch.from_numpy(b).requires_grad_(True)}
    y = dispatch.lora_linear(torch.from_numpy(x).reshape(2, 7, 48),
                             torch.from_numpy(w), tl, 1.5)
    assert y.shape == (2, 7, 40)
    fn = y.grad_fn.next_functions[0][0]          # under the reshape
    assert "LoRAMatmul" in type(fn).__name__
    assert dispatch.stats == {"bgmv": 0, "plain": 0, "lora_matmul": 1,
                              "quant": 0, "paged": 0}
    assert bgmv.launches == NO_BGMV_LAUNCHES
    want = jdispatch.lora_linear(jnp.asarray(x), jnp.asarray(w),
                                 {"a": jnp.asarray(a), "b": jnp.asarray(b)},
                                 1.5)
    _close(y.reshape(14, 40), want, FWD_TOL)
    y.sum().backward()
    assert float(tl["a"].grad.abs().sum()) > 0
    assert float(tl["b"].grad.abs().sum()) > 0


def test_kernel_route_wires_the_four_pieces(monkeypatch):
    """With the kernel tier forced on CPU tensors (the rehearsal of the card
    run), the Function calls the four kernel wrappers once each per
    projection and backward, and a no-grad call runs the forward piece
    alone."""
    calls = dict.fromkeys(("lora_fwd", "lora_bwd_dx", "lora_bwd_da",
                           "lora_bwd_db"), 0)
    for name in calls:
        orig = getattr(lora_matmul, name)

        def counted(*args, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(*args)
        monkeypatch.setattr(lora_matmul, name, counted)
    monkeypatch.setattr(dispatch, "_use_kernel", lambda x: True)
    x, w, a, b, _ = _t(*_operands(6, 16, 12, 4, seed=2))
    lora = {"a": a.requires_grad_(True), "b": b}
    dispatch.lora_linear(x, w, lora, 1.0).sum().backward()
    assert calls == {"lora_fwd": 1, "lora_bwd_dx": 1, "lora_bwd_da": 1,
                     "lora_bwd_db": 1}
    with torch.no_grad():
        dispatch.lora_linear(x, w, lora, 1.0)
    assert calls["lora_fwd"] == 2 and calls["lora_bwd_dx"] == 1
    # CPU: no kernel
    assert lora_matmul.launches == NO_LORA_LAUNCHES


def test_plain_tier_on_cpu_launches_nothing():
    x, w, a, b, _ = _t(*_operands(6, 16, 12, 4, seed=2))
    with torch.no_grad():
        y = dispatch.lora_linear(x, w, {"a": a, "b": b}, 2.0)
    want, _ = lora_matmul.lora_fwd_plain(x, w, a, b, 2.0)
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    assert lora_matmul.launches == NO_LORA_LAUNCHES


def test_bgmv_refuses_operands_that_need_grad():
    """The BGMV kernels have no backward: on the card their wrappers raise
    under autograd instead of returning an output without a grad_fn."""
    t = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        common.forward_only("bgmv_matmul", torch.zeros(2), t)
    with torch.no_grad():
        common.forward_only("bgmv_matmul", torch.zeros(2), t)
    common.forward_only("bgmv_matmul", torch.zeros(2), t.detach())


# ------------------------------------------------------------ wrapper checks

@pytest.mark.parametrize("breakage,err", [
    (lambda o: o.__setitem__("w", o["w"].double()), TypeError),
    (lambda o: o.__setitem__("x", o["x"].t().contiguous().t()), ValueError),
    (lambda o: o.__setitem__("a", o["a"][:0]), ValueError),
    (lambda o: o.__setitem__("b", o["b"][None]), ValueError),
])
def test_wrapper_checks_reject_what_the_kernel_does_not_take(breakage, err):
    x, w, a, b, _ = _t(*_operands(6, 16, 12, 4))
    ops = {"x": x, "w": w, "a": a, "b": b}
    breakage(ops)
    with pytest.raises(err):
        lora_matmul._check("lora_fwd", ops)


def test_wrapper_checks_residuals_are_fp32():
    x, *_ = _t(*_operands(6, 16, 12, 4))
    with pytest.raises(TypeError, match="float32"):
        lora_matmul._check("lora_bwd_da", {"x": x.bfloat16()},
                           fp32={"q": torch.zeros(6, 4).bfloat16()})
    lora_matmul._check("lora_bwd_da", {"x": x.bfloat16()},
                       fp32={"q": torch.zeros(6, 4)})


# (m, ni, nj) of #7 / #8 and the (c, chunk) common.reduce_plan gives them on
# a 132-SM card
REDUCE_PLANS = [
    ((512, 64, 2048), (7, 80)),      # dA at gemma-2b's q or v: 32 tiles
    ((512, 2048, 64), (7, 80)),      # dB at q
    ((512, 256, 64), (16, 32)),      # dB at v: 4 tiles, 2 slabs a chunk
    ((50, 3, 70), (4, 16)),          # ragged: the last chunk is short
    ((10, 64, 64), (1, 16)),         # fewer rows than one slab
    ((4096, 2048, 2048), (1, 4096)),  # the tiles fill the SMs: no cluster
    ((4096, 64, 2048), (7, 592)),    # large m: 37 slabs a chunk
    ((4096, 256, 64), (16, 256)),
    ((5, 4, 128), (1, 16)),          # bench-4l's dA at r = 4, m < 16
    ((256, 512, 128), (8, 32)),      # bench-4l's dA at r = 512: 16 tiles
    ((256, 128, 512), (8, 32)),      # and its dB at q
    ((40, 64, 64), (3, 16)),         # 3 slabs: 3 chunks, none empty
    ((8192, 64, 6400), (2, 4096)),   # 100 tiles: clusters of 2
    ((8192, 64, 8448), (1, 8192)),   # 132 tiles: more than half the wave
]


@pytest.mark.parametrize("shape, want", REDUCE_PLANS)
def test_reduce_plan_covers_m_in_whole_slabs(shape, want):
    """#7 / #8 split their m loop into c <= 16 chunks of whole 16-row slabs,
    none of them empty, so that the 64 x 64 tiles times c stay within 1.75
    CTAs an SM (132 SMs here), and c = 1 once the tiles alone outnumber
    the SMs."""
    m, ni, nj = shape
    c, chunk = common.reduce_plan(m, ni, nj, 132)
    assert (c, chunk) == want
    assert chunk % 16 == 0 and 1 <= c <= 16
    assert (c - 1) * chunk < m <= c * chunk     # covers m, no chunk empty
    tiles = -(-ni // 64) * -(-nj // 64)
    assert tiles * 64 * 64 >= ni * nj           # the tiles cover the output
    assert tiles * c <= max(tiles, 231)         # one wave of 1.75 an SM
    if tiles > 132:
        assert c == 1


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


def _fwd_call(name, m, k, n, r):
    """(wrapper call, C entry point, (k, n, r), bits, group) of one of the
    four wrappers on the rank-fused forward tile."""
    from repro_torch.core.quant import quantize
    x, w, a, b, _ = _t(*_operands(m, k, n, r, seed=4))
    wq = quantize(w, 4, 64)
    bank_a, bank_b = a[None].repeat(4, 1, 1), b[None].repeat(4, 1, 1)
    x3 = x.reshape(4, m // 4, k)
    return {
        "lora_fwd": (lambda: lora_matmul.lora_fwd(x, w, a, b, 1.5),
                     "lora_fwd_launch", 0, 0),
        "lora_fwd_quant": (lambda: lora_matmul.lora_fwd_quant(x, wq, a, b,
                                                              1.5),
                           "lora_fwd_quant_launch", 4, 64),
        "bgmv_matmul": (lambda: bgmv.bgmv_matmul(x3, w, bank_a, bank_b),
                        "bgmv_matmul_launch", 0, 0),
        "bgmv_matmul_quant": (lambda: bgmv.bgmv_matmul_quant(x3, wq, bank_a,
                                                             bank_b),
                              "bgmv_matmul_quant_launch", 4, 64),
    }[name]


@pytest.mark.parametrize("m,k,n,r", [(512, 2048, 256, 64), (64, 2048, 512, 8),
                                     (40, 70, 30, 3)])
@pytest.mark.parametrize("name", ["lora_fwd", "lora_fwd_quant", "bgmv_matmul",
                                  "bgmv_matmul_quant"])
def test_fwd_wrappers_launch_with_the_plan_and_a_big_enough_scratch(
        monkeypatch, name, m, k, n, r):
    """#2, #3, #5 and #9 hand their entry point common.fwd_plan's split of
    these shapes on a 132-SM card (ksplit_p, kchunk_p, ksplit, kchunk, right
    after r) and a scratch that holds the larger split pass's partials (a
    null pointer when neither splits), then count one launch."""
    from repro_torch.kernels import build
    lib = _RecordingLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    scratch = {}
    real_scratch = common.fwd_scratch

    def recording_scratch(*args):
        scratch["t"] = real_scratch(*args)
        return scratch["t"]
    for mod in (lora_matmul, bgmv):
        monkeypatch.setattr(mod, "route", lambda t, _name: True)
        monkeypatch.setattr(mod, "num_sms", lambda device: 132)
        monkeypatch.setattr(mod, "stream", lambda t: None)
        monkeypatch.setattr(mod, "fwd_scratch", recording_scratch)
    call, entry, bits, group = _fwd_call(name, m, k, n, r)
    call()
    (got_entry, args), = lib.calls
    assert got_entry == entry
    plan = common.fwd_plan(m, n, k, r, 132, bits, group)
    ints = [a for a in args if type(a) is int]
    at = [i for i in range(len(ints) - 2) if ints[i:i + 3] == [k, n, r]][0]
    assert tuple(ints[at + 3:at + 7]) == plan
    ksplit_p, _, ksplit, _ = plan
    need = max(ksplit_p * m * r if ksplit_p > 1 else 0,
               ksplit * m * n if ksplit > 1 else 0)
    if need:
        assert scratch["t"].numel() >= need
        assert scratch["t"].data_ptr() in args
    else:
        assert scratch["t"] is None and None in args
    launches = (lora_matmul.launches if name.startswith("lora")
                else bgmv.launches)
    assert launches[name] == 1


@pytest.mark.parametrize("m,k,n,r", [(512, 2048, 2048, 64),
                                     (512, 2048, 256, 64),
                                     (256, 128, 128, 512), (50, 70, 30, 3),
                                     (10, 64, 64, 4)])
@pytest.mark.parametrize("name", ["lora_bwd_da", "lora_bwd_db"])
def test_grad_wrappers_launch_with_the_reduce_plan(monkeypatch, name, m, k,
                                                   n, r):
    """#7 and #8 hand their entry point the operands' and the output's
    pointers, the shapes and exactly common.reduce_plan's (c, chunk) on a
    132-SM card, then gamma, the dtype and the stream: no scratch pointer
    (the clusters reduce in shared memory).  One launch is counted, and the
    output is the (ni, nj) fp32 tensor the kernel was handed."""
    from repro_torch.kernels import build
    lib = _RecordingLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(lora_matmul, "route", lambda t, _name: True)
    monkeypatch.setattr(lora_matmul, "num_sms", lambda device: 132)
    monkeypatch.setattr(lora_matmul, "stream", lambda t: 7)
    x, _, _, _, g = _t(*_operands(m, k, n, r, seed=5))
    res = torch.zeros(m, r)
    if name == "lora_bwd_da":
        out = lora_matmul.lora_bwd_da(res, x, 1.5)
        ops, (ni, nj), shape = (res, x), (r, k), (m, k, r)
    else:
        out = lora_matmul.lora_bwd_db(g, res, 1.5)
        ops, (ni, nj), shape = (g, res), (n, r), (m, n, r)
    (entry, args), = lib.calls
    assert entry == name + "_launch"
    c, chunk = common.reduce_plan(m, ni, nj, 132)
    assert args == (ops[0].data_ptr(), ops[1].data_ptr(), out.data_ptr(),
                    *shape, c, chunk, 1.5, 0, 7)
    assert out.shape == (ni, nj) and out.dtype == torch.float32
    assert lora_matmul.launches == {**NO_LORA_LAUNCHES, name: 1}


# #12's (m, k, n) on the training path (m = 512: gemma-2b's k, o, w_up,
# w_down) and ragged ones, with its plan on a 132-SM card
DX_PLANS = {"k": ((512, 2048, 256), (2, 128)),
            "o": ((512, 2048, 2048), (2, 1024)),
            "w_up": ((512, 2048, 16384), (2, 8192)),
            "w_down": ((512, 16384, 2048), (1, 2048))}


@pytest.mark.parametrize("m,k,n", [shape for shape, _ in DX_PLANS.values()]
                         + [(50, 100, 30), (37, 70, 50), (300, 1000, 4100),
                            (4096, 2048, 2048)])
def test_dx_plan_covers_n_in_whole_slabs(m, k, n):
    """#12 contracts W's n in chunks of whole 16-element slabs that cover it
    exactly, each chunk nonempty; split only while the (m, k) output's
    128 x 128 tiles leave SMs idle, and then within one block per SM."""
    ksplit, kchunk = common.dx_plan(m, k, n, 132)
    assert kchunk % common.FWD_SLAB == 0
    assert (ksplit - 1) * kchunk < n <= ksplit * kchunk
    tiles = -(-m // common.FWD_ROWS) * -(-k // common.FWD_COLS)
    assert ksplit == 1 or tiles * ksplit <= 132


@pytest.mark.parametrize("proj", sorted(DX_PLANS))
def test_dx_plan_fills_the_card_on_the_training_path(proj):
    """At k, o and w_up the 64 output tiles split n 2 ways (128 blocks on
    132 SMs); w_down's 512 tiles already fill the card.  The plan is
    fwd_split's with the roles swapped and no rank term, whatever the
    packing: the int4 group rule concerns a contraction along k, and #12
    contracts along n."""
    (m, k, n), want = DX_PLANS[proj]
    assert common.dx_plan(m, k, n, 132) == want
    assert want == common.fwd_split(m, k, n, 0, common.FWD_COLS, 132)
    tiles = -(-m // common.FWD_ROWS) * -(-k // common.FWD_COLS)
    assert tiles * want[0] >= 128


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(512, 2048, 256), (512, 16384, 2048),
                                   (50, 100, 30)])
def test_quant_matmul_dx_launches_with_the_plan_and_scratch(monkeypatch, m,
                                                            k, n, bits):
    """#12 hands its entry point dx_plan's split on a 132-SM card (ksplit,
    kchunk right after m, k, n) and, when it splits, a scratch for the
    (ksplit, m, k) partials (a null pointer otherwise); then counts one
    launch."""
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import build
    lib = _RecordingLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(lora_matmul, "route", lambda t, _name: True)
    monkeypatch.setattr(lora_matmul, "num_sms", lambda device: 132)
    monkeypatch.setattr(lora_matmul, "stream", lambda t: None)
    made = {}
    real_empty = torch.empty

    def recording_empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made[t.data_ptr()] = t
        return t
    monkeypatch.setattr(lora_matmul.torch, "empty", recording_empty)
    _, w, _, _, g = _t(*_operands(m, k, n, 1, seed=5))
    wq = quantize(w, bits, 64)
    lora_matmul.quant_matmul_dx(g, wq)
    (entry, args), = lib.calls
    assert entry == "quant_matmul_dx_launch"
    ksplit, kchunk = common.dx_plan(m, k, n, 132)
    assert args[5:10] == (m, k, n, ksplit, kchunk)
    assert args[10:13] == (bits, 0 if bits == 8 else 64, 0)
    if ksplit > 1:
        assert made[args[3]].numel() >= ksplit * m * k
    else:
        assert args[3] is None
    assert lora_matmul.launches == dict(NO_LORA_LAUNCHES, quant_matmul_dx=1)


# #11's plans: the packed GEMV's k split (common.qgemv_split, m <= 8) and
# the forward tile's (common.qmm_plan, m > 8); (k, n) of gemma-2b's packed
# projections and ragged ones
QMM_SHAPES = [(2048, 256), (2048, 2048), (2048, 16384), (16384, 2048),
              (70, 51), (4096, 264), (1000, 4100), (100, 30), (16, 8),
              (100000, 64)]


@pytest.mark.parametrize("sms", [132, 8, 1000])
@pytest.mark.parametrize("k,n", QMM_SHAPES)
def test_qgemv_split_covers_k_in_whole_slabs(k, n, sms):
    """Chunks of whole 16-row slabs, no longer than the rows of x a block
    stages, cover k exactly with none empty; a power of two from
    QGEMV_MIN_CHUNK up, each SM given a block where that length allows."""
    ksplit, kchunk = common.qgemv_split(k, n, sms)
    assert kchunk % 16 == 0 and kchunk <= common.QGEMV_MAX_CHUNK
    assert (ksplit - 1) * kchunk < k <= ksplit * kchunk
    if kchunk < common.QGEMV_MIN_CHUNK:
        assert ksplit == 1 and kchunk == -(-k // 16) * 16
    else:
        assert kchunk & (kchunk - 1) == 0
    blocks = -(-n // common.QGEMV_COLS)
    if kchunk > common.QGEMV_MIN_CHUNK:
        assert blocks * ksplit >= sms


def test_qgemv_split_at_the_path_shapes():
    """On a 132-SM card: k and o 16 chunks of 128 rows (16 and 128 blocks),
    w_up and w_gate 4 of 512 (256 blocks), w_down 32 of 512 (256)."""
    want = {(2048, 256): (16, 128), (2048, 2048): (16, 128),
            (2048, 16384): (4, 512), (16384, 2048): (32, 512)}
    for (k, n), plan in want.items():
        assert common.qgemv_split(k, n, 132) == plan


@pytest.mark.parametrize("bits,group", [(8, 0), (4, 16), (4, 32), (4, 64),
                                        (4, 128), (4, 8), (4, 2)])
@pytest.mark.parametrize("m", [9, 512, 4096])
@pytest.mark.parametrize("k,n", QMM_SHAPES)
def test_qmm_plan_is_the_forward_main_pass_with_no_rank(m, k, n, bits,
                                                        group):
    """#11 at m > 8 splits k as fwd_plan's main pass with r = 0 does: whole
    slabs covering k exactly, each chunk nonempty, and for int4 with groups
    of a slab or more, no slab straddling two scale groups (groups below a
    slab take the element path, planned as unpacked)."""
    ksplit, kchunk = common.qmm_plan(m, n, k, 132, bits, group)
    assert kchunk % 16 == 0 and (ksplit - 1) * kchunk < k <= ksplit * kchunk
    packed = bits if bits != 4 or group % 16 == 0 else 0
    assert (ksplit, kchunk) == common.fwd_split(m, n, k, 0, common.FWD_COLS,
                                                132, packed, group)
    if bits == 4 and group >= 16:
        for z in range(ksplit):
            for t in range(z * kchunk, min(k, (z + 1) * kchunk), 16):
                assert t // group == (min(t + 16, k) - 1) // group
    tiles = -(-m // common.FWD_ROWS) * -(-n // common.FWD_COLS)
    assert ksplit == 1 or tiles * ksplit <= 132


@pytest.mark.parametrize("r", [1, 8, 64])
@pytest.mark.parametrize("m,k,n", [(512, 2048, 2048), (512, 2048, 256),
                                   (50, 100, 30), (37, 70, 50),
                                   (300, 1000, 4100)])
def test_dx_plan_with_rank_covers_the_range_in_whole_slabs(m, k, n, r):
    """#10's main pass contracts n padded to a slab, then the rank range:
    whole slabs that cover it exactly, none empty; its q pre-pass contracts
    n in whole slabs; dx_rank_plan is the two, and with r = 0 dx_plan is
    #12's plan unchanged."""
    ksplit, kchunk = common.dx_plan(m, k, n, 132, r)
    slabs = -(-n // 16) + -(-r // 16)
    assert kchunk % 16 == 0
    assert (ksplit - 1) * kchunk < slabs * 16 <= ksplit * kchunk
    ksplit_p, kchunk_p, *main = common.dx_rank_plan(m, k, n, r, 132)
    assert main == [ksplit, kchunk]
    assert kchunk_p % 16 == 0
    assert (ksplit_p - 1) * kchunk_p < -(-n // 16) * 16 <= ksplit_p * kchunk_p
    assert common.dx_plan(m, k, n, 132, 0) == common.dx_plan(m, k, n, 132)
    assert common.dx_plan(m, k, n, 132) == common.fwd_split(
        m, k, n, 0, common.FWD_COLS, 132)


def test_plans_ask_nothing_of_the_device(monkeypatch):
    """qgemv_split, qmm_plan, dx_plan and dx_rank_plan read the shapes and
    the SM count alone (so the wrappers stay capture-safe): with every
    device query refused they give the same plans."""
    before = (common.qgemv_split(2048, 16384, 132),
              common.qmm_plan(512, 16384, 2048, 132, 4, 64),
              common.dx_plan(512, 2048, 2048, 132, 64),
              common.dx_rank_plan(512, 2048, 256, 64, 132))

    def refuse(*a, **kw):
        raise AssertionError("a plan asked the device")
    for name in ("is_available", "current_device", "get_device_properties",
                 "device_count", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert before == (common.qgemv_split(2048, 16384, 132),
                      common.qmm_plan(512, 16384, 2048, 132, 4, 64),
                      common.dx_plan(512, 2048, 2048, 132, 64),
                      common.dx_rank_plan(512, 2048, 256, 64, 132))


def _patch_launch(monkeypatch):
    """A recording kernel library on a 132-SM card, and a record of every
    tensor lora_matmul allocates (by data pointer)."""
    from repro_torch.kernels import build
    lib = _RecordingLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(lora_matmul, "route", lambda t, _name: True)
    monkeypatch.setattr(lora_matmul, "num_sms", lambda device: 132)
    monkeypatch.setattr(lora_matmul, "stream", lambda t: None)
    made = {}
    real_empty = torch.empty

    def recording_empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made[t.data_ptr()] = t
        return t
    monkeypatch.setattr(lora_matmul.torch, "empty", recording_empty)
    return lib, made


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n", [(4, 2048, 16384), (1, 16384, 2048),
                                   (8, 70, 51), (9, 2048, 256),
                                   (512, 2048, 16384), (512, 16384, 2048)])
def test_quant_matmul_launches_with_its_plan_and_scratch(monkeypatch, m, k,
                                                         n, bits):
    """#11 hands its entry point qgemv_split's plan for m <= 8 rows and
    qmm_plan's above (ksplit, kchunk right after m, k, n) and, when the
    plan splits, a scratch for the (ksplit, m, n) partials (a null pointer
    otherwise); then counts one launch."""
    from repro_torch.core.quant import quantize
    lib, made = _patch_launch(monkeypatch)
    x, w, _, _, _ = _t(*_operands(m, k, n, 1, seed=6))
    wq = quantize(w, bits, 64)
    lora_matmul.quant_matmul(x, wq)
    (entry, args), = lib.calls
    assert entry == "quant_matmul_launch"
    group = 0 if bits == 8 else 64
    plan = (common.qgemv_split(k, n, 132) if m <= 8
            else common.qmm_plan(m, n, k, 132, bits, group))
    assert args[5:10] == (m, k, n, *plan)
    assert args[10:13] == (bits, group, 0)
    if plan[0] > 1:
        assert made[args[3]].numel() >= plan[0] * m * n
    else:
        assert args[3] is None
    assert lora_matmul.launches == dict(NO_LORA_LAUNCHES, quant_matmul=1)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m,k,n,r", [(512, 2048, 2048, 64),
                                     (512, 2048, 256, 64),
                                     (512, 2048, 256, 8), (50, 100, 30, 3)])
def test_lora_bwd_dx_quant_launches_with_its_plan_and_scratch(monkeypatch, m,
                                                              k, n, r, bits):
    """#10 hands its entry point dx_rank_plan's split (ksplit_p, kchunk_p,
    ksplit, kchunk right after m, k, n, r), a q buffer of (m, r) and a
    scratch that holds the larger split pass's partials (a null pointer
    when neither splits); then counts one launch."""
    from repro_torch.core.quant import quantize
    lib, made = _patch_launch(monkeypatch)
    _, w, a, b, g = _t(*_operands(m, k, n, r, seed=7))
    wq = quantize(w, bits, 64)
    lora_matmul.lora_bwd_dx_quant(g, wq, a, b, 1.5)
    (entry, args), = lib.calls
    assert entry == "lora_bwd_dx_quant_launch"
    plan = common.dx_rank_plan(m, k, n, r, 132)
    assert args[8:16] == (m, k, n, r, *plan)
    assert args[16] == 1.5 and args[17:20] == (bits, 0 if bits == 8 else 64,
                                               0)
    assert made[args[5]].shape == (m, r)
    ksplit_p, _, ksplit, _ = plan
    need = max(ksplit_p * m * r if ksplit_p > 1 else 0,
               ksplit * m * k if ksplit > 1 else 0)
    if need:
        assert made[args[6]].numel() >= need
    else:
        assert args[6] is None
    assert lora_matmul.launches == dict(NO_LORA_LAUNCHES,
                                        lora_bwd_dx_quant=1)


@pytest.mark.parametrize("m,k,n,r", [(512, 2048, 2048, 64),
                                     (512, 2048, 256, 64), (50, 70, 30, 3)])
def test_lora_bwd_dx_launches_with_its_plan_and_scratch(monkeypatch, m, k, n,
                                                        r):
    """#6 hands its entry point dx_rank_plan's split (ksplit_p, kchunk_p,
    ksplit, kchunk right after m, k, n, r), a q buffer of (m, r) and a
    scratch that holds the larger split pass's partials (a null pointer
    when neither splits), as #10 does over a packed W; then counts one
    launch."""
    lib, made = _patch_launch(monkeypatch)
    _, w, a, b, g = _t(*_operands(m, k, n, r, seed=8))
    lora_matmul.lora_bwd_dx(g, w, a, b, 1.5)
    (entry, args), = lib.calls
    assert entry == "lora_bwd_dx_launch"
    plan = common.dx_rank_plan(m, k, n, r, 132)
    assert args[7:15] == (m, k, n, r, *plan)
    assert args[15] == 1.5 and args[16] == 0
    assert made[args[4]].shape == (m, r) and made[args[6]].shape == (m, k)
    ksplit_p, _, ksplit, _ = plan
    need = max(ksplit_p * m * r if ksplit_p > 1 else 0,
               ksplit * m * k if ksplit > 1 else 0)
    if need:
        assert made[args[5]].numel() >= need
    else:
        assert args[5] is None
    assert lora_matmul.launches == dict(NO_LORA_LAUNCHES, lora_bwd_dx=1)
