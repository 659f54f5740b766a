"""Wrapper plumbing shared by the kernel modules (``bgmv``, ``lora_matmul``,
``paged_attention``, ``rglru_scan``, ``flash_attention``): the tier rule,
the dtype codes the C entry points take, the caller's stream, launch-error
reporting, the forward-only guard, and the host plans of the kernels that
split a contraction or a table over blocks, each from the shapes and the
SM count alone (so a wrapper asks nothing of the device and stays
capture-safe):

* ``qgemv_split`` and ``gemv_plan``: the k split of the decode GEMV
  (``csrc/qgemv.cu``) in #11's decode form and in #1 / #4;
* ``fwd_split`` / ``fwd_plan``: the splits of the rank-fused forward tile
  (``csrc/fwd_tile.cuh``) of #2, #3, #5 and #9, its pre-pass and main
  pass; ``qmm_plan``, its main pass with no rank term for #11 at m > 8;
  ``dx_plan`` and ``dx_rank_plan``, its passes with the roles swapped for
  #12 (no rank term) and #10 (the q pre-pass and the rank tail);
* ``reduce_plan``: the cluster split of the m loop of the LoRA gradient
  reductions #7 and #8 (``csrc/lora_grads.cu``);
* ``paged_split``: the split of paged attention's table (#13).

Nothing here builds or loads a kernel; ``kernels/build.py`` does that at
first use.
"""
from __future__ import annotations

import torch

# dtype codes of the C entry points: 0 = float32, 1 = bfloat16
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/fwd_tile.cuh: output rows per block, contraction rows per slab,
# output columns per block of the main pass and of the rank pre-pass
FWD_ROWS, FWD_SLAB, FWD_COLS, FWD_PRE_COLS = 128, 16, 128, 64
# the fewest slabs a chunk of a split contraction holds: shorter chunks
# spend more of their time filling the 3-stage ring than in it
FWD_MIN_SLABS = 4

# csrc/qgemv.cuh: the most rows of x a block of the decode GEMV takes (#11
# takes the forward tile beyond; #1 / #4 run groups of that many), the
# columns of a packed W a block covers (8 warps over 32 lanes x 8 bytes of
# a row; a dense row's column takes 2 or 4 of those bytes), and the bounds
# of a chunk of k: at least QGEMV_MIN_CHUNK rows, so that each of the
# block's 8 warps walks enough rows to keep its loads in flight; at most
# QGEMV_MAX_CHUNK (kQgMaxChunk), the rows of x a block stages in shared
# memory
QGEMV_MAX_ROWS, QGEMV_COLS = 8, 256
QGEMV_MIN_CHUNK, QGEMV_MAX_CHUNK = 128, 1024
# csrc/lora_grads.cu (#7, #8): output tile rows and columns, m rows per
# slab, the most CTAs in a cluster (16, the non-portable size: on an H100,
# clusters of 16 ran #8 at v 4.11 us against 4.82 at 8) and the CTAs per SM
# a plan aims at (1.75: clusters of 7 at gemma-2b's 32 tiles ran #7 / #8 at
# q in 8.2 us, of 8 in 9.1 and of 6 in 9.0; PERF.md)
REDUCE_TILE, REDUCE_SLAB = 64, 16
REDUCE_MAX_CLUSTER, REDUCE_CTAS_PER_SM = 16, 1.75
# #1 / #4 with a single column block (a packed W of n <= 256): chunks down
# to 32 rows, more blocks at the cost of a longer fixed-order pass
GEMV_NARROW_CHUNK = 32

_sm_counts = {}


def route(t, name: str) -> bool:
    """The tier rule.  True: a CUDA tensor, launch the kernel.  False: a
    CPU tensor, take the plain version.  Any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} takes CUDA or CPU tensors, got {t.device}")


def forward_only(name, *ts):
    """Forward-only kernels (BGMV, paged attention, the packed GEMM, the
    RG-LRU scan, flash attention): refuse operands autograd would need
    gradients for, rather than return an output without a grad_fn."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name}: the kernel has no backward, but an operand requires "
            "grad; run it under torch.no_grad() or torch.inference_mode(), "
            "or train a single adapter (the LoRA matmul Function)")


def stream(t):
    """The caller's current CUDA stream on ``t``'s device, as a handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    """``t``'s device pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def check_packed(wq, name: str):
    """Raise unless the packed W ``wq`` (a QuantizedLinear) has the byte
    layout the kernels read and dequantizes to fp32 or bf16; return
    ``(group, bf16w)``: the group size they index scales with (0 for int8)
    and the flag (1 or 0) that makes their loaders round each fp32 product
    ``float(q) * scale`` to bf16, as ``dequantize`` does for a base packed
    from bf16 weights (``csrc/loaders.cuh``)."""
    if wq.out_dtype not in ("float32", "bfloat16"):
        raise TypeError(
            f"{name}: the kernels take a base packed from float32 or "
            f"bfloat16 weights; this one dequantizes to {wq.out_dtype}")
    return (wq.check_layout(f"{name} W"),
            int(wq.out_dtype == "bfloat16"))


def _gemv_chunks(k: int, blocks: int, num_sms: int,
                 min_chunk: int = QGEMV_MIN_CHUNK):
    """(ksplit, kchunk): k split into the longest power-of-two chunks
    (``min_chunk`` to QGEMV_MAX_CHUNK rows) that still give every SM a
    block, ``blocks`` blocks a chunk, or one chunk of k rounded up to a
    16-row slab where k is shorter."""
    most = -(-k // -(-num_sms // blocks))   # the longest chunk filling the SMs
    chunk = min_chunk
    while chunk * 2 <= min(most, QGEMV_MAX_CHUNK):
        chunk *= 2
    chunk = min(chunk, -(-k // 16) * 16)
    return -(-k // chunk), chunk


def qgemv_split(k: int, n: int, num_sms: int):
    """(ksplit, kchunk) of #11's packed GEMV (m <= 8 rows of x, a packed W
    of logical shape (k, n)): blocks of QGEMV_COLS columns, k split by
    :func:`_gemv_chunks`.  A power of two divides k at the paths' shapes,
    so no chunk is a short tail; the chunks cover k exactly, none empty.
    ksplit 1 writes y directly, more go through the fixed-order sum of the
    partials.  On an H100 (132 SMs): gemma-2b's k and o 16 chunks of 128,
    w_up 4 of 512, w_down 32 of 512."""
    return _gemv_chunks(k, -(-n // QGEMV_COLS), num_sms)


def gemv_plan(nreq: int, k: int, n: int, col_bytes: int, num_sms: int):
    """(ksplit, kchunk) of #1 and #4 on the decode GEMV: nreq rows of x in
    groups of QGEMV_MAX_ROWS, a W of logical shape (k, n) whose columns take
    ``col_bytes`` bytes of a row (1 packed, int8 or int4; 2 bf16; 4 fp32),
    so blocks of QGEMV_COLS / col_bytes columns; k split by
    :func:`_gemv_chunks` over the blocks of all groups so that each SM gets
    two column blocks (one for #11's plan), where the chunks' length
    allows, and down to GEMV_NARROW_CHUNK rows where one column block is
    all there is.  From the shapes and the SM count alone, so the wrappers
    stay capture-safe.  The fixed-order pass that adds the chunks runs
    whatever ksplit is: it also adds the rank term.  On an H100 (132 SMs),
    m = 4: fp32 q (k = n = 2048) and v (n = 256) 16 chunks of 128 (32 and
    4 column blocks), recurrentgemma-9b's q (k = n = 4096) 8 of 512; packed
    q 16 of 128 (8 column blocks), packed v 64 of 32 (1).  Two blocks an SM
    ran recurrentgemma-9b's q 4 us faster than one; 32-row chunks ran the
    packed v 0.1-0.6 us faster than 128-row ones, fp32 v (4 column blocks)
    1.4 us slower (PERF.md)."""
    blocks = (-(-n // (QGEMV_COLS // col_bytes))
              * -(-nreq // QGEMV_MAX_ROWS))
    return _gemv_chunks(k, blocks, 2 * num_sms,
                        GEMV_NARROW_CHUNK if blocks == 1 else QGEMV_MIN_CHUNK)


def fwd_split(m: int, n: int, k: int, r: int, cols: int, num_sms: int,
              bits: int = 0, group: int = 0,
              min_slabs: int = FWD_MIN_SLABS):
    """(ksplit, kchunk) of one pass of the rank-fused forward tile: an
    (m, n) output in (FWD_ROWS, cols) tiles, contracting its base range
    [0, k) and then its rank range [0, r), laid end to end as whole slabs
    (the base padded to a slab).  Grid z takes the chunk [z kchunk, (z + 1)
    kchunk) of that range.  When the tiles leave SMs idle, the range splits
    into as many chunks as keep one block per SM (tiles x ksplit <=
    num_sms), of at least ``min_slabs`` slabs each; otherwise ksplit is 1.
    A packed int4 W (``bits`` 4) must hold whole slabs in each scale group,
    so that no slab of any chunk straddles two groups: a chunk starts on a
    slab, and a slab on a group's slab boundary."""
    if bits == 4:
        assert group % FWD_SLAB == 0, (
            f"fwd_split: int4 groups of {group} rows split a {FWD_SLAB}-row "
            "slab (the vector path needs groups of whole slabs)")
    tiles = -(-m // FWD_ROWS) * -(-n // cols)
    slabs = -(-k // FWD_SLAB) + -(-r // FWD_SLAB)
    chunk = slabs
    if tiles < num_sms:
        chunk = max(min_slabs, -(-slabs // (num_sms // tiles)))
    return -(-slabs // chunk), chunk * FWD_SLAB


def fwd_plan(m: int, n: int, k: int, r: int, num_sms: int, bits: int = 0,
             group: int = 0):
    """(ksplit_p, kchunk_p, ksplit, kchunk): the splits of the rank
    pre-pass (p = x A^T, (m, r) in (FWD_ROWS, FWD_PRE_COLS) tiles,
    contracting k) and of the main pass (out, (m, n) in (FWD_ROWS,
    FWD_COLS) tiles, contracting k then r), from the shapes and the SM count
    alone, so that a wrapper asks nothing of the device and stays
    capture-safe.  An int4 W with groups below a slab takes the kernels'
    element path, which reads each row's own scale, so only larger groups
    are held to whole slabs per group."""
    if bits == 4 and group % FWD_SLAB:
        bits = 0
    return (*fwd_split(m, r, 0, k, FWD_PRE_COLS, num_sms),
            *fwd_split(m, n, k, r, FWD_COLS, num_sms, bits, group))


def qmm_plan(m: int, n: int, k: int, num_sms: int, bits: int,
             group: int):
    """(ksplit, kchunk) of #11 at m > 8 rows, y = x dequant(W) on the
    rank-fused forward tile with no rank term: fwd_plan's main pass with r
    = 0, an (m, n) output in (FWD_ROWS, FWD_COLS) tiles contracting k, W
    read by column.  So fwd_split's int4 rule holds (no slab straddles a
    scale group), except for groups below a slab, which take the element
    path (each row's own scale)."""
    if bits == 4 and group % FWD_SLAB:
        bits = 0
    return fwd_split(m, n, k, 0, FWD_COLS, num_sms, bits, group)


def dx_plan(m: int, k: int, n: int, num_sms: int, r: int = 0):
    """(ksplit, kchunk) of the main pass of a packed dx on the rank-fused
    forward tile, for a packed W of logical shape (k, n): :func:`fwd_split`
    with the roles swapped, an (m, k) output in (FWD_ROWS, FWD_COLS) tiles
    contracting W's n, then (#10) the rank range [0, r) of q against gamma
    A, laid after n padded to a slab.  r = 0 is #12, dx = g dequant(W)^T.
    fwd_split's int4 rule (no slab straddles a scale group) concerns a
    contraction along k; here the contraction runs along n, whose scales
    change with every element, so it does not apply.  The tile's output
    columns straddle k's groups instead, and the by-row stager
    (``csrc/fwd_tile.cuh`` RowsInt4) reads each column's own scale row."""
    return fwd_split(m, k, n, r, FWD_COLS, num_sms)


def dx_rank_plan(m: int, k: int, n: int, r: int, num_sms: int):
    """(ksplit_p, kchunk_p, ksplit, kchunk) of #10, dx = g dequant(W)^T +
    gamma (g B) A: the q = g B pre-pass, an (m, r) output in (FWD_ROWS,
    FWD_PRE_COLS) tiles contracting n, then :func:`dx_plan`'s main pass
    with r (the order of ``fwd_plan``).  The pre-pass takes chunks down to
    one slab: its 4 tiles at m = 512 contract n = 256 at v, 16 slabs that
    4-slab chunks would spread over 16 of the SMs (on an H100 the 1-slab
    split ran #10 at v 2.4-2.7 us faster than the 4-slab one, PERF.md)."""
    return (*fwd_split(m, r, 0, n, FWD_PRE_COLS, num_sms, min_slabs=1),
            *dx_plan(m, k, n, num_sms, r))


def reduce_plan(m: int, ni: int, nj: int, num_sms: int):
    """(c, chunk) of #7 / #8, out (ni, nj) = gamma sum over m of L^T R: the
    m loop in c chunks of ``chunk`` rows (whole REDUCE_SLAB slabs), one CTA
    per (REDUCE_TILE x REDUCE_TILE output tile, chunk), the c CTAs of a
    tile one thread-block cluster that adds their partials in distributed
    shared memory.  c is the most, up to REDUCE_MAX_CLUSTER, that keeps
    tiles x c within REDUCE_CTAS_PER_SM CTAs an SM, and no larger than m's
    slabs allow; then the slabs are dealt out evenly, so no chunk is empty.
    c = 1 (no cluster) once the tiles alone outnumber half that wave.  From
    the shapes and the SM count alone, so the wrappers stay capture-safe.
    On an H100 (132 SMs) at m = 512: dA (64 x 2048, 32 tiles) and dB at q
    (2048 x 64) 7 chunks of 80 rows, dB at v (256 x 64, 4 tiles) 16 of
    32."""
    tiles = -(-ni // REDUCE_TILE) * -(-nj // REDUCE_TILE)
    slabs = -(-m // REDUCE_SLAB)
    want = int(REDUCE_CTAS_PER_SM * num_sms) // tiles
    c = max(1, min(REDUCE_MAX_CLUSTER, want, slabs))
    per = -(-slabs // c)
    return -(-slabs // per), per * REDUCE_SLAB


def paged_split(b: int, kh: int, mb: int, num_sms: int):
    """(nsplit, cols) of paged attention (#13): its grid is (request, kv
    head, chunk), chunk z taking table columns [z cols, (z + 1) cols).  The
    most chunks that keep b kh nsplit blocks within one wave of the SMs,
    at least one column each: nsplit = 1 once b kh fills the card.  From
    the shapes and the SM count alone, so the wrapper asks nothing of the
    device and stays capture-safe; every chunk is nonempty and together
    they cover the mb columns exactly."""
    want = max(1, min(mb, num_sms // (b * kh)))
    cols = -(-mb // want)
    return -(-mb // cols), cols


def fwd_scratch(m: int, n: int, r: int, plan, device):
    """The partial-sum scratch the rank-fused forward tile's split passes
    share (they run one after the other), or None when neither splits."""
    ksplit_p, _, ksplit, _ = plan
    numel = max(ksplit_p * m * r if ksplit_p > 1 else 0,
                ksplit * m * n if ksplit > 1 else 0)
    if not numel:
        return None
    return torch.empty(numel, dtype=torch.float32, device=device)


def num_sms(device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]
