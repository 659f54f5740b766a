#!/usr/bin/env python3
"""A/B device times of the kernels of src/repro_torch/kernels/csrc/ (the
forward tile's forms in bgmv.cu, lora_matmul.cu, dense_dx.cu and
packed_dx.cu, the packed GEMV, paged and flash attention) across
checkouts, on one NVIDIA card.

    python3 ab_tiles.py [--only NAME[,NAME...]] DIR [DIR ...]

Each DIR is the root of a checkout (for example a ``git archive`` of the
parent commit unpacked under the gitignored ``build/``).  For each DIR in
the order given, a fresh process builds that checkout's kernels into its own
``build/kernels/`` and times, with its own ``chip_smoke._graph_ms`` (CUDA
graph replay), fp32 activations:

  #2, #3 bgmv_matmul / bgmv_matmul_quant at the serving prefill (B = 4
         requests of s = 128 rows, r = 8, adapters gathered per request):
         gemma-2b's q (k = n = 2048) and v (n = 256); #2 also at
         recurrentgemma-9b's q / wx / wy (k = n = 4096) and v (k = 4096,
         n = 256); #3 over int4 (group 64) and int8;
  #1, #4 bgmv_gemv / bgmv_gemv_quant at the same shapes in decode (B = 4
         rows of x, r = 8, adapters gathered): #1 at both models' q and v,
         #4 at gemma-2b's over int4 (group 64) and int8;
  #5-#8  lora_fwd / lora_bwd_dx / lora_bwd_da / lora_bwd_db at the
         training path's q (m = 512, k = 2048, n = 2048, r = 64) and v
         (n = 256); #7 / #8 on warm inputs, as chip_smoke.time_lora_kernels
         does, beside one torch.matmul each (``... matmul`` rows, the same
         on every tree);
  #11    quant_matmul at int4 (group 64) and int8, k, o, w_up and w_down,
         at m = 512 (the forward tile) and m = 4 (the packed GEMV);
  #9, #10 lora_fwd_quant / lora_bwd_dx_quant at q and v, int4 and int8;
  #12    quant_matmul_dx at k, o, w_up and w_down, int4 and int8;
  #13    paged_attention over fp32 and bf16 pools at (a) the gemma-2b
         scheduled path (B 4, h 8, kh 1, hd 256, block 16, 10 table
         columns), (b) the hybrid's (h 16, window 2048) and (c) a long
         context (h 16, 128 columns, window 2048), chip_smoke._paged_case's
         staggered fills; beside each, SDPA on the gathered view (one
         library call, the yardstick; the same on every checkout);
  #14    flash_attention at chip_smoke.FLASH_SHAPES' recurrentgemma-9b
         (s = t = 4096, 16 heads on one kv head, d 256, causal, window
         2048) and gemma-2b (s = t = 2048, 8 heads, causal), fp32, beside
         SDPA on the expanded heads (``... sdpa`` rows), as
         chip_smoke.time_scan_flash times them.

W (fp or packed) is rotated over copies that exceed L2 three times, as a
pass finds it cold.  Each kernel's output is also held against its plain
version (max abs diff), so a faster build that computes something else
shows.  For #1-#13 (SPLIT_KERNELS, matched by the row's kernel name
exactly) the graph is replayed once more under torch.profiler, and each
call's device time is split by kernel into the rank pre-pass, the main
kernel ("tile", or the decode GEMV of #1, #4 and #11, "gemv") and the
second pass that adds split partials (with #1 / #4's rank term) or merges
split softmaxes (``split_us``; each phase the time that an earlier phase's
kernels do not already cover, since #1 / #4's pass starts while their
GEMV runs).  #7 / #8 are one kernel since their m split is reduced in a
cluster: all of a call is "tile".  The compiler's registers and spills of
those kernels (``-Xptxas -v``, from the build log) come with each run
(``ptxas``).
``--only`` keeps the rows whose name starts with one of the given
prefixes.  Give the checkouts as A B B A to cancel drift; one JSON line per
run.
"""
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path

# the wrappers whose calls a run splits by phase: #1-#13 (a row's first
# word, matched exactly: quant_matmul is a prefix of quant_matmul_dx)
SPLIT_KERNELS = ("bgmv_gemv", "bgmv_gemv_quant", "bgmv_matmul",
                 "bgmv_matmul_quant", "lora_fwd", "lora_bwd_dx",
                 "lora_bwd_da", "lora_bwd_db", "lora_fwd_quant",
                 "lora_bwd_dx_quant", "quant_matmul", "quant_matmul_dx",
                 "paged_attention")
# the kernels whose registers and spills a run reports (mangled names;
# gemv_kernel is the decode GEMV, qgemv_kernel on checkouts before it took
# #1 and #4; lora_grad_kernel is #7 / #8, tile_kernel on checkouts before
# it)
PTXAS_KERNELS = ("paged_attn", "paged_split", "paged_merge", "fwd_kernel",
                 "tile_kernel", "lora_grad_kernel", "gemv_kernel",
                 "bgmv_pass_kernel", "flash_kernel")


def _phase(kernel_name: str) -> str:
    """The phase of a call a device kernel belongs to (also by the names of
    older checkouts: shrink_kernel, gemv_partial_kernel and finalize_kernel
    were #1 / #4's three kernels, tile_kernel and sum_partials_kernel #7 /
    #8's two)."""
    if ("shrink" in kernel_name or "xat" in kernel_name
            or "fwd_kernel<64" in kernel_name):
        return "pre-pass"
    if ("sum" in kernel_name or "merge" in kernel_name
            or "bgmv_pass" in kernel_name or "finalize" in kernel_name):
        return "second pass"
    if "gemv" in kernel_name:
        return "gemv"
    return "tile"


def _split_us(fn, argsets):
    """Device us per call by phase: the calls captured in a CUDA graph,
    replayed once under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for args in argsets:
            fn(*args)
    g.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(_phase(e.name), []).append(
                (e.time_range.start, e.time_range.end))
    # each phase's time not already covered by an earlier one: #1 / #4's
    # pass is launched while their GEMV runs and waits for it
    out, covered = {}, []
    for ph in ("pre-pass", "tile", "gemv", "second pass"):
        if ph in spans:
            out[ph] = _union(covered + spans[ph]) - _union(covered)
            covered += spans[ph]
    return {ph: round(us / len(argsets), 2) for ph, us in out.items()}


def _union(spans):
    """The length of the union of (start, end) spans."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        total += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return total


def _ptxas(log: Path) -> dict:
    """{mangled kernel name: "N regs, S spill"} for PTXAS_KERNELS, read from
    the compiler's -v report beside the library."""
    out, name = {}, None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            spill = line.strip().split(",")[1].split()[0]
        elif name and "Used" in line and "registers" in line:
            regs = line.split("Used")[1].split()[0]
            if any(k in name for k in PTXAS_KERNELS):
                out[name] = f"{regs} regs, {spill} B spill"
            name = None
    return out


def one(root: Path, only) -> dict:
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import bgmv, build, lora_matmul as lm

    lib = build.build()
    build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(4)
    us, err, split = {}, {}, {}

    def wanted(name):
        return not only or name.startswith(only)

    def run(name, kfn, pfn, args):
        if not wanted(name):
            return
        got, want = kfn(*args[0]), pfn(*args[0])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err[name] = max(float((a - b).abs().max()) for a, b in zip(got, want))
        us[name] = cs._graph_ms(kfn, args) * 1e3
        if name.split()[0] in SPLIT_KERNELS:
            split[name] = _split_us(kfn, args)

    def copies(nbytes):
        return max(2, math.ceil(3 * cs.L2_BYTES / nbytes))

    # #2 and #3 at the serving prefill: 4 requests x 128 rows, r = 8
    B, s, r8 = 4, 128, 8
    for model, proj, k, n in (("gemma-2b", "q", 2048, 2048),
                              ("gemma-2b", "v", 2048, 256),
                              ("recurrentgemma-9b", "q", 4096, 4096),
                              ("recurrentgemma-9b", "v", 4096, 256)):
        x, w, a, b, _ = cs._bank(gen, B, s, k, n, B, (r8,) * B,
                                 torch.float32)
        x1 = x[:, 0].contiguous()
        ws = [w.clone() for _ in range(copies(w.nbytes))]
        run(f"bgmv_matmul {model} {proj}", bgmv.bgmv_matmul,
            bgmv.bgmv_matmul_plain, [(x, wi, a, b) for wi in ws])
        run(f"bgmv_gemv {model} {proj}", bgmv.bgmv_gemv,
            bgmv.bgmv_gemv_plain, [(x1, wi, a, b) for wi in ws])
        del ws
        if model != "gemma-2b":
            continue
        for bits in (4, 8):
            wf = quantize(w, bits, 64).dequantize()
            wqs = [quantize(wf, bits, 64)
                   for _ in range(copies(quantize(wf, bits, 64).nbytes))]
            run(f"bgmv_matmul_quant int{bits} {proj}", bgmv.bgmv_matmul_quant,
                bgmv.bgmv_matmul_quant_plain, [(x, wi, a, b) for wi in wqs])
            run(f"bgmv_gemv_quant int{bits} {proj}", bgmv.bgmv_gemv_quant,
                bgmv.bgmv_gemv_quant_plain, [(x1, wi, a, b) for wi in wqs])
            del wqs
    m, k, r = 512, 2048, 64
    for proj, n in (("q", 2048), ("v", 256)):
        x, w, a, b, g = cs._lora_operands(gen, m, k, n, r, torch.float32)
        ws = [w.clone() for _ in range(copies(w.nbytes))]
        _, p = lm.lora_fwd_plain(x, w, a, b, 1.0)
        _, q = lm.lora_bwd_dx_plain(g, w, a, b, 1.0)
        run(f"lora_fwd {proj}", lm.lora_fwd, lm.lora_fwd_plain,
            [(x, wi, a, b, 1.0) for wi in ws])
        run(f"lora_bwd_dx {proj}", lm.lora_bwd_dx, lm.lora_bwd_dx_plain,
            [(g, wi, a, b, 1.0) for wi in ws])
        run(f"lora_bwd_da {proj}", lm.lora_bwd_da, lm.lora_bwd_da_plain,
            [(q, x, 1.0)] * 8)
        run(f"lora_bwd_db {proj}", lm.lora_bwd_db, lm.lora_bwd_db_plain,
            [(g, p, 1.0)] * 8)
        if wanted("lora_bwd_da"):
            us[f"lora_bwd_da {proj} matmul"] = cs._graph_ms(
                lambda q_, x_: torch.matmul(q_.t(), x_), [(q, x)] * 8) * 1e3
        if wanted("lora_bwd_db"):
            us[f"lora_bwd_db {proj} matmul"] = cs._graph_ms(
                lambda g_, p_: torch.matmul(g_.t(), p_), [(g, p)] * 8) * 1e3
        del ws
    shapes = {"q": (2048, 2048), "v": (2048, 256), "k": (2048, 256),
              "o": (2048, 2048), "w_up": (2048, 16384),
              "w_down": (16384, 2048)}
    for bits, proj in itertools.product((4, 8), shapes):
        kk, n = shapes[proj]
        mode = f"int{bits} {proj}"
        wf = quantize(torch.randn(kk, n, generator=gen, device="cuda")
                      * kk ** -0.5, bits, 64).dequantize()
        wqs = [quantize(wf, bits, 64)
               for _ in range(copies(quantize(wf, bits, 64).nbytes))]
        x, _, a, b, g = cs._lora_operands(gen, m, kk, n, r, torch.float32)
        if proj in ("k", "o", "w_up", "w_down"):
            run(f"quant_matmul {mode}", lm.quant_matmul,
                lm.quant_matmul_plain, [(x, wi) for wi in wqs])
            run(f"quant_matmul {mode} m 4", lm.quant_matmul,
                lm.quant_matmul_plain, [(x[:4], wi) for wi in wqs])
        if proj in ("k", "o", "w_up", "w_down"):
            run(f"quant_matmul_dx {mode}", lm.quant_matmul_dx,
                lm.quant_matmul_dx_plain, [(g, wi) for wi in wqs])
        if proj in ("q", "v"):
            run(f"lora_fwd_quant {mode}", lm.lora_fwd_quant,
                lm.lora_fwd_quant_plain, [(x, wi, a, b, 1.0) for wi in wqs])
            run(f"lora_bwd_dx_quant {mode}", lm.lora_bwd_dx_quant,
                lm.lora_bwd_dx_quant_plain,
                [(g, wi, a, b, 1.0) for wi in wqs])
        del wqs
    # #13: (label, h, table columns, window); B 4, kh 1, hd 256, block 16
    pa = cs.paged_attention
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for label, h, mb, window in (("a", 8, 10, None), ("b", 16, 10, 2048),
                                 ("c", 16, 128, 2048)):
        if not (wanted("paged_attention") or wanted("sdpa")):
            break
        q, kp, vp, pos, table, qpos = cs._paged_case(gen, 4, h, 1, 256, 16,
                                                      mb)
        for dt in (torch.float32, torch.bfloat16):
            tag = f"({label}) h {h} mb {mb} {str(dt)[6:]}"
            args = [(q.to(dt), kp.to(dt), vp.to(dt), pos, table, qpos)] * 8
            run(f"paged_attention {tag}",
                lambda *a_: pa.paged_attention(*a_, window=window),
                lambda *a_: pa.paged_attention_plain(*a_, window=window),
                args)
            if wanted("sdpa"):
                kg, vg = (t.to(dt)[table.long()].reshape(4, -1, 1, 256)
                          .permute(0, 2, 1, 3).expand(4, h, -1, -1)
                          .contiguous() for t in (kp, vp))
                pg = pos[table.long()].reshape(4, -1)
                ok = (pg >= 0) & (pg <= qpos[:, None])
                if window:
                    ok &= qpos[:, None] - pg < window
                sargs = [(q.to(dt)[:, :, None], kg, vg,
                          ok[:, None, None, :])] * 8
                us[f"sdpa {tag}"] = cs._graph_ms(
                    lambda q_, k_, v_, m_: sdpa(q_, k_, v_, attn_mask=m_),
                    sargs) * 1e3
    # #14 at the two attention shapes of chip_smoke.time_scan_flash
    fa = cs.flash_attention
    for label in ("recurrentgemma-9b", "gemma-2b"):
        if not wanted(f"flash_attention {label}"):
            continue
        b, s_, t_, h, kh, d, causal, window = cs.FLASH_SHAPES[label]
        q, k_, v = cs._flash_operands(gen, cs.FLASH_SHAPES[label],
                                      torch.float32)
        kw = dict(causal=causal, window=window)
        run(f"flash_attention {label}",
            lambda *x: fa.flash_attention(*x, **kw),
            lambda *x: fa.flash_attention_plain(*x, **kw), [(q, k_, v)] * 2)
        qh = q.reshape(b, h, s_, d)
        kx, vx = (y.reshape(b, kh, t_, d).repeat_interleave(h // kh, dim=1)
                  for y in (k_, v))
        mask = fa.band_mask(s_, t_, causal=causal, window=window,
                            device=q.device)
        sargs = [(qh, kx, vx)] * 2
        us[f"flash_attention {label} sdpa"] = cs._graph_ms(
            (lambda *x: sdpa(*x, is_causal=causal)) if window is None else
            (lambda *x: sdpa(*x, attn_mask=mask)), sargs) * 1e3
        del q, k_, v, qh, kx, vx, sargs
        torch.cuda.empty_cache()
    return {"us": {k: round(v, 2) for k, v in us.items()},
            "split_us": split, "max_abs_err": err,
            "ptxas": _ptxas(lib.with_suffix(".log"))}


def main(argv):
    if argv[:1] == ["--one"]:
        only = tuple(argv[2].split(",")) if argv[2] else ()
        print(json.dumps(one(Path(argv[1]).resolve(), only)))
        return 0
    only = ""
    if argv[:1] == ["--only"]:
        only, argv = argv[1], argv[2:]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    for d in argv:
        out = subprocess.run([sys.executable, __file__, "--one", d, only],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(json.dumps({"tree": Path(d).name,
                          **json.loads(out.stdout.splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
