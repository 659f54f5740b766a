#!/usr/bin/env python3
"""A/B device times of the tile kernels of src/repro_torch/kernels/csrc/
lora_matmul.cu across checkouts, on one NVIDIA card.

    python3 ab_tiles.py DIR [DIR ...]

Each DIR is the root of a checkout (for example a ``git archive`` of the
parent commit unpacked under the gitignored ``build/``).  For each DIR in
the order given, a fresh process builds that checkout's kernels into its own
``build/kernels/`` and times, with its own ``chip_smoke._graph_ms`` (CUDA
graph replay), at the training path's shapes (fp32 activations, m = 512,
k = 2048, r = 64, gamma 1):

  #5-#8  lora_fwd / lora_bwd_dx / lora_bwd_da / lora_bwd_db at q (n = 2048)
         and v (n = 256); W rotated over copies that exceed L2 three times,
         #7 / #8 on warm inputs, as chip_smoke.time_lora_kernels does;
  #11    quant_matmul at int4 (group 64) and int8, q, w_up and w_down, at
         m = 512 (its tile) and m = 4 (its split-k GEMV form, which shares
         the W loaders);
  #9, #10, #12  lora_fwd_quant / lora_bwd_dx_quant at q and
         quant_matmul_dx at q, w_up and w_down, int4 and int8, where the
         checkout has them.

Each kernel's output is also held against its plain version (max abs
diff), so a faster build that computes something else shows.  Give the
checkouts as A B B A to cancel drift; one JSON line per run.
"""
import itertools
import json
import math
import subprocess
import sys
from pathlib import Path


def one(root: Path) -> dict:
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import build, lora_matmul as lm

    build.build()
    build.load()
    gen = torch.Generator("cuda").manual_seed(4)
    m, k, r = 512, 2048, 64
    us, err = {}, {}

    def run(name, kfn, pfn, args):
        got, want = kfn(*args[0]), pfn(*args[0])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err[name] = max(float((a - b).abs().max()) for a, b in zip(got, want))
        us[name] = cs._graph_ms(kfn, args) * 1e3

    for proj, n in (("q", 2048), ("v", 256)):
        x, w, a, b, g = cs._lora_operands(gen, m, k, n, r, torch.float32)
        ws = [w.clone() for _ in range(max(2, math.ceil(
            3 * cs.L2_BYTES / w.nbytes)))]
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
        del ws
    shapes = {"q": (2048, 2048), "w_up": (2048, 16384),
              "w_down": (16384, 2048)}
    for bits, proj in itertools.product((4, 8), shapes):
        kk, n = shapes[proj]
        mode = f"int{bits} {proj}"
        wf = quantize(torch.randn(kk, n, generator=gen, device="cuda")
                      * kk ** -0.5, bits, 64).dequantize()
        wqs = [quantize(wf, bits, 64) for _ in range(max(2, math.ceil(
            3 * cs.L2_BYTES / quantize(wf, bits, 64).nbytes)))]
        x, _, a, b, g = cs._lora_operands(gen, m, kk, n, r, torch.float32)
        run(f"quant_matmul {mode}", lm.quant_matmul,
            lm.quant_matmul_plain, [(x, wi) for wi in wqs])
        run(f"quant_matmul {mode} m 4", lm.quant_matmul,
            lm.quant_matmul_plain, [(x[:4], wi) for wi in wqs])
        if hasattr(lm, "quant_matmul_dx"):
            run(f"quant_matmul_dx {mode}", lm.quant_matmul_dx,
                lm.quant_matmul_dx_plain, [(g, wi) for wi in wqs])
            if proj == "q":
                run(f"lora_fwd_quant {mode}", lm.lora_fwd_quant,
                    lm.lora_fwd_quant_plain,
                    [(x, wi, a, b, 1.0) for wi in wqs])
                run(f"lora_bwd_dx_quant {mode}", lm.lora_bwd_dx_quant,
                    lm.lora_bwd_dx_quant_plain,
                    [(g, wi, a, b, 1.0) for wi in wqs])
        del wqs
    return {"us": {k: round(v, 2) for k, v in us.items()},
            "max_abs_err": err}


def main(argv):
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]).resolve())))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    for d in argv:
        out = subprocess.run([sys.executable, __file__, "--one", d],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        print(json.dumps({"tree": Path(d).name,
                          **json.loads(out.stdout.splitlines()[-1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
