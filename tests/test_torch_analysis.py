"""``repro_torch.analysis`` (the lint, the sanitizers, the CLI, the lazy
exports) against ``tests/test_analysis.py``'s cases for the JAX package,
on the CPU.

- RecompileGuard: watch, wrap (a recompile on a served signature, the
  churn of treedefs) and the context manager, over an engine with a fake
  cache probe; a callable without one is a watchable no-op, as in JAX.
- The transfer guard: resident operands pass, a numpy operand (JAX's
  "un-device_put operand") or one on another device trips, on any host.
- ``serve_scheduled(guard=, transfer_guard=True)`` gives the unguarded
  run's tokens; a guarded trainer chunk runs, and trips on a numpy
  optimizer-state leaf.
- R1, R5 and R7 each flag a bad snippet and pass its fixed twin; a pragma
  without a reason is refused; ``python -m repro_torch.analysis lint
  src/repro_torch`` exits 0.
The card's half of the guard (``set_sync_debug_mode``) is in
``tests/test_torch_cuda.py``."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.analysis as janalysis                              # noqa: E402
import repro_torch.analysis as tanalysis                        # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.analysis.lint import lint_source, report      # noqa: E402
from repro_torch.analysis.sanitizers import (                  # noqa: E402
    RecompileError, RecompileGuard, TransferGuardError, guard_transfers,
    no_implicit_transfers)
from repro_torch.configs.base import (FederatedConfig,          # noqa: E402
                                      LoRAConfig, OptimizerConfig)
from repro_torch.core.federated import FederatedTrainer        # noqa: E402
from repro_torch.data.synthetic import FederatedDataset        # noqa: E402
from repro_torch.launch import serve as tserve                 # noqa: E402
from repro_torch.models.api import build_model                 # noqa: E402
from repro_torch.tree import tree_map                          # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: its small ops gain nothing
    from more, and the suite's parallel workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the exports

def test_exports_are_jax_names_and_resolve():
    """Every name JAX's ``repro.analysis`` exports, but the tracer guard
    (``host_only``, ``HostOnlyError``: the port has no tracers), resolves
    lazily to the port's module."""
    assert set(tanalysis.__all__) == set(janalysis.__all__) - {
        "host_only", "HostOnlyError"}
    for name in tanalysis.__all__:
        assert getattr(tanalysis, name).__module__.startswith(
            "repro_torch.analysis."), name
    with pytest.raises(AttributeError):
        tanalysis.host_only                  # noqa: B018


# ---------------------------------------------------------- RecompileGuard

class _Engine:
    """An engine with a cache probe: it "compiles" once per signature in
    ``compiles``, or on every call when ``churn`` is set."""

    def __init__(self, churn=False):
        self.size, self.churn, self.seen = 0, churn, set()

    def _cache_size(self):
        return self.size

    def __call__(self, x, *rest):
        key = (tuple(x.shape) if isinstance(x, torch.Tensor)
               else len(x), len(rest))
        if self.churn or key not in self.seen:
            self.seen.add(key)
            self.size += 1
        return x


def test_recompile_guard_watch_mode_detects_cold_shape():
    f = _Engine()
    f(torch.ones(4))                          # warm one shape
    guard = RecompileGuard()
    guard.watch("double", f)
    f(torch.ones(4))                          # served shape: fine
    guard.check()
    f(torch.ones(8))                          # cold shape in the region
    with pytest.raises(RecompileError, match="double"):
        guard.check()


def test_recompile_guard_wrap_catches_seeded_recompile():
    engine = _Engine(churn=True)
    guard = RecompileGuard()
    step = guard.wrap("churn", engine)
    x = torch.ones(4)
    step(x)                                   # first compile: allowed
    assert guard.events and "first compile" in guard.events[0]
    with pytest.raises(RecompileError, match="previously-served"):
        step(x)                               # same signature, cache grew


def test_recompile_guard_wrap_catches_treedef_churn():
    engine = _Engine(churn=True)
    guard = RecompileGuard(max_treedef_variants=2)
    step = guard.wrap("aux_churn", lambda d: engine(list(d.values())),
                      cache_probe=engine)
    x = torch.ones(4)
    with pytest.raises(RecompileError, match="distinct treedefs"):
        for i in range(6):                    # a per-call dict key
            step({f"k{i}": x})


def test_recompile_guard_context_manager_and_unprobed_callables():
    f = _Engine()
    for n in (4, 8):
        f(torch.ones(n))                      # warm every shape up front
    guard = RecompileGuard()
    guard.watch("inc", f)
    guard.watch("eager", lambda x: x + 1)     # no probe: a no-op
    with guard:
        for n in (4, 8, 4, 8):
            f(torch.ones(n))
    assert guard.events == []
    step = guard.wrap("eager", lambda x: x + 1)
    for _ in range(3):
        step(torch.ones(2))                   # recorded, never raises
    assert guard.events == []


# ------------------------------------------------------------ transfer guard

def test_transfer_guard_passes_resident_calls():
    f = guard_transfers(lambda x, y: x * y, device="cpu")
    assert f.__transfer_guarded__
    out = f(torch.arange(8.0), torch.tensor(2.0))
    assert float(out[3]) == 6.0
    with no_implicit_transfers():             # a region on its own
        assert float((torch.ones(2) * 3)[0]) == 3.0


def test_transfer_guard_catches_numpy_and_foreign_operands():
    f = guard_transfers(lambda x: x * 2)
    with pytest.raises(TransferGuardError, match="host boundary"):
        f(np.arange(8, dtype=np.float32))
    with pytest.raises(TransferGuardError, match="host boundary"):
        f({"nested": [torch.ones(2), np.ones(2)]})
    g = guard_transfers(lambda x, y: x, device="cpu")
    with pytest.raises(TransferGuardError, match="meta"):
        g(torch.ones(2), torch.empty(2, device="meta"))


def _serving():
    cfg = tconfigs.get_config("gemma-2b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
               for _ in range(3)]

    def requests():
        return [tserve.Request(rid=i, prompt=prompts[i], steps=4)
                for i in range(3)]
    return model, params, requests


def test_serve_scheduled_guarded_gives_the_same_tokens():
    model, params, requests = _serving()
    plain = tserve.serve_scheduled(model, params, requests(), max_batch=2,
                                   chunk=2, wait=False)
    guard = RecompileGuard()
    guarded = tserve.serve_scheduled(model, params, requests(),
                                     max_batch=2, chunk=2, wait=False,
                                     guard=guard, transfer_guard=True)
    assert [r.tokens for r in plain] == [r.tokens for r in guarded]
    assert all(len(r.tokens) == 4 for r in guarded)
    assert guard.events == []                 # eager engines: no caches


def _tiny_trainer():
    cfg = tconfigs.get_config("gemma-2b").reduced()
    return FederatedTrainer(
        build_model(cfg), FederatedDataset(cfg.vocab_size, 3, seq_len=16,
                                           batch_per_client=2, seed=0),
        lora_cfg=LoRAConfig(rank=4, alpha=8.0),
        fed_cfg=FederatedConfig(num_clients=3, local_steps=1,
                                aggregation="fedsa"),
        opt_cfg=OptimizerConfig(name="adamw", lr=0.01), seed=0,
        data_mode="device", chunk_rounds=2, device="cpu")


def test_trainer_chunk_transfer_guarded():
    """The engine holds all-device state: a guarded chunk runs clean, and
    a numpy optimizer-state leaf (un-staged state) trips."""
    tr = _tiny_trainer()
    run = guard_transfers(tr._chunk)
    aset, opt, ms = run(tr.base, tr._train_adapters(), tr.opt_state, 2)
    assert len(ms) == 2
    assert all(np.isfinite(float(m["loss"])) for m in ms)
    opt_np = tree_map(lambda t: t.detach().numpy(), opt)
    with pytest.raises(TransferGuardError):
        run(tr.base, aset, opt_np, 2)


# ------------------------------------------------------------------- rules

SNIPPETS = {
    "R1": ("import torch\n\ndef f(shape):\n    return torch.randn(shape)\n",
           "import torch\n\ndef f(shape, g):\n"
           "    return torch.randn(shape, generator=g)\n"),
    "R1-numpy": ("import numpy as np\n\ndef f():\n"
                 "    return np.random.rand(3)\n",
                 "import numpy as np\n\ndef f(seed):\n"
                 "    return np.random.default_rng(seed).random(3)\n"),
    "R5": ("def f(bank, ids):\n    return bank[ids]\n",
           "def f(bank, ids):\n    check_adapter_ids(ids, len(bank))\n"
           "    return bank[ids]\n"),
    "R7": ("import numpy as np\n\ndef f(x):\n    import numpy as _np\n"
           "    return _np.asarray(x)\n",
           "import numpy as np\n\ndef f(x):\n    return np.asarray(x)\n"),
}


@pytest.mark.parametrize("case", list(SNIPPETS))
def test_rule_flags_bad_snippet_and_passes_its_twin(case):
    bad, good = SNIPPETS[case]
    rule = case.split("-")[0]
    assert [f.rule for f in lint_source("bad.py", bad)] == [rule]
    assert lint_source("good.py", good) == []


def test_pragma_needs_a_reason():
    src = "def f(bank, ids):\n    return bank[ids]{}\n"
    ok = lint_source("p.py", src.format(
        "  # lint: disable=R5 -- ids checked by the caller"))
    assert [f.suppressed for f in ok] == [True]
    assert report(ok)[1] == 0
    bare = lint_source("p.py", src.format("  # lint: disable=R5"))
    assert sorted(f.rule for f in bare) == ["PRAGMA", "R5"]
    assert not any(f.suppressed for f in bare)
    assert report(bare)[1] == 1


def test_cli_lints_the_port_clean():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "lint", "src/repro_torch"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("suppressed (justified) pragma(s)")
