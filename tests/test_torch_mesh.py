"""Federated training on a mesh (``FederatedTrainer(mesh=)``, ``--mesh``)
on the CPU: gloo ranks spawned in ``tmp_path`` over a file store, one
torch thread each (``tests/torch_mesh_worker.py``).

  2x1   the client axis alone: the adapters, optimizer state and history
        equal the single-device port's bit for bit (3 rounds, fedsa +
        sfedlora; device data under participation 0.5; the buffered
        engine under faults with the watchdog and adamw), and checkpoints
        move between a mesh and none.
  1x2, 2x2   a model axis: every dense arch (and one arch of every other
        family at 1x2: MoE, hybrid, encoder, xLSTM, and the audio and VLM
        families through ``round_step`` with frames / patches) holds the
        single-device JAX trainer's trajectory within 1e-4 x max(1,
        |ref|) (``TRAJ_RTOL``, the port's trajectory bound: fp32 on both
        sides, tensor-parallel sums taken in another order).
  1x2, 2x2 decode   greedy decode over a base and a cache placed by the
        rules (the dry-run's decode step) holds the single-device decode
        (dense on both; the MoE, RG-LRU and xLSTM families at 1x2).

The JAX references are the single-device JAX trainer (its mesh run is
broken in the reference itself), built once per module; JAX's base and
``init_lora`` draw are carried across as numpy.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs                          # noqa: E402
from repro.configs import base as jbase                        # noqa: E402
from repro.core import federated as jfed                       # noqa: E402
from repro.data import synthetic as jsyn                       # noqa: E402
from repro.models import api as japi                           # noqa: E402
from repro_torch import configs as tconfigs                    # noqa: E402
from repro_torch.checkpoint.io import load_federated_state     # noqa: E402
from repro_torch.models import api as tapi                     # noqa: E402
from repro_torch.launch import train as ttrain                 # noqa: E402

import torch_mesh_worker as worker                             # noqa: E402

TRAJ_RTOL = 1e-4
ROUNDS = 3
DENSE = ("gemma-2b", "llama2-7b", "qwen3-8b", "mistral-nemo-12b",
         "stablelm-1.6b")
# the other families on the model axis, one arch each; the audio and VLM
# families train through round_step (the dataset makes no frames or
# patches)
ROUND_STEP = ("whisper-medium", "paligemma-3b")
MODEL_AXIS = DENSE + ("qwen2-moe-a2.7b", "recurrentgemma-9b",
                      "roberta-large", "xlstm-1.3b") + ROUND_STEP
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# greedy decode over a sharded base and cache (the JAX trainer's draw of
# the reduced gemma-2b base), 4 steps from two first tokens
DECODE = {"decode": True, "steps": 4,
          "token": np.array([[3], [77]], np.int32)}
# the dense decode on both meshes; at 1x2 also the families whose decode
# state is not a ring (the MoE block, the RG-LRU state, the mLSTM / sLSTM
# state, each updated shard by shard)
DECODE_ARCHS = {"1x2": ("gemma-2b", "qwen2-moe-a2.7b", "recurrentgemma-9b",
                        "xlstm-1.3b"), "2x2": ("gemma-2b",)}
DECODE_RTOL = 1e-5
# one MoE layer under moe_grouped, its batch rows split over "data" (2x2)
MOE_ROWS = "qwen2-moe-a2.7b"
MOE_RTOL = 1e-6
# the xLSTM's first round alone: a round amplifies a difference in its
# adapters 100-400 times (tests/test_torch_xlstm.py), so its 3-round run
# holds JAX's only as far as the host's rounding allows
XLSTM_FIRST = "xlstm-1.3b, one round"
# LoRA on the row-parallel projections too (o, w_down), beside q / v
ROW_PARALLEL = {"arch": "gemma-2b", "rounds": ROUNDS,
                "targets": ("q", "v", "o", "w_down")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small ops gain nothing from more torch threads, and the suite's
    parallel workers (and the spawned ranks) share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _round_batches(cfg, seed=12):
    """Per round, (N, local_steps, ...) tokens and frames or patches."""
    rng = np.random.default_rng(seed)
    extra = ({"frames": (cfg.encoder_frames, cfg.d_model)}
             if cfg.family == "audio" else
             {"patches": (cfg.num_patches, 1152)})
    return [{"tokens": rng.integers(0, cfg.vocab_size, (4, 2, 2, 16)).astype(
        np.int32), **{k: rng.standard_normal((4, 2, 2) + shape).astype(
            np.float32) for k, shape in extra.items()}}
        for _ in range(ROUNDS)]


def _jax_round_steps(tr, batches):
    aset, opt, hist = tr.adapters, tr.opt_state, []
    for r, batch in enumerate(batches):
        aset, opt, m = tr.round_step(
            tr.base, aset, opt, {k: jax.numpy.asarray(v)
                                 for k, v in batch.items()},
            jax.numpy.asarray(r))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, _np(aset.lora)


def _jax_trainer(arch):
    """The single-device JAX trainer and its draws carried over (and, for
    the families trained through ``round_step``, its batches)."""
    cfg = jconfigs.get_config(arch).reduced(d_model=64, vocab_size=256)
    m = japi.build_model(cfg)
    params = m.init(jax.random.key(0))
    tr = jfed.FederatedTrainer(
        m, jsyn.FederatedDataset(cfg.vocab_size, 4, seq_len=16,
                                 batch_per_client=2, seed=0),
        lora_cfg=jbase.LoRAConfig(rank=8, alpha=8.0, scaling="sfedlora",
                                  targets=cfg.lora_targets),
        fed_cfg=jbase.FederatedConfig(num_clients=4, local_steps=2,
                                      aggregation="fedsa"),
        opt_cfg=jbase.OptimizerConfig(name="sgd", lr=0.5), seed=0,
        base_params=params)
    draws = {"base": _np(params),
             "lora_init": jax.tree.map(lambda x: np.asarray(x[0]), tr.lora)}
    if arch in ROUND_STEP:
        draws["batches"] = _round_batches(cfg)
    return tr, draws


@pytest.fixture(scope="module")
def model_axis_runs(tmp_path_factory):
    """The 2x2 and 1x2 mesh runs, each started as soon as its archs' JAX
    draws exist, so the ranks and the JAX references share the wall
    clock; (refs, spec -> (its directory, each rank's results))."""
    trainers, jobs = {}, {}
    for spec, archs in (("2x2", DENSE), ("1x2", MODEL_AXIS)):
        trainers.update({a: _jax_trainer(a) for a in archs
                         if a not in trainers})
        tmp = tmp_path_factory.mktemp(f"mesh{spec}")
        job = {a: {"arch": a, "rounds": ROUNDS, **trainers[a][1]}
               for a in archs}
        if spec == "1x2":
            job["save"] = {**job["gemma-2b"], "rounds": 1,
                           "save": str(tmp / "tp.npz")}
            job[XLSTM_FIRST] = {**job["xlstm-1.3b"], "rounds": 1}
            job["row-parallel"] = ROW_PARALLEL
        if spec == "2x2":
            job["moe rows"] = _moe_rows_job()
        # 2x2: one request, too few to split, so the ring's slots split
        # over "data" (each rank writes the slots of its own range)
        for arch in DECODE_ARCHS[spec]:
            job[f"decode {arch}"] = {
                **DECODE, "arch": arch, "base": trainers[arch][1]["base"],
                **({} if spec == "1x2" else {"token": DECODE["token"][:1]})}
        jobs[spec] = (tmp, worker.start(tmp, spec, job))
    refs = {}
    tr, draws = _jax_trainer("xlstm-1.3b")
    tr.run(1)
    refs[XLSTM_FIRST] = {**draws, "history": tr.history, "lora": _np(tr.lora)}
    for a, (tr, draws) in trainers.items():
        if a in ROUND_STEP:
            hist, lora = _jax_round_steps(tr, draws["batches"])
        else:
            tr.run(ROUNDS)
            hist, lora = tr.history, _np(tr.lora)
        refs[a] = {**draws, "history": hist, "lora": lora}
    return refs, {spec: (tmp, wait()) for spec, (tmp, wait) in jobs.items()}


def _moe_rows_job():
    """The grouped MoE scenario: one reduced MoE layer's weights and four
    rows of activations, from a numpy seed."""
    from repro_torch.models import moe as tmoe
    cfg = tconfigs.get_config(MOE_ROWS).reduced(d_model=64, vocab_size=256)
    g = torch.Generator().manual_seed(7)
    params = {k: v.numpy() for k, v in tmoe.moe_params(cfg, g).items()}
    x = np.random.default_rng(8).standard_normal((4, 16, 64)).astype(
        np.float32)
    return {"moe": True, "arch": MOE_ROWS, "params": params, "x": x}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree)]


def _assert_equal_state(got, want):
    assert got["history"] == want["history"]
    for key in ("lora", "opt"):
        for a, b in zip(_leaves(got[key]), _leaves(want[key]), strict=True):
            np.testing.assert_array_equal(a, b)


def _assert_near_jax(got, ref, rounds=ROUNDS):
    assert "error" not in got, got.get("trace")
    assert len(got["history"]) == len(ref["history"]) == rounds
    for th, jh in zip(got["history"], ref["history"]):
        for key in ("loss", "grad_norm"):
            assert abs(th[key] - jh[key]) <= TRAJ_RTOL * max(
                1.0, abs(jh[key])), (key, th, jh)
    for a, b in zip(_leaves(got["lora"]), _leaves(ref["lora"]), strict=True):
        np.testing.assert_allclose(
            a, b, rtol=0, atol=TRAJ_RTOL * max(1.0, float(np.abs(b).max())))


def _single(sc):
    tr = worker.make_trainer(sc)
    if sc.get("restore"):
        tr.restore(sc["restore"])
    tr.run(sc["rounds"])
    return worker.state(tr)


# ------------------------------------------------------------- client axes

def test_client_axis_is_bit_identical_and_checkpoints_move(tmp_path):
    """2x1: each rank trains its two of four clients and gathers the rest,
    so every run equals the single-device port's bit for bit; a mesh
    checkpoint resumes without a mesh and the other way round."""
    plain_ck = str(tmp_path / "plain.npz")
    base = dict(arch="gemma-2b", rounds=ROUNDS)
    first = worker.make_trainer({**base, "rounds": 2})
    first.run(2)
    first.save(plain_ck)
    job = {
        "sync": base,
        "device_part": {**base, "data_mode": "device",
                        "participation": 0.5},
        "faults": {**base, "faults": "dropout=0.2,straggle=geom:0.3,"
                   "corrupt=0.25", "buffer": 3, "watchdog": 2,
                   "optimizer": "adamw", "lr": 0.01, "chunk": 2},
        "save": {**base, "rounds": 2, "save": str(tmp_path / "mesh.npz")},
        "resume": {**base, "rounds": 1, "restore": plain_ck},
    }
    ranks = worker.spawn(tmp_path, "2x1", job)
    single = {name: _single(job[name])
              for name in ("sync", "device_part", "faults")}
    for name, want in single.items():
        for out in ranks:
            assert "error" not in out[name], out[name].get("trace")
            _assert_equal_state(out[name], want)
    three = single["sync"]
    # written on the mesh, resumed on one device
    resumed = _single({**base, "rounds": 1,
                       "restore": str(tmp_path / "mesh.npz")})
    last = {**three, "history": three["history"][-1:]}
    _assert_equal_state(resumed, last)
    # written on one device, resumed on the mesh
    for out in ranks:
        assert "error" not in out["resume"], out["resume"].get("trace")
        _assert_equal_state(out["resume"], last)


def test_cli_on_a_mesh_prints_the_single_device_run(tmp_path, capsys):
    """``torch.distributed.run`` with two CPU ranks and ``--mesh 2x1``:
    device 0 prints the single-device CLI's lines, the header naming the
    mesh, and writes the checkpoint."""
    args = ["--reduced", "--device", "cpu", "--rounds", "2", "--seq", "16",
            "--clients", "2"]
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo"}
    ck = str(tmp_path / "cli.npz")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "-m", "repro_torch.launch.train", *args, "--mesh", "2x1",
         "--save", ck], capture_output=True, text=True, env=env,
        timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(("#", "round"))]
    tr = ttrain.main(args)           # one thread, as the ranks: the same sums
    single = capsys.readouterr().out.splitlines()
    assert lines[0] == single[0].replace(" N=2", " N=2 mesh=2x1")
    assert lines[1:-1] == single[1:]
    assert lines[-1] == f"# saved -> {ck}"
    _, lora, _, rnd, _ = load_federated_state(ck)
    assert rnd == 2
    for a, b in zip(_leaves(lora), _leaves(worker._numpy(tr.lora)),
                    strict=True):
        np.testing.assert_array_equal(a, b)


def test_cli_refuses_quant_on_a_mesh():
    with pytest.raises(SystemExit, match="--quant is single-host for now"):
        ttrain.main(["--reduced", "--device", "cpu", "--mesh", "2x1",
                     "--quant", "int4"])


# --------------------------------------------------------------- model axis

@pytest.mark.parametrize("spec", ["1x2", "2x2"])
def test_model_axis_holds_the_jax_trainer(model_axis_runs, spec):
    """The base tensor-parallel over "model", each client's forward and
    backward over the model sub-mesh (kernels on the local shards): the
    JAX trainer's trajectory within TRAJ_RTOL on every rank.  The 2x2
    mesh also shards the four clients over "data"."""
    refs, runs = model_axis_runs
    tmp, ranks = runs[spec]
    archs = MODEL_AXIS if spec == "1x2" else DENSE
    for out in ranks:
        for a in archs:
            _assert_near_jax(out[a], refs[a])
    if spec == "1x2":
        # adapted o / w_down (row-parallel, replicated for the adapter):
        # the single-device port's run within the same bound
        want = _single(ROW_PARALLEL)
        for out in ranks:
            _assert_near_jax(out["row-parallel"], want)
        # the sharded base is gathered into the file whole
        base, *_ = load_federated_state(str(tmp / "tp.npz"))
        for a, b in zip(_leaves(base), _leaves(refs["gemma-2b"]["base"]),
                        strict=True):
            np.testing.assert_array_equal(a, b)


def test_model_axis_first_xlstm_round_holds_the_jax_trainer(
        model_axis_runs):
    """xlstm-1.3b's first round at 1x2 against the JAX trainer's within
    TRAJ_RTOL on every rank, before the recurrence amplifies the sharded
    sums' rounding over the later rounds."""
    refs, runs = model_axis_runs
    _, ranks = runs["1x2"]
    for out in ranks:
        _assert_near_jax(out[XLSTM_FIRST], refs[XLSTM_FIRST], rounds=1)


@pytest.mark.parametrize("spec,arch", [(spec, a) for spec, archs in
                                       DECODE_ARCHS.items() for a in archs])
def test_decode_on_a_sharded_base_and_cache(model_axis_runs, spec, arch):
    """``decode_step`` with the base placed by ``params_sharding``, the
    ring cache by ``cache_sharding`` and each step's token and position by
    ``inputs_sharding`` (the dry-run's decode) gives the single-device
    decode's logits within 1e-5 x max(1, max|logits|) and its greedy
    tokens, on every rank: at 1x2 two requests and the cache's head dim
    (or the recurrent state's last dim) split over "model", at 2x2 one
    request and the ring's slots split over "data" too."""
    refs, runs = model_axis_runs
    _, ranks = runs[spec]
    token = DECODE["token"] if spec == "1x2" else DECODE["token"][:1]
    want = worker.decode_steps({**DECODE, "arch": arch, "token": token,
                                "base": refs[arch]["base"]})
    bound = DECODE_RTOL * max(1.0, float(np.abs(want["logits"]).max()))
    for out in ranks:
        got = out[f"decode {arch}"]
        assert "error" not in got, got.get("trace")
        np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                                   atol=bound)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_grouped_moe_on_each_devices_rows(model_axis_runs):
    """``moe_grouped`` at 2x2: each rank dispatches its own two of four
    rows through the experts it holds (no gather of the batch), and the
    output and aux loss equal one device's within 1e-6 x max(1, max|out|)
    (the routed outputs sum across the expert split in another order)."""
    _, runs = model_axis_runs
    _, ranks = runs["2x2"]
    job = _moe_rows_job()
    want = worker.grouped_moe(job)
    for out in ranks:
        got = out["moe rows"]
        assert "error" not in got, got.get("trace")
        bound = MOE_RTOL * max(1.0, float(np.abs(want["out"]).max()))
        np.testing.assert_allclose(got["out"], want["out"], rtol=0,
                                   atol=bound)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=0,
                                   atol=MOE_RTOL * max(1.0, abs(
                                       float(want["aux"]))))


def test_model_axis_covers_every_family():
    assert {jconfigs.get_config(a).family for a in MODEL_AXIS} == set(
        tapi.FAMILIES)
