"""Training across nodes on the CPU: the port's counterpart of
tests/test_multihost_e2e.py. PyTorch's launcher (`python -m
torch.distributed.run`, torchrun) starts two "nodes" on 127.0.0.1 with two
gloo ranks each; every process joins the group from the launcher's variables
(parallel/mesh.py `run_joined`) and runs tests/torch_ddp_cases.py's cases
as its global rank of 4:

- the ranks' losses, gradients, weights, teachers and val counts bit-equal
  to `mesh.launch`'s 4 ranks on one node (the same global ranks, batch and
  draws; gloo sums in the same order);
- within 1e-5 of the largest entry of one process on the global batch, as
  tests/test_torch_ddp.py holds 2 ranks; the AnatoMask case's gradients and
  weights in float32 within limits set from their recorded gaps, and in
  float64 (ranks under `launch` and one process) within 1e-5 of each leaf's
  largest entry: the float32 gap is round-off;
- the mean of the ranks' shares of the pooled SparK's loss and of both
  compound losses within 1e-5 of the JAX package's on the global batch.

Then the train entry (`python -m anatomask_torch.cli`'s main, through
tests/torch_launched_entry.py) on two launcher nodes of one rank each at
-device cpu: fold all and its resume; no
spawn, checkpoints from global rank 0 only, validation cases [rank::2],
rank 0's summary.json listing every case. And, in this process: the
variables' rules (partial sets raise, the world size and a -num_gpus that
differs from it, the node's card LOCAL_RANK), a group of one joined and left
through `cli._run_ranks`, and a failed join that raises without a fallback.
Every subprocess has a timeout."""
import argparse
import json
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_cases as cases
from anatomask_torch import cli, convert
from anatomask_torch.parallel import mesh
from anatomask_torch.plans.plans_handler import save_json
from anatomask_tpu.ssl.pretrain import PretrainConfig as JaxPretrainConfig
from anatomask_tpu.ssl.pretrain import build_spark_model as jax_build_spark_model
from anatomask_tpu.ssl.spark import spark_loss as jax_spark_loss
from anatomask_tpu.training import losses as jax_losses
from test_torch_cli import DATASET, _copy_planned, planned  # noqa: F401 (a fixture)
from torch_parity import mask_nd, numpy_params

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
NODES, PER_NODE = 2, 2
WORLD = NODES * PER_NODE
TOL = 1e-5  # of the largest entry
ROUND_OFF = 1e-6  # tests/test_torch_ddp.py's: AdamW on a round-off gradient
TIMEOUT = 300  # seconds a launcher node may take before it is killed
LAUNCHER = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT="29999", WORLD_SIZE="4", RANK="3",
                LOCAL_RANK="1", LOCAL_WORLD_SIZE="2")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in mesh.LAUNCHER_VARIABLES}
    env["PYTHONPATH"] = os.pathsep.join([ROOT, TESTS, env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


def start_nodes(script, args, per_node, env=None):
    """Two launcher nodes on 127.0.0.1 running `script args`, per_node ranks
    each, on one free port; the Popen of each."""
    port = str(mesh._free_port())
    return [subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(NODES),
         "--nproc_per_node", str(per_node), "--node_rank", str(k), "--master_addr",
         "127.0.0.1", "--master_port", port, script, *args],
        env=env or _env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(NODES)]


def finish(nodes):
    """Each node's output once it has ended (killed after TIMEOUT); raises
    with the outputs if one failed."""
    outs = []
    for p in nodes:
        try:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in nodes:
                q.kill()
            outs.append(p.communicate()[0])
            raise AssertionError(f"a launcher node ran over {TIMEOUT} s:\n" + "\n".join(outs))
    assert all(p.returncode == 0 for p in nodes), "\n".join(outs)
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's pooled SparK loss on the global batch, one process's results,
    the launcher ranks', `launch`'s ranks); the SparK's weights are JAX's,
    drawn with numpy. `launch`'s ranks and one process also run the
    AnatoMask case in float64 ("anatomask64")."""
    folder = str(tmp_path_factory.mktemp("multinode"))
    jcfg = JaxPretrainConfig(**cases.SPARK)
    jmodel = jax_build_spark_model(jcfg)
    x, _, keep = cases.spark_inputs(jmodel.fmap, jmodel.len_keep, WORLD)
    keep_nd = keep[:, 0]
    params = numpy_params(jmodel, 8, jnp.zeros((1, *jcfg.patch_size, 1)), mask_nd(keep_nd[:1]))
    torch.save(convert.from_jax("spark", params), os.path.join(folder, "spark_init.pt"))

    nodes = start_nodes(os.path.join(TESTS, "torch_ddp_cases.py"),
                        [folder, str(WORLD), "node-"], PER_NODE)
    inp, rec = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x.transpose(0, 2, 3, 4, 1)),
                                     mask_nd(keep_nd))
    jax_loss = float(jax_spark_loss(inp, rec, mask_nd(keep_nd))[0])
    finish(nodes)  # one set of 4 ranks at a time on the CPU
    mesh.launch(cases.run_all, WORLD, "cpu", folder, WORLD, "launch-", True)
    threads = torch.get_num_threads()
    try:
        cases.run_all(folder, WORLD, "one-", True)
    finally:
        torch.set_num_threads(threads)
    load = lambda n: torch.load(os.path.join(folder, n))  # noqa: E731
    return (jax_loss, load("one-one.pt"), [load(f"node-rank{r}.pt") for r in range(WORLD)],
            [load(f"launch-rank{r}.pt") for r in range(WORLD)])


def _tensors(result):
    """Every tensor of a rank's results, by a path of keys."""
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, w in v.items():
                walk(f"{prefix}/{k}", w)
        elif isinstance(v, (list, tuple)):
            for i, w in enumerate(v):
                walk(f"{prefix}/{i}", w)
        else:
            out[prefix] = v
    walk("", result)
    return out


@pytest.mark.parametrize("kind", ["losses", "tensors"])
def test_launcher_ranks_bit_equal_to_launch(runs, kind):
    """Each launcher rank's every number (kind "losses": the floats; else
    the tensors) equals the same global rank's under `launch` bit for bit."""
    _, _, nodes, launched = runs
    for r, (got, want) in enumerate(zip(nodes, launched)):
        got, want = _tensors(got), _tensors(want)
        assert set(got) == {k for k in want if not k.startswith("/anatomask64/")}
        for k, v in want.items():
            if k in got and isinstance(v, torch.Tensor) == (kind == "tensors"):
                assert (torch.equal(got[k], v) if kind == "tensors" else got[k] == v), (r, k)


def _close(got, want, what):
    scale = max(float(v.abs().max()) for v in want.values())
    for k, v in want.items():
        assert float((got[k] - v).abs().max()) <= TOL * scale, (what, k)


# the AnatoMask case's float32 gaps between the 4 ranks and one process after
# its 2 steps, each of the largest entry, as recorded on the CPU: gradients
# 9.8e-4, student 1.43e-3, teacher 2.15e-6 (5.4e-5 of the largest gradient
# after step 1, where the weights are still equal: the batch-pooled norms
# amplify the reordered sums' round-off, and AdamW's first step turns
# gradient entries near 0 into +-lr). The limits hold about twice that. In
# float64 the same gaps are 9.1e-9, 7.3e-11 and 7.3e-14.
F32_GAPS = {"grads": 2e-3, "student": 3e-3, "teacher": 5e-6}


def test_anatomask_matches_one_process(runs):
    """The AnatoMask case's launcher ranks against one process in float32:
    the losses within TOL; the gradients, student and teacher within
    F32_GAPS of the largest entry."""
    _, one, nodes, _ = runs
    for r in nodes:
        np.testing.assert_allclose(r["anatomask"]["losses"], one["anatomask"]["losses"], rtol=TOL)
    grads = one["anatomask"]["grads"]
    g_max = max(float(g.abs().max()) for g in grads.values())
    for key, limit in F32_GAPS.items():
        got, want = dict(nodes[0]["anatomask"][key]), dict(one["anatomask"][key])
        for name, g in grads.items():
            if key == "student" and float(g.abs().max()) <= ROUND_OFF * g_max:
                step = float((got.pop(name) - want.pop(name)).abs().max())
                assert step <= 2 * cases.LR * cases.STEPS, name
        scale = max(float(v.abs().max()) for v in want.values())
        for k, v in want.items():
            assert float((got[k] - v).abs().max()) <= limit * scale, (key, k)


def test_anatomask_in_float64_matches_one_process(runs):
    """The witness: the same case in float64, `launch`'s 4 ranks against one
    process. The losses within TOL; each gradient, student and teacher
    tensor within TOL of its own largest entry (at least ROUND_OFF of the
    key's largest: a conv bias that a norm cancels has a gradient of pure
    round-off)."""
    _, one, _, launched = runs
    want = one["anatomask64"]
    assert all(v.dtype == torch.float64 for v in want["grads"].values())
    for r in launched:
        np.testing.assert_allclose(r["anatomask64"]["losses"], want["losses"], rtol=TOL)
    for key in ("grads", "student", "teacher"):
        scale = max(float(v.abs().max()) for v in want[key].values())
        for k, v in want[key].items():
            gap = float((launched[0]["anatomask64"][key][k] - v).abs().max())
            assert gap <= TOL * max(float(v.abs().max()), ROUND_OFF * scale), (key, k, gap)


@pytest.mark.parametrize("preset", cases.PRESETS)
def test_trainer_matches_one_process(runs, preset):
    _, one, nodes, _ = runs
    for r in nodes:
        np.testing.assert_allclose(r[preset]["losses"], one[preset]["losses"], rtol=TOL)
        loss, *counts = r[preset]["val"]
        want_loss, *want = one[preset]["val"]
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL)
        for g, w in zip(counts, want):
            assert torch.equal(g, w)
    _close(nodes[0][preset]["grads"], one[preset]["grads"], "grads")
    _close(nodes[0][preset]["weights"], one[preset]["weights"], "weights")


def test_pooled_spark_loss_matches_jax_on_the_global_batch(runs):
    jax_loss, one, nodes, _ = runs
    np.testing.assert_allclose(np.mean([r["anatomask"]["masked_loss"] for r in nodes]), jax_loss,
                               rtol=TOL)
    np.testing.assert_allclose(one["anatomask"]["masked_loss"], jax_loss, rtol=TOL)


@pytest.mark.parametrize("name", list(cases.LOSSES))
def test_compound_loss_matches_jax_on_the_global_batch(runs, name):
    _, _, nodes, _ = runs
    logits, target = cases.loss_inputs(5, WORLD)
    fn = {"dc_topk": lambda lg: jax_losses.dc_and_topk_loss(
              lg, jnp.asarray(target), ignore_label=cases.IGNORE, k_percent=60.0),
          "dc_ce": lambda lg: jax_losses.dc_and_ce_loss(
              lg, jnp.asarray(target), ignore_label=cases.IGNORE)}[name]
    want, grad = jax.jit(jax.value_and_grad(fn))(jnp.asarray(logits))
    grad = np.asarray(grad)
    np.testing.assert_allclose(np.mean([r[f"loss_{name}"]["loss"] for r in nodes]), float(want),
                               rtol=TOL)
    got = np.concatenate([r[f"loss_{name}"]["grad"].numpy() / WORLD for r in nodes])
    assert np.abs(got - grad).max() <= TOL * np.abs(grad).max()


# --- the entries through the launcher ---------------------------------------

TR = "ATKTrainer_1epoch"
TRAIN = ["train", "965", "3d_fullres", "all", "-tr", TR, "-device", "cpu"]


@pytest.fixture(scope="module")
def entries(planned, tmp_path_factory):  # noqa: F811
    """train fold all (1 epoch) and its resume (2 epochs, --c) in one
    launcher start of two nodes, a rank each, one thread each: (the ATK_*
    folders, node 0's output, node 1's)."""
    tmp = tmp_path_factory.mktemp("entries")
    with pytest.MonkeyPatch.context() as m:
        dirs, _ = _copy_planned(planned, tmp, m)
        env = _env(OMP_NUM_THREADS="1")
    argv = ["-epochs", "1", *TRAIN, "--", "-epochs", "2", *TRAIN, "--c"]
    t0 = time.perf_counter()
    outs = finish(start_nodes(os.path.join(TESTS, "torch_launched_entry.py"), argv, 1, env))
    print(f"the entries through two launcher nodes: {time.perf_counter() - t0:.1f} s")
    print("\n".join(ln for out in outs for ln in out.splitlines() if ln.startswith("[entry]")))
    return dirs, outs


def _lines(out, pattern):
    return [m.groups() for m in re.finditer(pattern, out)]


def test_entries_never_spawn_and_finish_on_every_node(entries):
    """Every entry ends on both nodes, and the helper's guard (spawning
    raises) never fired."""
    _, outs = entries
    for r, out in enumerate(outs):
        assert _lines(out, rf"\[entry\] rank {r}: (\w+) done in") == [
            ("train",), ("train",)], out
        assert "spawned processes under the launcher" not in out


def test_entries_checkpoints_from_global_rank_0(entries):
    dirs, outs = entries
    assert not _lines(outs[1], r"\[checkpoint\] rank (\d+) wrote (\S+)")
    wrote = _lines(outs[0], r"\[checkpoint\] rank (\d+) wrote (\S+)")
    assert wrote == [("0", "checkpoint_best.npz"), ("0", "checkpoint_final.npz")] * 2, wrote
    fold = os.path.join(dirs["results"], DATASET, f"{TR}__ATKPlans__3d_fullres", "fold_all")
    assert sorted(f for f in os.listdir(fold) if f.startswith("checkpoint")) == [
        "checkpoint_best.npz", "checkpoint_final.npz"]


def test_entries_resume(entries):
    """The training resume reads checkpoint_best.npz and ends at epoch 2."""
    dirs, outs = entries
    assert "resuming from checkpoint_best.npz" in outs[0]
    folder = os.path.join(dirs["results"], DATASET)
    from anatomask_torch.training.checkpoint import load_checkpoint
    _, meta = load_checkpoint(os.path.join(folder, f"{TR}__ATKPlans__3d_fullres", "fold_all",
                                           "checkpoint_final.npz"))
    assert meta["current_epoch"] == 2


def test_entries_validation_split_by_global_rank(entries):
    """Each run's final validation predicts every case once, rank r the
    keys [r::2]; rank 0's summary.json lists every case."""
    dirs, outs = entries
    keys = sorted(f[:-4] for f in os.listdir(os.path.join(
        dirs["preprocessed"], DATASET, "ATKPlans_3d_fullres")) if f.endswith(".npz")
        and not f.endswith(".props.npz"))
    for r, out in enumerate(outs):
        got = _lines(out, rf"\[validation\] rank {r}: predicting (\S+)")
        assert got == [(k,) for k in keys[r::NODES]] * 2, out
    validation = os.path.join(dirs["results"], DATASET, f"{TR}__ATKPlans__3d_fullres",
                              "fold_all", "validation")
    with open(os.path.join(validation, "summary.json")) as f:
        summary = json.load(f)
    assert np.isfinite(summary["foreground_mean"]["Dice"])
    assert sorted(os.path.basename(c["prediction_file"]) for c in summary["metric_per_case"]) == [
        k + ".nii.gz" for k in keys]


# --- the launcher's variables, in this process ------------------------------

def test_partial_launcher_variables_raise(monkeypatch):
    for k in mesh.LAUNCHER_VARIABLES:
        monkeypatch.delenv(k, raising=False)
    assert mesh.launcher_env() is None
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(RuntimeError, match="set without"):
        mesh.launcher_env()
    for k, v in LAUNCHER.items():
        monkeypatch.setenv(k, v)
    assert mesh.launcher_env() == mesh.LauncherEnv(world=4, rank=3, local_rank=1, local_world=2)
    for k, v in (("LOCAL_RANK", "2"), ("RANK", "4"), ("LOCAL_WORLD_SIZE", "5"),
                 ("WORLD_SIZE", "x")):
        monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="launcher variables"):
            mesh.launcher_env()
        monkeypatch.setenv(k, LAUNCHER[k])


def test_partial_environment_fails_the_entry_within_seconds(tmp_path):
    """`python -m anatomask_torch.cli pretrain` with RANK alone exits with
    the error before any work."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "anatomask_torch.cli", "pretrain", "1",
                          "-device", "cpu"], env=_env(RANK="1", OMP_NUM_THREADS="1"),
                         capture_output=True, text=True,
                         timeout=120, cwd=str(tmp_path))
    took = time.perf_counter() - t0
    assert res.returncode != 0 and "set without" in res.stderr, res.stderr
    assert took < 60, took


def test_world_size_under_the_launcher(monkeypatch):
    for k, v in LAUNCHER.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("ATK_NUM_DEVICES", raising=False)
    assert mesh.world_size_for("cpu") == 4
    assert mesh.world_size_for("cpu", 4) == 4
    with pytest.raises(RuntimeError, match="WORLD_SIZE is 4"):
        mesh.world_size_for("cpu", 2)
    monkeypatch.setenv("ATK_NUM_DEVICES", "8")
    with pytest.raises(RuntimeError, match="WORLD_SIZE is 4"):
        mesh.world_size_for("cpu")
    monkeypatch.delenv("ATK_NUM_DEVICES")
    visible = torch.cuda.device_count()
    if visible < 2:  # two ranks on this node, one a card
        with pytest.raises(RuntimeError, match="LOCAL_WORLD_SIZE 2"):
            mesh.world_size_for("cuda")
    assert mesh.world_size_for("cuda:0") == 4  # the node's ranks share the card named
    with pytest.raises(RuntimeError, match="WORLD_SIZE is 4"):
        cli.train_entry(["1", "3d_fullres", "0", "-device", "cpu", "-num_gpus", "2"])


def test_rank_device_is_the_node_local_card(monkeypatch):
    """Under the launcher "cuda" is card LOCAL_RANK (1), not the global rank
    (3); under `launch` the rank; a device with an index and the CPU stay."""
    monkeypatch.setattr(mesh, "distributed", lambda: True)
    monkeypatch.setattr(mesh, "rank", lambda: 3)
    for k in mesh.LAUNCHER_VARIABLES:
        monkeypatch.delenv(k, raising=False)
    assert mesh.rank_device("cuda") == torch.device("cuda", 3)
    for k, v in LAUNCHER.items():
        monkeypatch.setenv(k, v)
    assert mesh.rank_device("cuda") == torch.device("cuda", 1)
    assert mesh.rank_device("cuda:0") == torch.device("cuda", 0)
    assert mesh.rank_device("cpu") == torch.device("cpu")
    assert [mesh.backend_for(d) for d in ("cuda", "cuda:0", "cpu")] == ["nccl", "gloo", "gloo"]


def _args(device="cpu", num_gpus=None):
    return argparse.Namespace(device=device, num_gpus=num_gpus)


def test_run_ranks_joins_a_group_of_one_and_leaves_it(monkeypatch):
    """`cli._run_ranks` under the launcher's variables (a world of one here)
    joins by env:// and runs the body in this process: no spawn, no
    `launch`; the group is gone afterwards. Twice, as two entries of one
    process would."""
    monkeypatch.setattr(torch.multiprocessing, "spawn", pytest.fail)
    monkeypatch.setattr(mesh, "launch", pytest.fail)
    for k, v in dict(LAUNCHER, MASTER_PORT=str(mesh._free_port()), WORLD_SIZE="1", RANK="0",
                     LOCAL_RANK="0", LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    seen = []

    def body(a):
        x = torch.ones(2)
        torch.distributed.all_reduce(x)
        seen.append((mesh.distributed(), mesh.world(), mesh.rank(),
                     torch.distributed.get_backend(), x.tolist(), a.device))

    cli._run_ranks(body, _args())
    cli._run_ranks(body, _args())
    assert seen == [(True, 1, 0, "gloo", [1.0, 1.0], "cpu")] * 2
    assert not mesh.distributed()


def test_failed_join_raises_without_fallback(monkeypatch):
    """A join that fails raises out of the entry: the body never runs, in
    one process or in spawned ones."""
    monkeypatch.setattr(torch.multiprocessing, "spawn", pytest.fail)
    for k, v in dict(LAUNCHER, WORLD_SIZE="2", RANK="1", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)

    def refused(*args, **kwargs):
        raise RuntimeError("rendezvous refused")

    monkeypatch.setattr(torch.distributed, "rendezvous", refused)
    with pytest.raises(RuntimeError, match="rendezvous refused"):
        cli._run_ranks(pytest.fail, _args())
    assert not mesh.distributed()


def test_split_file_is_never_seen_half_written(tmp_path, monkeypatch):
    """splits_final.json (every rank computes the split; global rank 0 writes
    it) appears whole: written under a temporary name and renamed, so a rank
    on another node that reads it while rank 0 writes finds no file or all
    of it."""
    path = str(tmp_path / "splits_final.json")
    seen = []
    dump = json.dump

    def watching(obj, f, **kw):
        seen.append(os.path.exists(path))
        dump(obj, f, **kw)

    monkeypatch.setattr(json, "dump", watching)
    save_json([{"train": ["a"], "val": ["b"]}], path)
    assert seen == [False] and json.load(open(path)) == [{"train": ["a"], "val": ["b"]}]
    assert os.listdir(tmp_path) == ["splits_final.json"]
