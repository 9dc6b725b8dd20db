"""bts_tpu_torch's data-parallel training on the CPU: real processes under a
gloo group, each with one intra-op thread, against the one-process step on
the same global batch.

The rule is the JAX package's (tests/test_multiprocess.py, tests/test_zero.py):
a step at world size N on a global batch B equals the world-size-1 step on B.
Here world 2 at global b4 (2 x b2) against world 1 at b4, two steps, with
the augmentation on (rotation, crops, flips, jitter) so the draws are shared
too.  The two differ only in the order of f32 sums (BatchNorm's moments and
the silog sums are all-reduced, DDP averages the gradients), about 1e-6 of
each activation.  Tolerances: the loss of each step rtol 1e-5; every
parameter and BatchNorm buffer 1e-6 absolute after the first step; after the
second, 1e-6 or, where larger, twice the distance the world-1 steps move
that tensor's update when the initial weights move by 4e-6 (relative, random
signs; the larger of two such probes).  Why the second step needs the probe:
the f32 gradient is not continuous.  A ReLU whose input sits within ~1e-6 of
zero flips its mask under a 1e-6 change of that input, which moves the
gradient of every tensor upstream by a few per cent (found at bts_size 64,
64x96: one pre-activation of denseblock3.denselayer2.norm2 at +1.4e-6 in
one run and -7.0e-7 in the other, 2.5% of the encoder's gradient, 2.7e-5 of
a weight after AdamW), and the world-1 steps move that much under the probe
too (tests/test_torch_port_train.py::_assert_step_matches holds the
JAX-versus-port gradient by the same kind of rule).  The world-1 step itself
is held against bts_tpu in tests/test_torch_port_train.py.

The model is a tiny DenseNet (growth 8, blocks 1-1-2-1) under the BTS
decoder at bts_size 64; bts_main runs densenet121_bts at bts_size 64.
"""

import datetime
import json
import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from PIL import Image

from bts_tpu_torch.config import Config
from bts_tpu_torch.data import augment
from bts_tpu_torch.evaluation.metrics import METRIC_NAMES
from bts_tpu_torch.models.bts import BtsDecoder, BtsModel, init_weights
from bts_tpu_torch.models.encoders.densenet import DenseNet
from bts_tpu_torch.parallel import distributed as parallel
from bts_tpu_torch.training.optimizer import state_bytes
from bts_tpu_torch.training.trainer import Trainer, step_generator
from bts_tpu_torch.utils.checkpoint import CheckpointManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(growth_rate=8, block_config=(1, 1, 2, 1), num_init_features=16)
GLOBAL_B, STEPS = 4, 2
CASES = {
    "plain": {},
    "remat": dict(remat=True, remat_policy="layer"),
    "grad_accum": dict(grad_accum_steps=2),
    "zero": dict(shard_opt_state=True),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, as in the spawned ranks (see test_torch_port_model.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _config(**kw) -> Config:
    base = dict(mode="train", encoder="densenet121_bts", bts_size=64, dataset="kitti", max_depth=80.0,
                input_height=64, input_width=96, batch_size=GLOBAL_B, compute_dtype="float32",
                do_random_rotate=True, degree=1.0, seed=3, device="cpu")
    base.update(kw)
    return Config(**base)


def _model(cfg) -> BtsModel:
    encoder = DenseNet(remat=cfg.remat, remat_policy=cfg.remat_policy, **TINY)
    model = BtsModel(encoder, BtsDecoder(encoder.channels, cfg.max_depth, cfg.bts_size))
    return init_weights(model, torch.Generator().manual_seed(cfg.seed))


def _batch(seed=5, b=GLOBAL_B, h=80, w=112) -> dict:
    """uint8 frames, LiDAR-like depth (~30% of pixels in [1, 80) m), focal."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(1.0, 80.0, (b, h, w)).astype(np.float32)
    depth[rng.random((b, h, w)) >= 0.3] = 0.0
    return {"image": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8), "depth": depth,
            "focal": np.linspace(700.0, 725.0, b).astype(np.float32)}


def _join_group(rank, world, port) -> None:
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))


def _steps(trainer, cfg, rank, world, steps) -> list:
    rows = parallel.rank_rows(cfg.batch_size, cfg.grad_accum_steps, rank, world)
    local = {k: v[rows] for k, v in _batch().items()}
    return [float(trainer.train_step(local)["loss"]) for _ in range(steps)]


def _snapshot(trainer) -> dict:
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _train_rank(rank, world, port, cfg_kw, out, ckpt_dir):
    """One rank: two steps, then (``ckpt_dir``) a checkpoint and a third
    step; writes its losses, the model state after each step, the trainer's
    state and its optimizer bytes to ``out``.<rank>."""
    _join_group(rank, world, port)
    try:
        cfg = _config(**cfg_kw)
        trainer = Trainer(_model(cfg), cfg, total_steps=10, device="cpu")
        losses, states = [], []
        for _ in range(STEPS):
            losses += _steps(trainer, cfg, rank, world, 1)
            states.append(_snapshot(trainer))
        if ckpt_dir:
            trainer.save(CheckpointManager(ckpt_dir), trainer.step)
            losses += _steps(trainer, cfg, rank, world, 1)
        torch.save({"losses": losses, "states": states, "state": trainer.state_dict(),
                    "opt_bytes": state_bytes(trainer.optimizer), "ddp": trainer.ddp is not None},
                   f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, *args):
    mp.spawn(fn, args=(world, _free_port(), *args), nprocs=world, join=True)


def _world1(cfg, perturb_seed=None):
    """World-1 steps on the whole batch: the trainer, the losses and the model
    state after each step; ``perturb_seed``: every initial weight first moved
    by 4e-6 (relative, random signs from that seed)."""
    model = _model(cfg)
    if perturb_seed is not None:
        gen = torch.Generator().manual_seed(perturb_seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + 4e-6 * (torch.randint(0, 2, p.shape, generator=gen) * 2 - 1))
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, cfg, total_steps=10, device="cpu")
    losses, states = [], []
    for _ in range(STEPS):
        losses.append(float(trainer.train_step(_batch())["loss"]))
        states.append(_snapshot(trainer))
    return trainer, losses, [initial] + states


def _assert_steps_match(rank: dict, cfg, ref_losses, ref_states):
    """The module docstring's rule: losses; every tensor after step 1;
    every tensor after step 2, against the probes' movement."""
    np.testing.assert_allclose(rank["losses"][:STEPS], ref_losses, rtol=1e-5)
    first, last = rank["states"]
    assert first.keys() == ref_states[1].keys()
    for k, v in ref_states[1].items():
        np.testing.assert_allclose(first[k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)
    probes = [_world1(cfg, seed)[2] for seed in (0, 1)]
    for k, v in ref_states[2].items():
        update = v - ref_states[0][k]
        moved = max((p[2][k] - p[0][k] - update).abs().max().item() for p in probes)
        gap = (last[k] - v).abs().max().item()
        assert gap <= max(1e-6, 2 * moved), (k, gap, moved)


@pytest.mark.parametrize("case", sorted(CASES))
def test_world2_step_equals_world1(case, tmp_path):
    """Two steps at world 2 on a global b4 against the one-process steps on
    the same b4: with remat (BatchNorm's all-reduces re-run in the
    recompute), with two microbatches (rank r's microbatch i is its share of
    global microbatch i, DDP's no_sync on the first) and under ZeRO-1, where
    each rank holds about half of AdamW's moments."""
    cfg = _config(**CASES[case])
    _spawn(_train_rank, 2, CASES[case], str(tmp_path / "out"), "")
    ranks = [torch.load(tmp_path / f"out.{r}", weights_only=False) for r in range(2)]
    trainer, losses, states = _world1(cfg)
    for r in ranks:
        assert r["ddp"]
        _assert_steps_match(r, cfg, losses, states)
    total = state_bytes(trainer.optimizer)
    if case == "zero":
        assert ranks[0]["opt_bytes"] + ranks[1]["opt_bytes"] == total
        assert all(0.3 * total < r["opt_bytes"] < 0.7 * total for r in ranks), [r["opt_bytes"] for r in ranks]
    else:
        assert all(r["opt_bytes"] == total for r in ranks)


def test_ddp_at_world1_equals_the_unwrapped_step(tmp_path):
    """A group of one: the model runs inside DistributedDataParallel, with
    BatchNorm and silog local, and the steps are the unwrapped ones, equal
    bit for bit (DDP averages over one rank)."""
    _spawn(_train_rank, 1, {}, str(tmp_path / "out"), "")
    r = torch.load(tmp_path / "out.0", weights_only=False)
    trainer, losses, states = _world1(_config())
    assert r["ddp"] and trainer.ddp is None
    assert r["losses"] == losses
    assert all(torch.equal(r["states"][-1][k], v) for k, v in states[-1].items())


def test_zero_checkpoint_restores_at_world1(tmp_path):
    """A ZeRO-1 checkpoint saved at world 2 (rank 0 gathers and writes the
    whole state) restores at world 1 into plain AdamW exactly, and the third
    step there equals world 2's third step."""
    ckpt = CheckpointManager(tmp_path / "ckpt")
    _spawn(_train_rank, 2, {"shard_opt_state": True}, str(tmp_path / "out"), ckpt.directory)
    assert ckpt.steps() == [STEPS]
    saved = ckpt.restore()
    cfg = _config()
    trainer = Trainer(_model(cfg), cfg, total_steps=10, device="cpu")
    trainer.load_state_dict(saved)
    restored = trainer.state_dict()
    assert restored["step"] == STEPS and restored["scheduler"] == saved["scheduler"]
    assert all(torch.equal(restored["model"][k], v) for k, v in saved["model"].items())
    opt, ref = restored["optimizer"], saved["optimizer"]
    assert opt["param_groups"] == ref["param_groups"] and opt["state"].keys() == ref["state"].keys()
    assert all(torch.equal(opt["state"][i][k], v) for i, s in ref["state"].items() for k, v in s.items())
    loss = float(trainer.train_step(_batch())["loss"])
    r0 = torch.load(tmp_path / "out.0", weights_only=False)
    np.testing.assert_allclose(loss, r0["losses"][-1], rtol=1e-5)
    for k, v in trainer.model.state_dict().items():
        np.testing.assert_allclose(r0["state"]["model"][k].numpy(), v.numpy(), rtol=0, atol=1e-6, err_msg=k)


def test_rank_rows_split_each_global_microbatch():
    """Rank r's microbatch i is its contiguous share of global microbatch i."""
    rows = [parallel.rank_rows(8, 2, r, 2) for r in range(2)]
    assert rows == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert parallel.rank_rows(8, 1, 1, 4) == [2, 3]
    with pytest.raises(ValueError, match="not divisible"):
        parallel.rank_rows(6, 2, 0, 2)


def test_augment_share_keeps_the_global_draws():
    """Each rank draws for the whole batch and keeps its rows, so the two
    halves augment as the whole batch does."""
    b = _batch(seed=9)
    images, depths = torch.from_numpy(b["image"]), torch.from_numpy(b["depth"])
    kw = dict(out_h=64, out_w=96, do_random_rotate=True)
    whole = augment.augment_batch(images, depths, step_generator(3, 1), **kw)
    for r in range(2):
        sl = slice(2 * r, 2 * r + 2)
        part = augment.augment_batch(images[sl], depths[sl], step_generator(3, 1), share=(r, 2), **kw)
        assert torch.equal(part[0], whole[0][sl]) and torch.equal(part[1], whole[1][sl])


def _png_tree(root, n, h=80, w=112):
    rng = np.random.default_rng(16)
    (root / "rgb").mkdir(parents=True)
    (root / "gt").mkdir()
    lines = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(root / "rgb" / f"{i}.png")
        depth = rng.uniform(1.0, 60.0, (h, w)) * (rng.random((h, w)) < 0.3)
        Image.fromarray((depth * 256.0).astype(np.uint16)).save(root / "gt" / f"{i}.png")
        lines.append(f"rgb/{i}.png gt/{i}.png {700.0 + i}")
    (root / "split.txt").write_text("\n".join(lines) + "\n")
    return root


def test_loader_gives_each_rank_its_rows(tmp_path, monkeypatch):
    """The PNG loader at world 2 with two microbatches: rank r's batch is
    the rows rank_rows names of the one-process batch."""
    from bts_tpu_torch.data.dataloader import BtsDataLoader

    root = _png_tree(tmp_path, 8)
    cfg = _config(data_path=str(root), gt_path=str(root), filenames_file=str(root / "split.txt"),
                  batch_size=4, grad_accum_steps=2, use_native_loader="never", dataloader_workers=1)
    whole = list(BtsDataLoader(cfg, "train").batches(num_epochs=1, start_step=1))
    monkeypatch.setattr(parallel, "world", lambda: 2)
    for r in range(2):
        monkeypatch.setattr(parallel, "rank", lambda r=r: r)
        part = list(BtsDataLoader(cfg, "train").batches(num_epochs=1, start_step=1))
        rows = parallel.rank_rows(4, 2, r, 2)
        assert len(part) == len(whole) == 1
        for k in whole[0]:
            np.testing.assert_array_equal(part[0][k], whole[0][k][rows])


def _main_argv(root, logdir, *extra):
    return ["--device", "cpu", "--encoder", "densenet121_bts", "--bts_size", "64", "--input_height", "64",
            "--input_width", "96", "--compute_dtype", "float32", "--dataset", "kitti", "--batch_size", "2",
            "--data_path", str(root), "--gt_path", str(root), "--filenames_file", str(root / "split.txt"),
            "--use_native_loader", "never", "--dataloader_workers", "1", "--log_directory", str(logdir),
            "--model_name", "m", "--log_freq", "100", "--save_freq", "100", *extra]


def _preempted_rank(rank, world, port, argv):
    """bts_main at world 2; rank 1 sends itself SIGTERM after step 1."""
    from bts_tpu_torch.cli import bts_main

    _join_group(rank, world, port)
    step = Trainer.train_step

    def train_step(self, batch):
        metrics = step(self, batch)
        if rank == 1 and self.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return metrics

    Trainer.train_step = train_step
    try:
        assert bts_main.main(argv) == 0
    finally:
        dist.destroy_process_group()


def test_sigterm_to_one_rank_stops_both_and_resumes(tmp_path, capsys):
    """--preempt_sync_freq 2: rank 1 alone gets SIGTERM after step 1, both
    ranks break after step 2 (the OR is taken at even steps), one checkpoint
    is written, and a rerun at world 1 resumes at step 2 and finishes."""
    root = _png_tree(tmp_path / "data", 4)
    argv = _main_argv(root, tmp_path / "runs", "--num_epochs", "2", "--preempt_sync_freq", "2")
    _spawn(_preempted_rank, 2, argv)
    ckpt = CheckpointManager(tmp_path / "runs" / "m" / "ckpt")
    assert ckpt.steps() == [2]
    from bts_tpu_torch.cli import bts_main

    assert bts_main.main(argv) == 0
    out = capsys.readouterr().out
    assert "resumed @ step 2" in out and "done at step 4" in out
    assert ckpt.latest_step() == 4


def test_configured_rendezvous_that_fails_raises(monkeypatch):
    """torchrun's environment names a group whose master nobody runs: the
    rendezvous times out and raises; no one-process fallback."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("BTS_DIST_INIT_TIMEOUT", "2")
    with pytest.raises(RuntimeError, match="Refusing to fall back"):
        parallel.maybe_init_distributed(_config())
    assert not parallel.initialized()


def test_num_devices_must_be_the_world_size():
    with pytest.raises(SystemExit, match="torch.distributed.run --nproc_per_node 2"):
        parallel.maybe_init_distributed(_config(num_devices=2))
    assert parallel.maybe_init_distributed(_config(num_devices=1)) is False


def test_bts_main_under_torchrun_trains_and_serves(tmp_path, capsys):
    """bts_main under torchrun, two gloo ranks with ZeRO-1: it trains two
    steps with an online eval at step 2, rank 0 alone logs and writes one
    checkpoint and the best-metric sidecar, whose metrics are the world-1
    online eval of that checkpoint (rtol 1e-5), and bts_test serves it."""
    from bts_tpu_torch.cli import bts_main, bts_test
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.utils.weights import load_state_dict

    root = _png_tree(tmp_path / "data", 4)
    evalroot = _png_tree(tmp_path / "eval", 2, 64, 96)  # KITTI eval forwards the whole frame
    eval_args = ["--do_online_eval", "--eval_freq", "2", "--data_path_eval", str(evalroot),
                 "--gt_path_eval", str(evalroot), "--filenames_file_eval", str(evalroot / "split.txt")]
    argv = _main_argv(root, tmp_path / "runs", "--num_epochs", "1", "--num_devices", "2", "--shard_opt_state",
                      *eval_args)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "bts_tpu_torch.cli.bts_main", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("done at step 2") == proc.stdout.count("eval: silog=") == 1, proc.stdout
    assert "rank 1 of 2, gloo" in proc.stdout
    ckpt = CheckpointManager(tmp_path / "runs" / "m" / "ckpt")
    assert ckpt.steps() == [2]
    best = json.loads((tmp_path / "runs" / "m" / "best_eval.json").read_text())
    cfg = bts_main.parse_args(argv, mode="train")
    model = create_model(cfg, "cpu")
    load_state_dict(model, ckpt.restore()["model"])
    ref = bts_main.online_eval(model, cfg, "cpu")
    np.testing.assert_allclose([best[n]["value"] for n in METRIC_NAMES], ref, rtol=1e-5)

    (tmp_path / "test.txt").write_text("rgb/0.png None 700.0\n")
    assert bts_test.main(["--device", "cpu", "--encoder", "densenet121_bts", "--bts_size", "64",
                          "--compute_dtype", "float32", "--dataset", "kitti", "--data_path", str(evalroot),
                          "--filenames_file", str(tmp_path / "test.txt"), "--use_native_loader", "never",
                          "--checkpoint_path", str(ckpt.directory), "--out_path", str(tmp_path / "pred")]) == 0
    assert f"restored {ckpt.directory} @ step 2" in capsys.readouterr().out
    assert (tmp_path / "pred" / "raw" / "rgb_0.png").exists()
