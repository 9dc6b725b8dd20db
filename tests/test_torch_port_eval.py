"""bts_tpu_torch's evaluation against bts_tpu on the CPU: the 9 metrics
(numpy and torch), the best-metric tracker and best checkpoints, the
``bts_eval`` entry point, ``bts_main``'s online eval (its protocol with stub
predictions, and a real tiny model), and ``bts_main --do_online_eval``
through train -> best checkpoint -> ``bts_test`` -> ``bts_eval``.

Tolerances: the numpy metrics, ``bts_eval`` and the online-eval protocol are
float64 numpy on identical inputs in both packages, so they are held equal
(the protocol within 1e-6, as tests/test_cli.py holds its b4 against b1).
``compute_errors_torch`` holds rtol 1e-5 against ``compute_errors_jnp`` and
the numpy version (f32 sums).  A real model's online eval holds its
continuous metrics to rtol 1e-4 against JAX (the forwards agree to ~1e-6)
and d1-d3 to 2 pixels per image.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from bts_tpu.cli import bts_eval as j_bts_eval
from bts_tpu.config import parse_args as j_parse_args
from bts_tpu.evaluation import best as j_best
from bts_tpu.evaluation import metrics as j_metrics
from bts_tpu_torch.cli import bts_eval
from bts_tpu_torch.config import Config, parse_args
from bts_tpu_torch.evaluation import best, metrics
from test_torch_port_model import _one_torch_thread  # noqa: F401


def _depths(seed, n=4000):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 80.0, n)
    pred = gt * rng.uniform(0.6, 1.6, n)
    return gt, pred


def test_compute_errors_is_the_jax_packages():
    gt, pred = _depths(0)
    np.testing.assert_array_equal(metrics.compute_errors(gt, pred), j_metrics.compute_errors(gt, pred))
    assert metrics.METRIC_NAMES == j_metrics.METRIC_NAMES


def test_compute_errors_torch_matches_jnp_and_numpy():
    """Mask-weighted f32 on a (2, 32, 48) map with 60% valid pixels, against
    compute_errors_jnp on the same map and compute_errors on the subset."""
    rng = np.random.default_rng(1)
    gt, pred = (x.reshape(2, 32, 48).astype(np.float32) for x in _depths(1, 2 * 32 * 48))
    mask = rng.random(gt.shape) < 0.6
    gt[~mask] = 0.0  # invalid pixels hold no depth, as in a LiDAR map
    out = metrics.compute_errors_torch(torch.from_numpy(gt), torch.from_numpy(pred), torch.from_numpy(mask))
    assert out.shape == (9,) and out.dtype == torch.float32
    ref = np.asarray(j_metrics.compute_errors_jnp(jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(mask)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), metrics.compute_errors(gt[mask], pred[mask]), rtol=1e-5)


def _results(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0.05, 5.0, 6), rng.uniform(0.5, 1.0, 3)])


def test_best_tracker_matches_jax(tmp_path):
    """One sequence of evals (a non-finite value, ties, a deferred persist)
    gives the same improved lists and a byte-equal sidecar in both packages;
    a resumed tracker competes against the persisted bar; reset drops it."""
    seq = [_results(s) for s in range(4)]
    seq[1][0] = np.nan  # never an improvement
    seq[2] = seq[0].copy()  # a tie: strict </> does not improve
    seq[3][6] = np.inf
    dirs = {"port": tmp_path / "port", "jax": tmp_path / "jax"}
    for d in dirs.values():
        d.mkdir()
    trackers = {"port": best.BestTracker(str(dirs["port"])), "jax": j_best.BestTracker(str(dirs["jax"]))}
    for step, res in enumerate(seq):
        persist = step != 1
        improved = {k: t.update(step * 10, res, persist=persist) for k, t in trackers.items()}
        assert improved["port"] == improved["jax"], step
        if step == 0:
            assert improved["port"] == list(metrics.METRIC_NAMES)
        if not persist:
            for t in trackers.values():
                t.persist()
    sidecar = {k: (d / "best_eval.json").read_bytes() for k, d in dirs.items()}
    assert sidecar["port"] == sidecar["jax"]

    # resume: a new tracker reads the bar back and competes against it
    resumed = {"port": best.BestTracker(str(dirs["port"])), "jax": j_best.BestTracker(str(dirs["jax"]))}
    assert resumed["port"].best == json.loads(sidecar["port"])
    better = np.array([1e-3] * 6 + [0.0] * 3)  # every error lower, every accuracy lower
    improved = {k: t.update(50, better) for k, t in resumed.items()}
    assert improved["port"] == improved["jax"] == list(metrics.METRIC_NAMES[:6])
    assert (dirs["port"] / "best_eval.json").read_bytes() == (dirs["jax"] / "best_eval.json").read_bytes()

    for t in resumed.values():
        t.reset()
    assert resumed["port"].best == {} and not (dirs["port"] / "best_eval.json").exists()


def test_best_checkpoints_keep_weights_and_serve(tmp_path):
    """A later best replaces the earlier one; the file holds the weights and
    the step only, and bts_test.read_weights restores it."""
    from bts_tpu_torch.cli.bts_test import read_weights
    from bts_tpu_torch.models.bts import create_model
    from bts_tpu_torch.utils.weights import load_state_dict

    cfg = Config(encoder="mobilenetv2_bts", bts_size=128)
    model = create_model(cfg)
    ckpts = best.BestCheckpoints(str(tmp_path / "ckpt_best"))
    ckpts.save(["abs_rel", "d1"], 2, model)
    with torch.no_grad():
        model.decoder.conv1.bias.add_(1.0)
    ckpts.save(["abs_rel"], 5, model)
    assert sorted(os.listdir(tmp_path / "ckpt_best" / "abs_rel")) == ["5.pt"]
    assert sorted(os.listdir(tmp_path / "ckpt_best" / "d1")) == ["2.pt"]
    saved = torch.load(tmp_path / "ckpt_best" / "abs_rel" / "5.pt", weights_only=True)
    assert set(saved) == {"model", "step"}
    sd, step = read_weights(str(tmp_path / "ckpt_best" / "abs_rel"))
    assert step == 5 and all(v.device.type == "cpu" for v in sd.values())
    served = create_model(cfg.replace(seed=1))
    load_state_dict(served, sd)  # strict
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in served.state_dict().items())
    ckpts.reset()
    assert not (tmp_path / "ckpt_best").exists()


def _eval_tree(root, dataset, n, gt_hw, pred_hw=None, image_hw=None, seed=0):
    """``n`` samples under root: gt depth PNGs (~30% valid), and when
    ``pred_hw`` is given the predictions bts_test would write into
    root/pred/raw; when ``image_hw`` is given, the RGB frames."""
    rng = np.random.default_rng(seed)
    scale, max_depth = (256.0, 80.0) if dataset == "kitti" else (1000.0, 10.0)
    for sub in ("rgb", "gt", "pred/raw"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n):
        depth = rng.uniform(0.3, max_depth - 0.5, gt_hw) * (rng.random(gt_hw) < 0.3)
        Image.fromarray((depth * scale).astype(np.uint16)).save(root / "gt" / f"{i}.png")
        if image_hw is not None:
            img = rng.integers(0, 256, (*image_hw, 3), dtype=np.uint8)
            Image.fromarray(img).save(root / "rgb" / f"{i}.png")
        if pred_hw is not None:
            pred = rng.uniform(0.1, max_depth, pred_hw)
            Image.fromarray((pred * scale).astype(np.uint16)).save(root / "pred" / "raw" / f"rgb_{i}.png")
        lines.append(f"rgb/{i}.png gt/{i}.png {518.8579 if dataset == 'nyu' else 721.5377}")
    (root / "split.txt").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("dataset", ["kitti", "nyu"])
def test_bts_eval_matches_jax(tmp_path, dataset, capsys):
    """bts_eval's evaluate against the JAX package's on one split: KITTI
    375x1242 gt with 352x1216 KB-cropped predictions (garg crop, padded back
    to the full frame), NYU 480x640 (eigen crop); one prediction missing and
    one in the legacy basename layout.  Equal, float64 on both sides."""
    if dataset == "kitti":
        _eval_tree(tmp_path, "kitti", 4, (375, 1242), (352, 1216))
        extra = ["--do_kb_crop", "--max_depth_eval", "80"]
    else:
        _eval_tree(tmp_path, "nyu", 4, (480, 640), (480, 640))
        extra = ["--max_depth_eval", "10"]
    raw = tmp_path / "pred" / "raw"
    os.remove(raw / "rgb_3.png")
    os.replace(raw / "rgb_2.png", raw / "2.png")  # basename layout
    argv = ["--dataset", dataset, "--data_path", str(tmp_path), "--gt_path", str(tmp_path),
            "--filenames_file", str(tmp_path / "split.txt"), "--image_path", str(raw),
            "--min_depth_eval", "1e-3"] + extra
    cfg, jcfg = parse_args(argv, mode="eval"), j_parse_args(argv, mode="eval")
    assert (cfg.garg_crop, cfg.eigen_crop) == (dataset == "kitti", dataset == "nyu")
    port = bts_eval.evaluate(cfg)
    ref = j_bts_eval.evaluate(jcfg)
    np.testing.assert_array_equal(port, ref)
    assert "WARNING: 1 predictions missing" in capsys.readouterr().out
    assert bts_eval.main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-2].split() == list(metrics.METRIC_NAMES)
    np.testing.assert_allclose([float(v) for v in out[-1].split()], port, atol=5e-5)


def _stub_depth(images_uint8):
    """The stub prediction, a numpy function of the uint8 frames: 0.5 m plus
    the channel sum scaled into [0.5, 9.5] m."""
    return (0.5 + images_uint8.astype(np.float32).sum(-1) * np.float32(9.0 / 765.0)).astype(np.float32)


class _StubModel(torch.nn.Module):
    """Recovers the uint8 frames from the normalised NCHW input (exactly: the
    channel sum is rounded to an integer) and returns _stub_depth of them as
    the final output."""

    def forward(self, image, focal=None):
        from bts_tpu_torch.data.augment import IMAGENET_MEAN, IMAGENET_STD

        mean = torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1)
        std = torch.tensor(IMAGENET_STD).view(1, 3, 1, 1)
        rgb = torch.round((image * std + mean) * 255.0).permute(0, 2, 3, 1).numpy().astype(np.uint8)
        final = torch.from_numpy(_stub_depth(rgb))[:, None]
        return (None, None, None, None, final)


@pytest.mark.parametrize("dataset", ["nyu", "kitti"])
def test_online_eval_protocol_matches_jax(tmp_path, dataset):
    """The port's online_eval against the JAX package's on a 10-frame 64x96
    split, both fed the same predictions (JAX through an eval_step stub, the
    port through a model stub); b4 with its padded tail of 2 equals b1.
    KITTI without --do_kb_crop runs at batch 1 whatever the batch size."""
    from bts_tpu.cli.bts_main import online_eval as j_online_eval
    from bts_tpu.config import Config as JConfig
    from bts_tpu_torch.cli.bts_main import online_eval

    _eval_tree(tmp_path, dataset, 10, (64, 96), image_hw=(64, 96), seed=2)
    kw = dict(dataset=dataset, data_path_eval=str(tmp_path), gt_path_eval=str(tmp_path),
              filenames_file_eval=str(tmp_path / "split.txt"), min_depth_eval=1e-3,
              max_depth_eval=10.0 if dataset == "nyu" else 80.0,
              eigen_crop=dataset == "nyu", garg_crop=dataset == "kitti", batch_size=1)
    calls = []

    def eval_step(params, batch_stats, images, focals):
        calls.append(images.shape[0])
        return _stub_depth(np.asarray(images))

    class _State:
        params = batch_stats = None

    ref = j_online_eval(eval_step, _State, JConfig(**kw))
    stub = _StubModel()
    r1 = online_eval(stub, Config(**kw), "cpu")
    np.testing.assert_allclose(r1, ref, rtol=1e-6, atol=1e-7)
    r4 = online_eval(stub, Config(**kw).replace(batch_size=4), "cpu")
    np.testing.assert_allclose(r4, r1, rtol=1e-6, atol=1e-7)
    assert stub.training  # back in train mode
    calls.clear()
    j_online_eval(eval_step, _State, JConfig(**kw).replace(batch_size=4))
    assert calls == ([4, 4, 4] if dataset == "nyu" else [1] * 10)
    assert online_eval(stub, Config(**kw).replace(filenames_file_eval=""), "cpu") is None  # skipped


def test_online_eval_with_a_model_matches_jax(tmp_path):
    """A real tiny model (DenseNet, bts_size 128) on a 6-frame NYU 64x96
    split at b4: the port's online eval against the JAX package's on weights
    carried over by state_dict_from_jax."""
    import jax

    from bts_tpu.cli.bts_main import online_eval as j_online_eval
    from bts_tpu.config import Config as JConfig
    from bts_tpu.data.augment import eval_preprocess as j_eval_preprocess
    from bts_tpu_torch.cli.bts_main import online_eval
    from bts_tpu_torch.models.bts import BtsDecoder, BtsModel
    from bts_tpu_torch.models.encoders.densenet import DenseNet
    from bts_tpu_torch.utils import torch_converter as TC
    from bts_tpu_torch.utils import weights
    from test_torch_port_model import NF, TINY, _JTiny, _random_variables

    _eval_tree(tmp_path, "nyu", 6, (64, 96), image_hw=(64, 96), seed=3)
    kw = dict(dataset="nyu", data_path_eval=str(tmp_path), gt_path_eval=str(tmp_path),
              filenames_file_eval=str(tmp_path / "split.txt"), min_depth_eval=1e-3, max_depth_eval=10.0,
              eigen_crop=True, batch_size=4)
    jm = _JTiny("same")
    variables = _random_variables(jm, 7, jnp.zeros((1, 64, 96, 3)), None)
    forward = jax.jit(lambda v, x: jm.apply(v, j_eval_preprocess(x), None)[4][..., 0])

    class _State:
        params, batch_stats = variables["params"], variables["batch_stats"]

    ref = j_online_eval(lambda p, bs, x, f: forward({"params": p, "batch_stats": bs}, x), _State, JConfig(**kw))

    encoder = DenseNet(**TINY)
    model = BtsModel(encoder, BtsDecoder(encoder.channels, 80.0, NF))
    weights.load_state_dict(model, weights.state_dict_from_jax(
        variables, "densenet121_bts", NF, encoder_mapping=TC.densenet_mapping(TINY["block_config"])))
    port = online_eval(model, Config(**kw), "cpu")
    np.testing.assert_allclose(port[:6], ref[:6], rtol=1e-4)
    valid = min(int((np.array(Image.open(tmp_path / "gt" / f"{i}.png"))[45:471, 41:601] > 1).sum())
                for i in range(6))
    np.testing.assert_allclose(port[6:], ref[6:], rtol=0, atol=2 / valid)


def test_bts_main_online_eval_serves_its_best_checkpoint(tmp_path, capsys):
    """bts_main --do_online_eval on the CPU (mobilenetv2_bts, bts_size 128,
    NYU): the eval line, all nine metrics in best_eval.json and a best
    checkpoint per metric; bts_test serves ckpt_best/abs_rel and bts_eval
    scores its PNGs like the online eval did at that step, within the PNGs'
    1 mm quantisation; --retrain into the reused logdir resets the bar."""
    import shutil

    from bts_tpu_torch.cli import bts_main, bts_test

    train = tmp_path / "train"
    evald = tmp_path / "eval"
    _eval_tree(train, "nyu", 4, (480, 640), image_hw=(480, 640), seed=4)  # border-cropped in training
    _eval_tree(evald, "nyu", 3, (64, 96), image_hw=(64, 96), seed=5)
    common = ["--device", "cpu", "--dataset", "nyu", "--encoder", "mobilenetv2_bts", "--bts_size", "128",
              "--max_depth", "10", "--compute_dtype", "float32"]
    argv = common + ["--data_path", str(train), "--gt_path", str(train),
                     "--filenames_file", str(train / "split.txt"), "--input_height", "64",
                     "--input_width", "96", "--batch_size", "2", "--num_epochs", "1",
                     "--use_native_loader", "never", "--log_freq", "100", "--save_freq", "100",
                     "--log_directory", str(tmp_path / "runs"), "--model_name", "m",
                     "--do_online_eval", "--eval_freq", "1", "--data_path_eval", str(evald),
                     "--gt_path_eval", str(evald), "--filenames_file_eval", str(evald / "split.txt"),
                     "--max_depth_eval", "10"]
    assert bts_main.main(argv) == 0
    out = capsys.readouterr().out
    evals = [line for line in out.splitlines() if line.startswith("eval: ")]
    assert len(evals) == 2 and "new best @ step 1" in out
    logdir = tmp_path / "runs" / "m"
    bar = json.loads((logdir / "best_eval.json").read_text())
    assert set(bar) == set(metrics.METRIC_NAMES)
    assert all(os.listdir(logdir / "ckpt_best" / n) == [f"{bar[n]['step']}.pt"] for n in bar)

    # serve the abs_rel best and score its PNGs against that eval's line
    assert bts_test.main(common + ["--data_path", str(evald), "--filenames_file", str(evald / "split.txt"),
                                   "--use_native_loader", "never", "--out_path", str(tmp_path / "pred"),
                                   "--checkpoint_path", str(logdir / "ckpt_best" / "abs_rel")]) == 0
    assert f"@ step {bar['abs_rel']['step']}" in capsys.readouterr().out
    scored = bts_eval.evaluate(parse_args(common + [
        "--data_path", str(evald), "--gt_path", str(evald), "--filenames_file", str(evald / "split.txt"),
        "--image_path", str(tmp_path / "pred" / "raw"), "--max_depth_eval", "10"], mode="eval"))
    online = dict(kv.split("=") for kv in evals[bar["abs_rel"]["step"] - 1][len("eval: "):].split())
    # the PNGs round depth to 1 mm, at most 1e-3 of a depth >= 0.5 m: 5e-3 of
    # each continuous metric, and d1-d3 within 2 pixels per image (the eigen
    # crop leaves >= 250 valid pixels of a 64x96 frame here); the printed
    # line has 4 decimals
    for name, value in zip(metrics.METRIC_NAMES, scored):
        tol = 5e-3 * abs(value) if name not in ("d1", "d2", "d3") else 2 / 250
        assert abs(value - float(online[name])) <= tol + 1e-4, (name, value, online[name])

    shutil.copytree(logdir / "ckpt", tmp_path / "src_ckpt")
    assert bts_main.main(argv + ["--retrain", "--checkpoint_path", str(tmp_path / "src_ckpt")]) == 0
    out = capsys.readouterr().out
    assert "retrain: reset stale best-metric bar" in out and "new best @ step 1" in out
    assert set(json.loads((logdir / "best_eval.json").read_text())) == set(metrics.METRIC_NAMES)
