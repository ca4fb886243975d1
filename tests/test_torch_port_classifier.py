"""Port parity: the downstream classifier (vqgan_tpu_torch/models/resnet.py,
eval/classifier.py, classifier_experiment.py, data/datasets.py's
ImageNet normalisation and SyntheticDataset) against the JAX package.

- ResNet (width 8, 32 px) in eval and train mode against flax, weights
  and BatchNorm statistics from a numpy seed carried over with
  `resnet_state_from_jax`; the running statistics after two train passes.
- A fresh port ResNet18's per-layer weight std against a fresh flax one
  (flax's lecun_normal: variance 1 / fan_in).
- Three `ClassifierExperiment` train steps on the same batches (the same
  `BatchLoader` seed) from the same initial weights: losses, parameters,
  BatchNorm statistics; `evaluate`'s report on the same weights;
  `run_multi_seed`'s aggregation.
- `load_image(imagenet_norm=True)`, `ImageFolderDataset(imagenet_norm=)`,
  `SyntheticDataset` and `pad_to_batch` against JAX's.
- `python -m vqgan_tpu_torch.classifier_experiment --device cpu`, with and
  without `--synthetic_folder`, and `--multi_seed`.
"""

import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from PIL import Image

from vqgan_tpu.data import datasets as jdatasets
from vqgan_tpu.eval import classifier as jclassifier
from vqgan_tpu.models.resnet import ResNet as JResNet
from vqgan_tpu_torch import classifier_experiment
from vqgan_tpu_torch.checkpoint import resnet_state_from_jax
from vqgan_tpu_torch.data import datasets
from vqgan_tpu_torch.eval import classifier
from vqgan_tpu_torch.models.resnet import ResNet, ResNet18

REPO = Path(__file__).resolve().parent.parent
torch.set_num_threads(2)

# fp32 forward through 17 conv layers with BatchNorm in other summation
# orders: logits, features and statistics to 1e-5 of the largest
FORWARD_RTOL = 1e-5
# Train mode normalises by the batch's statistics, and flax computes the
# variance as E[x^2] - E[x]^2 (`use_fast_variance`), the port in two
# passes: with batch 4 at 32 px the last stage normalises 4 values per
# channel, and both sides' train-mode logits lie some 1e-5 of the largest
# from an fp64 evaluation of the same network
# (`test_train_mode_forward_is_no_farther_from_fp64_than_jax` prints
# both distances at 64 px, batch 8). So train-mode logits to 1e-4 of the
# largest.
TRAIN_FORWARD_RTOL = 1e-4
# flax's lecun_normal and the port's, two random draws: each layer's std
# within 5% of the other's (the smallest layer here, fc, has 2048
# elements: the std of a sample std is ~1.6% of it)
INIT_STD_RTOL = 0.05
# The CE loss of three Adam steps, relative. Adam's first steps are
# sign-like (m / sqrt(v) is +-1 for a lone gradient): every one of the 11M
# parameters moves by about lr, so the train-mode differences above grow
# step by step, faster the larger lr. The three steps run at lr 1e-5, at
# 64 px and batch 8, where the losses hold this tolerance; at the
# harness's lr 1e-4 the trajectory is too sensitive to fp32 rounding, on
# either side, for it.
LOSS_RTOL = 1e-4
# Parameters after the three steps: an element whose gradient is rounding
# noise moves by about lr either way on either side, so the port's
# parameters differ from JAX's by at most 2% of JAX's move in norm, and
# by over lr / 2 in at most 0.1% of the elements.
MOVE_NORM_RTOL, MOVE_MISS_SHARE = 0.02, 1e-3
LR, SIZE, BATCH = 1e-5, 64, 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def random_resnet_variables(model, size, seed):
    """flax ResNet variables from a numpy seed: He-scaled kernels, BN
    scale near 1, small biases, running means near 0 and variances near
    1 (so eval mode normalises by something other than identity)."""
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)
    flat = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n *= np.sqrt(2.0 / np.prod(sds.shape[:-1]))
        elif path[-1] == "scale":
            n = 1.0 + 0.1 * n
        elif path[-1] in ("bias", "mean"):
            n *= 0.1
        elif path[-1] == "var":
            n = 1.0 + 0.2 * np.abs(n)
        flat[path] = n
    return unflatten_dict(flat)


def assert_rel(got, want, rtol, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=msg)


def port_stats(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if "running" in k}


@pytest.fixture(scope="module")
def small_resnet():
    jmodel = JResNet(stage_sizes=(2, 2, 2, 2), num_classes=5, width=8)
    variables = random_resnet_variables(jmodel, 32, seed=0)
    model = ResNet((2, 2, 2, 2), num_classes=5, width=8)
    model.load_state_dict(resnet_state_from_jax(variables))
    x = np.random.default_rng(1).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    return jmodel, variables, model, x


def test_resnet_eval_matches_flax(small_resnet):
    jmodel, variables, model, x = small_resnet
    want, want_feats = jmodel.apply(variables, jnp.asarray(x), train=False,
                                    return_features=True)
    model.eval()
    with torch.no_grad():
        got, feats = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                           return_features=True)
    assert got.shape == (4, 5) and feats.shape == (4, 64)
    assert_rel(got.numpy(), want, FORWARD_RTOL, "logits")
    assert_rel(feats.numpy(), want_feats, FORWARD_RTOL, "features")


def test_resnet_train_mode_and_running_stats_match_flax(small_resnet):
    jmodel, variables, model, x = small_resnet
    model = ResNet((2, 2, 2, 2), num_classes=5, width=8)
    model.load_state_dict(resnet_state_from_jax(variables))
    model.train()
    stats = variables["batch_stats"]
    for step in range(2):  # two train passes, on other inputs
        xs = x * (1 + step)
        want, upd = jmodel.apply({**variables, "batch_stats": stats},
                                 jnp.asarray(xs), train=True,
                                 mutable=["batch_stats"])
        stats = upd["batch_stats"]
        with torch.no_grad():
            got = model(torch.from_numpy(xs).permute(0, 3, 1, 2))
        assert_rel(got.numpy(), want, TRAIN_FORWARD_RTOL, f"logits {step}")
    want_state = resnet_state_from_jax(
        {"params": variables["params"], "batch_stats": _np(stats)})
    for key, value in port_stats(model).items():
        assert_rel(value, want_state[key].numpy(), FORWARD_RTOL, key)


def resnet_fp64(state, x, stage_sizes=(2, 2, 2, 2)):
    """The port's ResNet in train mode, evaluated in float64 from its
    state dict (x NCHW)."""
    st = {k: v.double() for k, v in state.items()}

    def bn(h, key):
        return torch.nn.functional.batch_norm(
            h, None, None, st[f"{key}.weight"], st[f"{key}.bias"],
            training=True, eps=1e-5)

    def conv(h, key, stride, pad):
        return torch.nn.functional.conv2d(h, st[f"{key}.weight"],
                                          stride=stride, padding=pad)

    relu = torch.nn.functional.relu
    h = relu(bn(conv(x.double(), "conv1", 2, 3), "bn1"))
    h = torch.nn.functional.max_pool2d(h, 3, 2, 1)
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            pre, stride = f"layer{i + 1}.{j}", 2 if i > 0 and j == 0 else 1
            y = relu(bn(conv(h, f"{pre}.conv1", stride, 1), f"{pre}.bn1"))
            y = bn(conv(y, f"{pre}.conv2", 1, 1), f"{pre}.bn2")
            if f"{pre}.downsample.0.weight" in st:
                h = bn(conv(h, f"{pre}.downsample.0", stride, 0),
                       f"{pre}.downsample.1")
            h = relu(y + h)
    return torch.nn.functional.linear(h.mean(dim=(2, 3)), st["fc.weight"],
                                      st["fc.bias"])


def test_train_mode_forward_is_no_farther_from_fp64_than_jax(capsys):
    """flax's one-pass BatchNorm variance against the port's two passes:
    both train-mode forwards held to an fp64 evaluation of the same
    network (64 px, batch 8), the port no farther from it than JAX."""
    jmodel = JResNet(stage_sizes=(2, 2, 2, 2), num_classes=5, width=8)
    variables = random_resnet_variables(jmodel, 64, seed=0)
    state = resnet_state_from_jax(variables)
    x = np.random.default_rng(1).standard_normal(
        (8, 64, 64, 3)).astype(np.float32)
    want, _ = jmodel.apply(variables, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    model = ResNet((2, 2, 2, 2), num_classes=5, width=8)
    model.load_state_dict(state)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model.train()(xt).numpy()
        exact = resnet_fp64(state, xt).numpy()
    size = np.abs(exact).max()
    jax_err = np.abs(np.asarray(want) - exact).max() / size
    port_err = np.abs(got - exact).max() / size
    with capsys.disabled():
        print(f"\ntrain-mode logits from fp64, share of the largest: JAX "
              f"{jax_err:.3e}, port {port_err:.3e}")
    assert port_err <= jax_err
    assert jax_err <= TRAIN_FORWARD_RTOL


@pytest.fixture(scope="module")
def experiments():
    """A JAX ClassifierExperiment (ResNet18, 4 classes, 64 px, batch 8)
    trained for one epoch of three steps on 26 zero-mean images (the
    classifier's inputs are ImageNet-normalised), and the port's from the
    same initial weights and the same batches."""
    rng = np.random.default_rng(2)
    n = 3 * BATCH + 2
    images = rng.standard_normal((n, SIZE, SIZE, 3)).astype(np.float32)
    items = [(images[i], i % 4) for i in range(n)]
    jexp = jclassifier.ClassifierExperiment(
        num_classes=4, lr=LR, epochs=1, batch_size=BATCH, seed=0,
        image_size=SIZE)
    initial = {"params": _np(jexp.params),
               "batch_stats": _np(jexp.batch_stats)}
    exp = classifier.ClassifierExperiment(
        num_classes=4, lr=LR, epochs=1, batch_size=BATCH, seed=0,
        device="cpu")
    exp.model.load_state_dict(resnet_state_from_jax(initial))

    loader = jdatasets.BatchLoader(items, BATCH, shuffle=True, seed=0,
                                   drop_last=True)
    jlosses = []
    for xb, yb in loader:  # the JAX harness's train() with its losses
        (jexp.params, jexp.batch_stats, jexp.opt_state, loss,
         _) = jexp._train_step(jexp.params, jexp.batch_stats,
                               jexp.opt_state, jnp.asarray(xb),
                               jnp.asarray(yb))
        jlosses.append(float(loss))
    exp.train(items, verbose=False)
    return dict(jexp=jexp, exp=exp, initial=initial, jlosses=jlosses,
                items=items)


def test_fresh_resnet18_init_std_matches_flax(experiments):
    flat = flatten_dict(experiments["initial"]["params"])
    fresh = ResNet18(4, generator=torch.Generator().manual_seed(5))
    state = fresh.state_dict()
    want = resnet_state_from_jax({"params": unflatten_dict(flat),
                                  "batch_stats": experiments["initial"][
                                      "batch_stats"]})
    n_checked = 0
    for key, value in want.items():
        ours = state[key].numpy()
        if key.endswith("weight") and ours.ndim > 1:
            fan_in = ours[0].size
            assert ours.std() == pytest.approx(value.numpy().std(),
                                               rel=INIT_STD_RTOL), key
            # lecun_normal: variance 1 / fan_in, truncated at 2 std
            assert np.abs(ours).max() <= 2.0001 / np.sqrt(fan_in) / .8796
            n_checked += 1
        else:  # biases 0, BN scales 1, running means 0, variances 1
            np.testing.assert_array_equal(ours, value.numpy(), err_msg=key)
    assert n_checked == 21  # 20 convolutions and the fc layer


def test_three_train_steps_match_jax(experiments):
    exp, jexp = experiments["exp"], experiments["jexp"]
    assert len(experiments["jlosses"]) == 3
    losses = exp.history[0]["losses"]
    np.testing.assert_allclose(losses, experiments["jlosses"],
                               rtol=LOSS_RTOL)
    assert exp.history[0]["images"] == 3 * BATCH
    assert exp.history[0]["seconds"] > 0
    want = resnet_state_from_jax({"params": _np(jexp.params),
                                  "batch_stats": _np(jexp.batch_stats)})
    start = resnet_state_from_jax(experiments["initial"])
    state = exp.model.state_dict()
    diff, move, miss, n = 0.0, 0.0, 0, 0
    for key, value in want.items():
        ours, theirs = state[key].numpy(), value.numpy()
        if "running" in key:  # the statistics of train-mode forwards
            assert_rel(ours, theirs, TRAIN_FORWARD_RTOL, key)
            continue
        diff += ((ours - theirs) ** 2).sum()
        move += ((theirs - start[key].numpy()) ** 2).sum()
        miss += int((np.abs(ours - theirs) > LR / 2).sum())
        n += ours.size
    assert move > 0
    assert np.sqrt(diff / move) <= MOVE_NORM_RTOL
    assert miss / n <= MOVE_MISS_SHARE


def test_evaluate_report_matches_jax(experiments):
    jexp = experiments["jexp"]
    exp = classifier.ClassifierExperiment(
        num_classes=4, batch_size=BATCH, seed=1, device="cpu")
    exp.model.load_state_dict(resnet_state_from_jax(
        {"params": _np(jexp.params), "batch_stats": _np(jexp.batch_stats)}))
    rng = np.random.default_rng(3)
    test_items = [(rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32),
                   i % 4) for i in range(18)]  # 3 batches, the last of 2
    got, want = exp.evaluate(test_items), jexp.evaluate(test_items)
    assert got["mean_confidence"] == pytest.approx(want["mean_confidence"],
                                                   rel=1e-5)
    for key in ("accuracy", "per_class_accuracy", "n_samples", "warnings"):
        assert got[key] == want[key], key
    assert got["n_samples"] == 18 and set(got["per_class_accuracy"]) == \
        {0, 1, 2, 3}


@pytest.mark.parametrize("conf,preds,warned", [
    ([0.5, 0.6, 0.7, 0.4], [0, 1, 1, 0], []),
    ([0.999, 0.995, 0.998, 0.999], [0, 1, 2, 3],
     ["mean confidence 0.998 suspiciously high — possible overfit"]),
    ([0.995, 0.999, 0.995, 0.999], [0, 1, 3, 2],
     ["mean confidence 0.997 suspiciously high — possible overfit",
      "wrong predictions still confident (0.997)"]),
    ([0.5, 0.95, 0.93, 0.5], [0, 2, 3, 3],
     ["wrong predictions still confident (0.940)"]),
])
def test_accuracy_report_warnings(conf, preds, warned):
    labels = np.array([0, 1, 2, 3])
    report = classifier.accuracy_report(np.array(preds), labels,
                                        np.array(conf))
    assert report["warnings"] == warned
    assert report["accuracy"] == np.mean(np.array(preds) == labels)


def test_run_multi_seed_aggregation_equals_jax(monkeypatch, tmp_path):
    accuracies = {6: 0.5, 42: 0.75, 888: 0.6}

    def fake(module):
        class Fake:
            def __init__(self, seed, **kwargs):
                self.seed = seed

            def train(self, dataset):
                return self

            def evaluate(self, dataset):
                return {"accuracy": accuracies[self.seed],
                        "n_samples": len(dataset)}

        monkeypatch.setattr(module, "ClassifierExperiment", Fake)

    fake(classifier)
    fake(jclassifier)
    got = classifier.run_multi_seed(lambda: [0] * 3, lambda: [0] * 5,
                                    output_path=str(tmp_path / "a.json"))
    want = jclassifier.run_multi_seed(lambda: [0] * 3, lambda: [0] * 5,
                                      output_path=str(tmp_path / "b.json"))
    assert got == want
    assert classifier.DEFAULT_SEEDS == jclassifier.DEFAULT_SEEDS == \
        (6, 42, 888)
    assert json.loads((tmp_path / "a.json").read_text()) == json.loads(
        (tmp_path / "b.json").read_text())
    assert got["mean"] == pytest.approx(np.mean(list(accuracies.values())))


# --- data ------------------------------------------------------------------


def write_users(root, counts, size=(40, 48), ext=".jpg", seed=4):
    rng = np.random.default_rng(seed)
    for user, n in counts.items():
        folder = root / f"ID_{user}"
        folder.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (*size, 3),
                                         dtype=np.uint8)).save(
                folder / f"img_{i:03d}{ext}")
        (folder / "notes.txt").write_text("not an image")
    return root


@pytest.mark.parametrize("imagenet_norm", [False, True])
@pytest.mark.parametrize("size", [(40, 48), (64, 30)])
def test_load_image_equals_jax(tmp_path, imagenet_norm, size):
    root = write_users(tmp_path, {1: 1}, size=size)
    path = root / "ID_1" / "img_000.jpg"
    got = datasets.load_image(path, 32, imagenet_norm)
    want = jdatasets.load_image(path, 32, imagenet_norm)
    assert got.dtype == np.float32 and got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_image_folder_dataset_imagenet_norm_equals_jax(tmp_path):
    root = write_users(tmp_path, {1: 3, 2: 2})
    split = {"users": {
        "ID_1": {"train_images": ["img_000.jpg"],
                 "class_train_images": ["img_001.jpg", "img_002.jpg"],
                 "test_images": ["img_000.jpg"]},
        "ID_2": {"train_images": ["img_000.jpg", "img_001.jpg"],
                 "test_images": []}}}
    for subset in ("class_train", "test"):
        got = datasets.ImageFolderDataset(root, split, subset, 32, True)
        want = jdatasets.ImageFolderDataset(root, split, subset, 32, True)
        assert got.items == want.items
        for i in range(len(got)):
            np.testing.assert_array_equal(got[i][0], want[i][0])
            assert got[i][1] == want[i][1]


@pytest.mark.parametrize("user_filter", [None, [0, 2], [5]])
def test_synthetic_dataset_equals_jax(tmp_path, user_filter):
    root = write_users(tmp_path, {1: 2, 3: 1})
    write_users(tmp_path, {3: 2}, ext=".png", seed=5)
    (tmp_path / "ID_7.txt").write_text("a file, not a folder")
    got = datasets.SyntheticDataset(tmp_path, 32, True, user_filter)
    want = jdatasets.SyntheticDataset(root, 32, True, user_filter)
    assert got.items == want.items
    assert len(got) == {None: 5, (0, 2): 5, (5,): 0}[
        None if user_filter is None else tuple(user_filter)]
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        assert got[i][1] == want[i][1]


@pytest.mark.parametrize("n,batch", [(3, 8), (8, 8), (9, 8)])
def test_pad_to_batch_equals_jax(n, batch):
    x = np.random.default_rng(0).random((n, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(datasets.pad_to_batch(x, batch),
                                  jdatasets.pad_to_batch(x, batch))


# --- the CLI ---------------------------------------------------------------


def _jax_cli():
    sys.path.insert(0, str(REPO / "cli"))
    try:
        import classifier_experiment as jcli
    finally:
        sys.path.pop(0)
    return jcli


def test_concat_equals_jax():
    parts = ([1, 2, 3], [], [4, 5])
    got, want = classifier_experiment._Concat(*parts), \
        _jax_cli()._Concat(*parts)
    assert len(got) == len(want) == 5
    assert [got[i] for i in range(5)] == [want[i] for i in range(5)]


@pytest.fixture
def classifier_data(tmp_path):
    root = write_users(tmp_path / "real", {1: 6, 2: 6, 3: 6})
    names = [f"img_{i:03d}.jpg" for i in range(6)]
    split = {"metadata": {}, "users": {
        f"ID_{u}": {"train_images": names[:4],
                    "class_train_images": names[:4],
                    "gen_train_images": [], "test_images": names[4:]}
        for u in (1, 2, 3)}}
    (tmp_path / "split.json").write_text(json.dumps(split))
    write_users(tmp_path / "synthetic", {1: 2, 3: 2})
    return tmp_path


@pytest.mark.parametrize("synthetic", [False, True])
def test_classifier_cli(classifier_data, synthetic, capsys):
    out = classifier_data / f"results_{synthetic}.json"
    argv = ["--device", "cpu", "--data_root",
            str(classifier_data / "real"), "--split",
            str(classifier_data / "split.json"), "--num_classes", "3",
            "--epochs", "2", "--batch_size", "2", "--image_size", "32",
            "--output", str(out)]
    if synthetic:
        argv += ["--synthetic_folder", str(classifier_data / "synthetic"),
                 "--user_filter", "0"]
    result = classifier_experiment.main(argv)
    printed = capsys.readouterr().out
    saved = json.loads(out.read_text())
    assert saved == json.loads(json.dumps(result["results"]))
    assert saved["n_samples"] == 6
    assert sorted(saved["per_class_accuracy"]) == ["0", "1", "2"]
    history = result["experiment"].history
    assert len(history) == 2
    # 12 real images (+ the 2 synthetic of ID_1: user_filter keeps label 0)
    n_train = 14 if synthetic else 12
    assert [h["images"] for h in history] == [n_train] * 2
    assert [len(h["losses"]) for h in history] == [n_train // 2] * 2
    assert all(np.isfinite(h["losses"]).all() for h in history)
    assert ("augmenting 12 real with 2 synthetic" in printed) == synthetic
    assert "test accuracy:" in printed and "ID_3:" in printed


def test_classifier_cli_multi_seed(classifier_data):
    out = classifier_data / "multi.json"
    result = classifier_experiment.main([
        "--device", "cpu", "--data_root", str(classifier_data / "real"),
        "--split", str(classifier_data / "split.json"), "--num_classes", "3",
        "--epochs", "1", "--batch_size", "4", "--image_size", "32",
        "--multi_seed", "--output", str(out)])
    saved = json.loads(out.read_text())
    assert saved["seeds"] == [6, 42, 888] and result["experiment"] is None
    assert len(saved["per_seed"]) == 3
    assert saved["mean"] == pytest.approx(np.mean(saved["accuracies"]))


def test_classifier_entry_point_raises_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        classifier_experiment.main(["--data_root", str(tmp_path),
                                    "--split", str(tmp_path / "s.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        classifier.ClassifierExperiment(num_classes=2)
