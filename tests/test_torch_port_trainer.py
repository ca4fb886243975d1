"""The port's training entry point and what it stands on, on the CPU.

- The split, the latent cache (`.npy`, a reference `.pt`, encode-on-miss)
  and the threaded BatchLoader against the JAX package's on one folder:
  the same items, latents, labels and batches.
- The checkpoint manager's round trip of a training state.
- `python -m vqgan_tpu_torch.train_latent_cfg --device cpu` on a tiny
  config: checkpoints on and off the save cadence, resume, the baseline
  config; then `python -m vqgan_tpu_torch.generate --checkpoint` reading it.
- The trainer's metrics log every `log_every` steps.
- Without `--device cpu` the training entry points raise when there is no
  GPU.
"""

import copy
import json

import numpy as np
import pytest
import torch
from PIL import Image

from vqgan_tpu.data import BatchLoader as JBatchLoader
from vqgan_tpu.data import LatentCache as JLatentCache
from vqgan_tpu.data import LatentDataset as JLatentDataset
from vqgan_tpu.data import load_split as j_load_split
from vqgan_tpu_torch.checkpoint import CheckpointManager, read_state_dict
from vqgan_tpu_torch.configs import LDMConfig
from vqgan_tpu_torch.data import (
    BatchLoader,
    LatentCache,
    LatentDataset,
    load_split,
    save_split,
)
from vqgan_tpu_torch.models import CFGUnet
from vqgan_tpu_torch.training import LDMTrainState, make_ldm_optimizer

torch.set_num_threads(2)

TINY = dict(dim=16, dim_mults=[1, 2], attn_heads=2, attn_dim_head=16,
            num_users=3, latent_size=4, image_size=32, timesteps=20,
            sampling_timesteps=3, images_per_user_train=5,
            save_and_sample_every=4, ema_update_every=2)


def write_data(root, n_per_user=7, missing=True):
    """A split of users ID_1..ID_3 (ID_2 with a GMM gen_train list), their
    [4, 4, 4] latents in the cache (one as a reference CHW `.pt`), and with
    `missing` one item missing from the cache with its image on disk."""
    rng = np.random.default_rng(0)
    cache = LatentCache(root / "cache")
    split = {"metadata": {}, "users": {}}
    for user in (1, 2, 3):
        names = [f"frame_{i:03d}.png" for i in range(n_per_user)]
        info = {"train_images": names, "test_images": []}
        if user == 2:
            info["gen_train_images"] = names[::2]
        split["users"][f"ID_{user}"] = info
        for name in names:
            cache.save(user - 1, name,
                       rng.standard_normal((4, 4, 4)).astype(np.float32))
    pt = cache.path(0, "frame_001.png")
    torch.save(torch.from_numpy(np.load(pt).transpose(2, 0, 1).copy()),
               pt.with_suffix(".pt"))
    pt.unlink()
    save_split(split, root / "split.json")
    if not missing:
        return root / "split.json"
    cache.path(2, "frame_006.png").unlink()
    (root / "images" / "ID_3").mkdir(parents=True)
    Image.fromarray(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)).save(
        root / "images" / "ID_3" / "frame_006.png")
    return root / "split.json"


def encode(images):
    """A stand-in encoder: [1, 32, 32, 3] images -> [1, 4, 4, 4]."""
    x = images[:, ::8, ::8, :]
    return np.concatenate([x, x[..., :1]], axis=-1).astype(np.float32)


def test_latent_data_matches_jax(tmp_path):
    split_path = write_data(tmp_path)
    split = load_split(split_path)
    assert split == j_load_split(split_path)
    # the per-user seeded choice of 5 of 7, ID_2 from its gen_train list
    kw = dict(image_size=32, images_per_user=5, seed=3)
    chosen = LatentDataset(tmp_path / "images", split,
                           LatentCache(tmp_path / "cache"), **kw).items
    assert chosen == JLatentDataset(tmp_path / "images", split,
                                    JLatentCache(tmp_path / "cache"),
                                    **kw).items
    assert len(chosen) == 5 + 4 + 5
    datasets = []
    for dataset_cls, cache_cls, sub in ((JLatentDataset, JLatentCache, "j"),
                                        (LatentDataset, LatentCache, "t")):
        # each side fills its own copy of the cache on the miss
        cache_dir = tmp_path / f"cache_{sub}"
        cache_dir.mkdir()
        for p in (tmp_path / "cache").iterdir():
            (cache_dir / p.name).write_bytes(p.read_bytes())
        datasets.append(dataset_cls(
            tmp_path / "images", load_split(split_path),
            cache_cls(cache_dir), image_size=32, encode_fn=encode))
    j_ds, t_ds = datasets
    assert t_ds.items == j_ds.items and len(t_ds) == 7 + 4 + 7
    assert not t_ds.cache.has(2, "frame_006.png")
    for i in range(len(t_ds)):
        (a, la), (b, lb) = t_ds[i], j_ds[i]
        assert la == lb
        np.testing.assert_array_equal(a, b)
    # the miss was encoded and stored; the `.pt` item stays a `.pt`
    assert t_ds.cache.has(2, "frame_006.png")
    assert not t_ds.fully_cached() and not j_ds.fully_cached()
    j_batches = list(JBatchLoader(j_ds, 4, seed=5))
    t_batches = list(BatchLoader(t_ds, 4, seed=5))
    assert len(t_batches) == len(j_batches) == len(t_ds) // 4
    for (a, la), (b, lb) in zip(t_batches, j_batches):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        assert a.dtype == np.float32 and la.dtype == np.int32


def test_missing_latent_without_an_encoder_raises(tmp_path):
    split_path = write_data(tmp_path)
    ds = LatentDataset(tmp_path / "images", load_split(split_path),
                       LatentCache(tmp_path / "cache"))
    with pytest.raises(FileNotFoundError):
        [ds[i] for i in range(len(ds))]
    with pytest.raises(FileNotFoundError):
        list(BatchLoader(ds, 2, shuffle=False))  # raised in the thread


def test_checkpoint_manager_round_trips_a_training_state(tmp_path):
    torch.manual_seed(0)
    net = CFGUnet(dim=8, num_classes=2, dim_mults=(1, 2), channels=4,
                  attn_heads=2, attn_dim_head=8)
    opt = make_ldm_optimizer(net.parameters(), gradient_accumulate_every=2)
    state = LDMTrainState(7, net, copy.deepcopy(net), opt)
    for p in net.parameters():
        p.grad = torch.randn_like(p)
    for _ in range(2):
        opt.step(opt.grads())
    ckpt = CheckpointManager(tmp_path, prefix="model")
    assert ckpt.latest_milestone() is None
    ckpt.save(1, state.state_dict(), config={"dim": 8})
    path = ckpt.save(3, state.state_dict(), config={"dim": 8, "seed": 1})
    assert path.name == "model-3.pt" and ckpt.all_milestones() == [1, 3]
    assert ckpt.latest_milestone() == 3 and ckpt.load_config() == {
        "dim": 8, "seed": 1}

    fresh = CFGUnet(dim=8, num_classes=2, dim_mults=(1, 2), channels=4,
                    attn_heads=2, attn_dim_head=8)
    other = LDMTrainState(0, fresh, copy.deepcopy(fresh),
                          make_ldm_optimizer(fresh.parameters(),
                                             gradient_accumulate_every=2))
    other.load_state_dict(ckpt.restore())
    assert other.step == 7 and other.optimizer.count == 1
    for a, b in ((other.model, net), (other.ema_model, state.ema_model)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    inner = other.optimizer.inner.state_dict()["state"]
    assert inner.keys() == opt.inner.state_dict()["state"].keys()
    # generation's loader prefers the EMA weights of a trainer checkpoint
    assert read_state_dict(path).keys() == net.state_dict().keys()

    (tmp_path / "model-9").mkdir()  # an Orbax milestone of the JAX package
    with pytest.raises(ValueError, match="Orbax"):
        ckpt.restore(9)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Six steps of the tiny config, then a resume to step nine."""
    from vqgan_tpu_torch import train_latent_cfg

    root = tmp_path_factory.mktemp("train")
    split_path = write_data(root, missing=False)
    config = root / "config.json"
    config.write_text(json.dumps(TINY))
    common = ["--device", "cpu", "--config", str(config), "--split",
              str(split_path), "--data_path", str(root / "images"),
              "--latents_cache_folder", str(root / "cache"),
              "--results_folder", str(root / "results"),
              "--train_batch_size", "4"]
    first = train_latent_cfg.main([*common, "--train_num_steps", "6"])
    saved = CheckpointManager(root / "results").restore()
    second = train_latent_cfg.main([*common, "--train_num_steps", "9",
                                    "--resume", "-1"])
    return root, first, saved, second


def test_train_entry_point_trains_saves_and_resumes(trained):
    root, first, saved, second = trained
    assert len(first["losses"]) == 6 and len(second["losses"]) == 3
    assert all(np.isfinite(first["losses"] + second["losses"]))
    assert first["timed_steps"] == 1 and first["latents_per_s"] > 0
    ckpt = CheckpointManager(root / "results")
    # step 4 on the save cadence, 6 and 9 off it (milestone = steps // 4 + 1)
    assert ckpt.all_milestones() == [1, 2, 3] and ckpt.latest_milestone() == 3
    assert saved["step"] == 6 and ckpt.restore(1)["step"] == 4
    assert ckpt.load_config(3)["dim_mults"] == [1, 2]
    trainer = second["trainer"]
    assert trainer.state.step == 9 and trainer.optimizer.count == 9
    assert trainer.model.training and not trainer.ema_model.training
    # the EMA was copied at step 4 (update_every 2 and the warm regime up to
    # step 100) and again at steps 6 and 8 after the resume
    ema = trainer.ema_model.state_dict()
    assert not all(torch.equal(ema[k], v)
                   for k, v in saved["ema"].items())
    # the trainer's default cadence (every 50 steps) logs none of the 9
    assert (root / "results" / "ldm.jsonl").read_text() == ""


def test_trainer_logs_metrics_every_log_every_steps(trained, tmp_path):
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

    root = trained[0]
    config = LDMConfig.from_dict({
        **TINY, "results_folder": str(tmp_path), "train_batch_size": 4,
        "latents_cache_folder": str(root / "cache")})
    trainer = LatentDiffusionTrainer(config, split_path=root / "split.json",
                                     device="cpu")
    result = trainer.train(num_steps=6, log_every=3)
    records = [json.loads(x)
               for x in (tmp_path / "ldm.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [3, 6]
    assert all({"loss", "diffusion_loss", "grad_norm"} <= r.keys()
               for r in records)
    assert records[1]["loss"] == pytest.approx(result["losses"][5])


def test_baseline_flag_turns_the_optimizations_off(trained, capsys):
    from vqgan_tpu_torch import train_latent_cfg

    root = trained[0]
    result = train_latent_cfg.main([
        "--baseline", "--device", "cpu", "--config",
        str(root / "config.json"), "--split", str(root / "split.json"),
        "--latents_cache_folder", str(root / "cache"), "--results_folder",
        str(root / "baseline"), "--train_batch_size", "4",
        "--train_num_steps", "2"])
    trainer = result["trainer"]
    assert isinstance(trainer.optimizer.inner, torch.optim.Adam)
    assert not isinstance(trainer.optimizer.inner, torch.optim.AdamW)
    assert trainer.optimizer.max_grad_norm is None
    assert "OFF  EMA" in capsys.readouterr().out


def test_generate_reads_the_trainer_checkpoint(trained, tmp_path):
    from vqgan_tpu_torch import generate

    root = trained[0]
    out = tmp_path / "generated"
    result = generate.main([
        "--checkpoint", str(root / "results"), "--milestone", "2",
        "--random_init", "--device", "cpu", "--output_dir", str(out),
        "--user_ids", "2", "--num_images", "2", "--batch_size", "2"])
    assert result["images"] == [out / "ID_2" / f"generated_{i:03d}.jpg"
                                for i in range(2)]
    # the milestone's EMA weights, in the U-Net of the milestone's config
    _, net = generate.load_model(
        LDMConfig.from_dict(TINY),
        CheckpointManager(root / "results").path(2), device="cpu")
    saved = CheckpointManager(root / "results").restore(2)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, saved["ema"][k], rtol=0, atol=0)
    with pytest.raises(SystemExit):
        generate.main(["--checkpoint", str(root / "results"),
                       "--unet_weights", "x.pt", "--random_init"])


def test_training_entry_points_default_to_gpu_and_raise_without_one(
        monkeypatch, tmp_path):
    from vqgan_tpu_torch import profile_train, train_latent_cfg
    from vqgan_tpu_torch.training.ldm_trainer import LatentDiffusionTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_latent_cfg.main(["--results_folder", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LatentDiffusionTrainer(LDMConfig(dim=16, dim_mults=(1, 2),
                                         results_folder=str(tmp_path)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_train.main([])
