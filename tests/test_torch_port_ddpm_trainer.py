"""The port's unconditional DDPM trainer and its CLI
(vqgan_tpu_torch/training/ddpm_trainer.py, vqgan_tpu_torch/train_ddpm.py)
end to end on the CPU, on a folder of seeded JPGs, and its flags against
the JAX CLI's (cli/train_ddpm.py).

- `train_ddpm --device cpu` at a tiny size: loss per step, a grid and a
  checkpoint per milestone, a resume from the latest at the right step.
- `--calculate_fid --save_best_and_latest_only`: only milestones 0
  ("best") and 1 ("latest") are kept, with their tags and the FID; a
  resume reads "latest".
- `--self_condition --immiscible` drive the loss's extra branches.
- Every flag and default is the JAX CLI's (read from its source), plus
  `--device`.
- A failed sample grid stops the run (the JAX trainer prints a warning and
  goes on).
- Adam without weight decay, clipping at 1.0, and the EMA: a copy of the
  online weights every 10 steps up to step 100.
- `dataset=` trains an ElucidatedDiffusion over a KarrasUnet as well.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from vqgan_tpu_torch import train_ddpm
from vqgan_tpu_torch.diffusion import ElucidatedDiffusion, GaussianDiffusion
from vqgan_tpu_torch.models import KarrasUnet, Unet
from vqgan_tpu_torch.training.ddpm_trainer import FolderDataset, Trainer

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--image_size", "16", "--dim", "8",
        "--dim_mults", "1", "2", "--timesteps", "20",
        "--sampling_timesteps", "3", "--train_batch_size", "4",
        "--num_samples", "4", "--save_and_sample_every", "2"]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i in range(10):
        sub = root / f"ID_{i % 2 + 1}"
        sub.mkdir(exist_ok=True)
        img = (rng.random((20, 24, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(sub / f"{i}.jpg")
    (root / "notes.txt").write_text("not an image")
    return root


def run(folder, results, *extra):
    return train_ddpm.main([*TINY, "--folder", str(folder),
                            "--results_folder", str(results), *extra])


def test_folder_dataset(folder):
    ds = FolderDataset(folder, 16)
    assert len(ds) == 10 and ds.paths == sorted(ds.paths)
    img, label = ds[3]
    assert img.shape == (16, 16, 3) and img.dtype == np.float32
    assert label == 0 and 0.0 <= img.min() and img.max() <= 1.0
    with pytest.raises(ValueError):
        FolderDataset(folder / "missing", 16)


def test_train_sample_checkpoint_and_resume(folder, tmp_path):
    res = tmp_path / "res"
    first = run(folder, res, "--train_num_steps", "4")
    trainer = first["trainer"]
    assert len(first["losses"]) == 4 and np.isfinite(first["losses"]).all()
    assert trainer.state.step == 4
    assert trainer.ckpt.all_milestones() == [1, 2]
    for m in (1, 2):
        grid = np.asarray(Image.open(res / f"sample-{m}.png"))
        assert grid.shape == (32, 32, 3)  # 2 x 2 samples of 16 px
    assert next(trainer.model.parameters()).dtype == torch.float32
    assert trainer.model.dtype == torch.bfloat16  # the CLI's bf16 U-Net

    second = run(folder, res, "--train_num_steps", "6", "--resume", "-1")
    assert second["trainer"].state.step == 6
    assert len(second["losses"]) == 2
    assert second["trainer"].ckpt.all_milestones() == [1, 2, 3]
    saved = torch.load(res / "model-3.pt", weights_only=True)
    assert saved["step"] == 6 and saved["optimizer"]["count"] == 6
    # the resumed run started from milestone 2's weights and moments
    assert second["trainer"].optimizer.count == 6


def test_fid_keeps_best_and_latest_only(folder, tmp_path):
    res = tmp_path / "res"
    out = run(folder, res, "--train_num_steps", "4", "--self_condition",
              "--immiscible", "--calculate_fid", "--num_fid_samples", "4",
              "--save_best_and_latest_only")
    trainer = out["trainer"]
    assert trainer.diffusion.self_condition and trainer.diffusion.immiscible
    assert np.isfinite(out["losses"]).all()
    assert np.isfinite(trainer.last_fid) and trainer.last_fid >= 0.0
    assert trainer.ckpt.all_milestones() == [0, 1]
    assert json.loads((res / "model-1.config.json").read_text()) == {
        "tag": "latest"}
    best = json.loads((res / "model-0.config.json").read_text())
    assert best["tag"] == "best" and best["fid"] == trainer.best_fid
    assert (res / "dataset_stats.npz").exists()
    assert (res / "sample-2.png").exists()
    again = run(folder, res, "--train_num_steps", "5", "--resume", "-1",
                "--self_condition", "--immiscible")
    assert again["trainer"].state.step == 5 and len(again["losses"]) == 1


def _jax_cli_defaults():
    """{flag: default} of cli/train_ddpm.py's parser, read from its
    source."""
    tree = ast.parse((REPO / "cli" / "train_ddpm.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            flag = node.args[0].value.lstrip("-")
            kw = {k.arg: k.value for k in node.keywords}
            if "default" in kw:
                out[flag] = ast.literal_eval(kw["default"])
            elif getattr(kw.get("action"), "value", "") == "store_true":
                out[flag] = False
            else:
                out[flag] = None
    return out


def test_flags_and_defaults_are_the_jax_clis():
    want = _jax_cli_defaults()
    got = vars(train_ddpm.parse_args(["--folder", "x"]))
    assert got.pop("device") == "cuda"
    want["folder"] = "x"
    assert got == want
    assert got["image_size"] == 128 and got["sampling_timesteps"] == 250 \
        and got["objective"] == "pred_v" and got["beta_schedule"] == \
        "sigmoid" and got["dim_mults"] == [1, 2, 4, 8]


def test_sampling_error_reaches_the_caller(folder, tmp_path):
    torch.manual_seed(0)
    model = Unet(dim=8, dim_mults=(1, 2))
    diffusion = GaussianDiffusion(model, image_size=16, timesteps=20,
                                  sampling_timesteps=3, device="cpu")
    trainer = Trainer(diffusion, model, str(folder), train_batch_size=4,
                      train_num_steps=2, save_and_sample_every=2,
                      num_samples=4, results_folder=str(tmp_path))

    def broken(**kw):
        raise RuntimeError("kernel failed to launch")

    trainer.ema_diffusion.sample = broken
    with pytest.raises(RuntimeError, match="kernel failed to launch"):
        trainer.train()
    assert trainer.ckpt.all_milestones() == []


def test_optimizer_and_ema(folder, tmp_path):
    torch.manual_seed(0)
    model = Unet(dim=8, dim_mults=(1, 2))
    diffusion = GaussianDiffusion(model, image_size=16, timesteps=20,
                                  sampling_timesteps=3, device="cpu")
    trainer = Trainer(diffusion, model, str(folder), train_batch_size=4,
                      train_num_steps=12, save_and_sample_every=1000,
                      num_samples=4, results_folder=str(tmp_path))
    inner = trainer.optimizer.inner
    assert isinstance(inner, torch.optim.Adam)
    assert inner.defaults["betas"] == (0.9, 0.99)
    assert inner.defaults["lr"] == 8e-5
    assert trainer.optimizer.max_grad_norm == 1.0
    initial = [p.detach().clone() for p in model.parameters()]
    trainer.train(log_every=1000)
    ema = list(trainer.ema_model.parameters())
    # steps 0 and 10 copied the online weights; step 11 moved them again
    assert any((a - b).abs().max() > 0 for a, b in zip(ema, initial))
    assert any((a - b).abs().max() > 0
               for a, b in zip(ema, model.parameters()))
    assert trainer.ckpt.all_milestones() == []  # off the cadence: no save


def test_trains_edm_over_a_dataset(tmp_path):
    class Squares:
        image_size = 16

        def __len__(self):
            return 6

        def __getitem__(self, i):
            img = np.zeros((16, 16, 3), np.float32)
            img[i:i + 4, i:i + 4] = 1.0
            return img, 0

    torch.manual_seed(0)
    net = KarrasUnet(image_size=16, dim=16, dim_max=32, channels=3,
                     num_downsamples=1, num_blocks_per_stage=1,
                     attn_res=(8,), attn_dim_head=16, dropout=0.0)
    ed = ElucidatedDiffusion(net, image_size=16, num_sample_steps=3,
                             device="cpu")
    trainer = Trainer(ed, net, dataset=Squares(), train_batch_size=2,
                      train_num_steps=2, save_and_sample_every=2,
                      num_samples=1, results_folder=str(tmp_path))
    out = trainer.train()
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert trainer.ema_diffusion.net is trainer.ema_model
    assert (tmp_path / "sample-1.png").exists()
    assert trainer.ckpt.all_milestones() == [1]
