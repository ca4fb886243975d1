"""End-to-end two-stage pipeline demo of the port on the card.

    python -m vqgan_tpu_torch.e2e_demo [--root ./results/e2e_torch] \\
        [--stages data split ...] [--force] [--vae_ckpt kl_vae-1.pt] \\
        [--device cuda]
    python -m vqgan_tpu_torch.e2e_demo --check

Counterpart of cli/e2e_demo.py. It drives the whole reference workflow
through the port's entry points: every stage is a subprocess of
`python -m vqgan_tpu_torch.<name>`, as a user would run it, at reduced step
counts:

  1. data        synthetic micro-Doppler-like dataset ID_1..ID_31
                 (per-user banded gratings, as cli/e2e_demo.py draws them)
  2. split       create_data_split, then --verify
  3. kl_vae      train_kl_vae                (stage 1, LDM path)
  4. vae_report  vae_reconstruction          (PSNR/SSIM verdict)
  5. gmm         preprocess_latents_with_gmm (GMM split + latent cache)
  6. ldm         train_latent_cfg            (stage 2, CFG U-Net)
  7. generate    generate --all_users        (ID_X/generated_###.jpg)
  8. serving     export_serving --selftest, then serve_generate
  9. vqgan       train_vqgan                 (stage-1 baseline, 128 px)
 10. diagnose    diagnose_latent_range       (VQ latent statistics)
 11. classifier  classifier_experiment       real vs real + synthetic

It writes `<root>/e2e_demo.json`: each stage's status and seconds, and a
summary of the quality numbers (VAE PSNR/SSIM, image counts, classifier
accuracy with and without synthetic images) with the provenance of each
(measured now, carried from an earlier run, or dropped because a stage
upstream of it ran again). Stages are resumable: a stage whose artifact
exists is skipped unless --force; --stages selects a subset. `--device` is
passed to every stage that runs on a device (all but data and split); the
default is the GPU. The default root is `results/e2e_torch`, which git
ignores; `results/e2e/e2e_demo.json` is the JAX package's own record and
this demo never writes it. `--check` runs nothing and fails if the working
tree holds anything a run should not leave.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

# Stage dependency graph: a stage's previously-measured numbers stop
# describing the current pipeline when anything it (transitively) consumes
# re-runs. vqgan/diagnose form a side branch off the split; the classifier
# consumes the generated images, which consume the LDM, etc.
STAGE_DEPS = {
    "data": (),
    "split": ("data",),
    "kl_vae": ("split",),
    "vae_report": ("kl_vae",),
    "gmm": ("kl_vae",),
    "ldm": ("gmm",),
    "generate": ("ldm",),
    "serving": ("ldm",),
    "vqgan": ("split",),
    "diagnose": ("vqgan",),
    "classifier": ("generate",),
}

# Which stage each summary key is measured by.
SUMMARY_STAGE = {
    "vae_psnr": "vae_report",
    "vae_ssim": "vae_report",
    "vae_verdict": "vae_report",
    "generated_images": "generate",
    "serving_images": "serving",
    "classifier_acc_real": "classifier",
    "classifier_acc_real_plus_synth": "classifier",
}


def invalidated_stages(ran: set) -> set:
    """Transitive-downstream closure of the stages that re-ran this
    invocation: every stage in the returned set either re-ran or has a
    (transitive) dependency that did, so any metric it measured BEFORE this
    invocation no longer describes the current pipeline."""
    out = set(ran)
    changed = True
    while changed:
        changed = False
        for stage, deps in STAGE_DEPS.items():
            if stage not in out and any(d in out for d in deps):
                out.add(stage)
                changed = True
    return out


def collect_summary(ws: Path, report: dict, ran: set, gen_dir: Path,
                    now: str) -> None:
    """Rebuild report['summary'] + report['summary_provenance'].

    Three provenance classes per key:
      - measured: artifact read now AND its stage is not stale (re-ran this
        invocation, or nothing upstream of it changed);
      - carried: artifact absent here (cross-machine resume) but the stage
        is not stale: previous value kept, tagged ``carried: true``;
      - dropped: the stage is stale (an upstream stage re-ran without it):
        the key is removed so the summary can never silently pair metrics
        from different model versions.
    """
    stale = invalidated_stages(ran) - ran
    prev = dict(report.get("summary") or {})
    prev_prov = dict(report.get("summary_provenance") or {})
    summary, prov = {}, {}

    def put(key, value):
        stage = SUMMARY_STAGE[key]
        summary[key] = value
        prov[key] = {
            "stage": stage,
            "measured_at": (now if stage in ran else prev_prov.get(
                key, {}).get("measured_at", "pre-existing artifact")),
        }

    vm = ws / "vae_reconstruction" / "metrics.json"
    if "vae_report" not in stale and vm.exists():
        m = json.loads(vm.read_text())
        put("vae_psnr", m.get("mean_psnr"))
        put("vae_ssim", m.get("mean_ssim"))
        put("vae_verdict", m.get("verdict"))
    if "classifier" not in stale:
        for tag, p in (("real", ws / "classifier_real.json"),
                       ("real_plus_synth", ws / "classifier_synth.json")):
            if p.exists():
                put(f"classifier_acc_{tag}",
                    json.loads(p.read_text()).get("accuracy"))
    if "generate" not in stale and gen_dir.exists():
        put("generated_images", sum(1 for _ in gen_dir.glob("ID_*/*.jpg")))
    srv = ws / "serving" / "generated"
    if "serving" not in stale and srv.exists():
        put("serving_images", sum(1 for _ in srv.glob("ID_*/*.jpg")))

    # carry forward non-stale keys whose artifact is absent on THIS machine
    for key, value in prev.items():
        stage = SUMMARY_STAGE.get(key)
        if key in summary or stage is None or stage in stale:
            continue
        summary[key] = value
        prov[key] = {**prev_prov.get(key, {"stage": stage}), "carried": True}

    report["summary"] = summary
    report["summary_provenance"] = prov


# ------------------------------------------------------------------ data --

def make_user_image(rng, size: int, user: int) -> np.ndarray:
    """One synthetic spectrogram-like image: a per-user oriented banded
    grating (class-stable frequency + orientation) over per-image random
    Gaussian energy blobs and noise, in [0,1]."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    # class-stable carrier: frequency 3..10 cycles, orientation from user id
    f = 3.0 + (user % 8)
    theta = (user * 0.37) % (np.pi / 2)
    cx, cy = np.cos(theta), np.sin(theta)
    phase = rng.rand() * 2 * np.pi
    img = np.zeros((size, size, 3), np.float32)
    grating = 0.5 + 0.5 * np.sin(2 * np.pi * f * (cx * xx + cy * yy) + phase)
    img += 0.5 * grating[..., None] * (0.4 + 0.6 * rng.rand(3))
    for _ in range(3):
        bx, by = rng.rand(2)
        s = 0.04 + 0.12 * rng.rand()
        blob = np.exp(-(((xx - bx) ** 2 + (yy - by) ** 2) / (2 * s * s)))
        img += 0.6 * blob[..., None] * rng.rand(3)
    img += 0.05 * rng.rand(size, size, 3)
    return np.clip(img / max(img.max(), 1e-6), 0, 1)


def stage_data(ws: Path, a) -> dict:
    from PIL import Image

    root = ws / "dataset"
    for u in range(1, a.num_users + 1):
        d = root / f"ID_{u}"
        d.mkdir(parents=True, exist_ok=True)
        rng = np.random.RandomState(1000 + u)
        for i in range(a.imgs_per_user):
            arr = (make_user_image(rng, a.image_size, u) * 255).astype(
                np.uint8)
            Image.fromarray(arr).save(d / f"frame_{i:03d}.jpg", quality=95)
    n = sum(1 for _ in root.glob("ID_*/*.jpg"))
    return {"images": n}


# ---------------------------------------------------------------- hygiene --

# working-tree entries that other tooling keeps up to date (the performance
# ledger); anything else in `git status` after a run is a stray side effect
# and fails --check (the demo's root, results/e2e_torch, is ignored by git)
ALLOWED_DIRTY = {"PERF_LEDGER.jsonl"}


def check_clean_tree() -> int:
    """Fail if the working tree holds an entry a run should not leave."""
    out = subprocess.run(["git", "-C", str(REPO), "status", "--porcelain"],
                         capture_output=True, text=True, check=True)
    bad = [line for line in out.stdout.splitlines()
           if line[3:].strip().strip('"').rstrip("/") not in ALLOWED_DIRTY]
    if bad:
        print("e2e --check FAILED: unexpected working-tree entries "
              "(e2e runs must not leave stray artifacts):")
        print("\n".join(bad))
        return 1
    print("e2e --check: working tree clean (expected artifacts only)")
    return 0


# ------------------------------------------------------------- subprocess --

def run_module(ws: Path, name: str, module: str, *args: str) -> None:
    """`python -m vqgan_tpu_torch.<module> args`, its output in
    `<ws>/log_<name>.txt`; raises with the log's tail if it fails."""
    log = ws / f"log_{name}.txt"
    cmd = [sys.executable, "-u", "-m", f"vqgan_tpu_torch.{module}", *args]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), env.get("PYTHONPATH")) if p)
    with log.open("w") as fh:
        fh.write("$ " + " ".join(cmd) + "\n")
        fh.flush()
        proc = subprocess.run(cmd, stdout=fh, stderr=subprocess.STDOUT,
                              env=env)
    if proc.returncode != 0:
        tail = "".join(log.read_text().splitlines(True)[-30:])
        raise RuntimeError(f"stage {name} failed (rc={proc.returncode}):\n"
                           f"{tail}")


# ----------------------------------------------------------------- stages --

def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default="./results/e2e_torch")
    ap.add_argument("--num_users", type=int, default=31)
    ap.add_argument("--imgs_per_user", type=int, default=30)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--vae_steps", type=int, default=400)
    ap.add_argument("--vae_lr", type=float, default=1e-4)
    ap.add_argument("--vae_lr_schedule", choices=["constant", "cosine"],
                    default="cosine")
    ap.add_argument("--ldm_steps", type=int, default=600)
    ap.add_argument("--vqgan_steps", type=int, default=250)
    ap.add_argument("--gen_per_user", type=int, default=8)
    # 10, not 3: at 3 epochs the ResNet18 is still underfit (the JAX
    # package's round-5 measurement: 6.7% test accuracy at 3 epochs, 55.7%
    # at 10 on the same split)
    ap.add_argument("--classifier_epochs", type=int, default=10)
    ap.add_argument("--stages", nargs="*", default=None,
                    help="subset of stage names to run")
    ap.add_argument("--vae_ckpt", default=None,
                    help="use this stage-1 KL-VAE file for every downstream "
                         "stage instead of the one the kl_vae stage trains")
    ap.add_argument("--force", action="store_true",
                    help="re-run stages whose artifacts already exist")
    ap.add_argument("--check", action="store_true",
                    help="run no stages; check that the working tree holds "
                         "no stray e2e artifacts")
    ap.add_argument("--device", default="cuda")
    return ap, ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the selected stages; returns the report written."""
    ap, a = parse_args(argv)
    if a.check:
        sys.exit(check_clean_tree())

    ws = Path(a.root).absolute()
    ws.mkdir(parents=True, exist_ok=True)
    dataset = ws / "dataset"
    split_uniform = ws / "data_split_uniform.json"
    split_gmm = ws / "data_split.json"
    vae_dir = ws / "kl_vae"
    cache = ws / "latents_cache"
    ldm_dir = ws / "ldm"
    gen_dir = ws / "generated"
    vqgan_dir = ws / "vqgan"
    dev = ("--device", a.device)

    # a milestone every 400 steps as in cli/e2e_demo.py, or at the end of a
    # shorter run
    vae_every = max(1, min(400, a.vae_steps))
    vae_ckpt = (Path(a.vae_ckpt).absolute() if a.vae_ckpt
                else vae_dir / f"kl_vae-{max(1, a.vae_steps // vae_every)}.pt")

    def _uniform_train_count():
        # leave a test remainder for --verify
        return max(2, min(20, a.imgs_per_user - 5))

    def classifier(tag, *extra):
        run_module(ws, f"classifier_{tag}", "classifier_experiment",
                   "--data_root", str(dataset), "--split", str(split_gmm),
                   *extra, "--num_classes", str(a.num_users),
                   "--epochs", str(a.classifier_epochs),
                   "--image_size", str(a.image_size),
                   "--output", str(ws / f"classifier_{tag}.json"), *dev)

    stages = {
        "data": dict(
            artifact=dataset / f"ID_{a.num_users}",
            run=lambda: stage_data(ws, a)),
        "split": dict(
            artifact=split_uniform,
            run=lambda: (
                run_module(ws, "split", "create_data_split",
                           "--data_path", str(dataset),
                           "--output", str(split_uniform),
                           "--num_users", str(a.num_users),
                           "--images_per_user_train",
                           str(_uniform_train_count())),
                run_module(ws, "split_verify", "create_data_split",
                           "--data_path", str(dataset),
                           "--output", str(split_uniform), "--verify"))),
        "kl_vae": dict(
            artifact=vae_ckpt,
            run=lambda: run_module(
                ws, "kl_vae", "train_kl_vae",
                "--data_path", str(dataset), "--split", str(split_uniform),
                "--results_folder", str(vae_dir),
                "--image_size", str(a.image_size),
                "--train_steps", str(a.vae_steps),
                "--save_every", str(vae_every), "--lr", str(a.vae_lr),
                "--lr_schedule", a.vae_lr_schedule, *dev)),
        "vae_report": dict(
            artifact=ws / "vae_reconstruction" / "metrics.json",
            run=lambda: run_module(
                ws, "vae_report", "vae_reconstruction",
                "--vae_path", str(vae_ckpt), "--data_path", str(dataset),
                "--image_size", str(a.image_size),
                "--output_dir", str(ws / "vae_reconstruction"), *dev)),
        "gmm": dict(
            artifact=split_gmm,
            run=lambda: run_module(
                ws, "gmm", "preprocess_latents_with_gmm",
                "--vae_path", str(vae_ckpt), "--data_path", str(dataset),
                "--output_split", str(split_gmm),
                "--cache_folder", str(cache),
                "--num_users", str(a.num_users),
                "--image_size", str(a.image_size),
                "--n_gen_train", str(max(2, a.imgs_per_user * 2 // 5)),
                "--n_class_train", str(max(2, a.imgs_per_user // 4)), *dev)),
        "ldm": dict(
            artifact=ldm_dir / "model-1.pt",
            run=lambda: run_module(
                ws, "ldm", "train_latent_cfg",
                "--vae_path", str(vae_ckpt),
                "--data_path", str(dataset), "--split", str(split_gmm),
                "--results_folder", str(ldm_dir),
                "--latents_cache_folder", str(cache),
                "--train_num_steps", str(a.ldm_steps), *dev)),
        "generate": dict(
            artifact=gen_dir / f"ID_{a.num_users}",
            run=lambda: run_module(
                ws, "generate", "generate",
                "--checkpoint", str(ldm_dir), "--vae_path", str(vae_ckpt),
                "--output_dir", str(gen_dir), "--all_users",
                "--num_images", str(a.gen_per_user),
                "--batch_size", str(a.gen_per_user), *dev)),
        "serving": dict(
            artifact=ws / "serving" / "generated" / "ID_1",
            run=lambda: (
                run_module(ws, "serving_export", "export_serving",
                           "--checkpoint", str(ldm_dir),
                           "--vae_path", str(vae_ckpt),
                           "--out", str(ws / "serving" / "artifact"),
                           "--batch_size", "4", "--selftest", *dev),
                run_module(ws, "serving_generate", "serve_generate",
                           "--artifact", str(ws / "serving" / "artifact"),
                           "--output_dir", str(ws / "serving" / "generated"),
                           "--user_ids", "1", "2",
                           "--num_images", "2", *dev))),
        "vqgan": dict(
            artifact=vqgan_dir / "vqgan-1.pt",
            run=lambda: run_module(
                ws, "vqgan", "train_vqgan",
                "--data_path", str(dataset), "--split", str(split_uniform),
                "--results_folder", str(vqgan_dir),
                "--train_steps", str(a.vqgan_steps),
                "--image_size", "128",
                "--disc_start", str(a.vqgan_steps // 2), *dev)),
        "diagnose": dict(
            artifact=ws / "log_diagnose.txt",
            run=lambda: run_module(
                ws, "diagnose", "diagnose_latent_range",
                "--vqgan_path", str(vqgan_dir / "vqgan-1.pt"),
                "--data_path", str(dataset), "--num_images", "32",
                "--image_size", "128", *dev)),
        "classifier": dict(
            artifact=ws / "classifier_synth.json",
            run=lambda: (
                classifier("real"),
                classifier("synth", "--synthetic_folder", str(gen_dir)))),
    }

    selected = a.stages or list(stages)
    unknown = set(selected) - set(stages)
    if unknown:
        ap.error(f"unknown stages: {sorted(unknown)}")

    report_path = ws / "e2e_demo.json"
    report = (json.loads(report_path.read_text())
              if report_path.exists() else {"stages": {}})

    ran = set()
    for name in stages:
        if name not in selected:
            continue
        spec = stages[name]
        if not a.force and Path(spec["artifact"]).exists():
            print(f"[{name}] artifact exists, skipping")
            report["stages"].setdefault(name, {"status": "cached"})
            continue
        print(f"[{name}] running...", flush=True)
        t0 = time.time()
        try:
            extra = spec["run"]()
            if not isinstance(extra, dict):
                extra = {}
        except Exception as e:
            report["stages"][name] = {"status": "FAILED", "error": str(e)}
            report_path.write_text(json.dumps(report, indent=2))
            raise
        ran.add(name)
        report["stages"][name] = {
            "status": "ok", "seconds": time.time() - t0, **extra}
        report_path.write_text(json.dumps(report, indent=2))
        print(f"[{name}] done in {report['stages'][name]['seconds']:.1f} s",
              flush=True)

    # the summary, with provenance: anything downstream of a stage that
    # re-ran is dropped unless it was itself re-measured; values carried
    # from another machine are tagged
    if a.vae_ckpt:  # which stage-1 checkpoint the pipeline used
        report["vae_ckpt_override"] = str(vae_ckpt)
    collect_summary(ws, report, ran, gen_dir,
                    now=time.strftime("%Y-%m-%d %H:%M:%S"))
    report_path.write_text(json.dumps(report, indent=2))
    print(json.dumps(report["summary"], indent=2))
    return report


if __name__ == "__main__":
    main()
