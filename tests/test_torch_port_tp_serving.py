"""Port parity: tensor-parallel serving artifacts (vqgan_tpu_torch/serving,
`param_specs` over a mesh with a "model" axis) against the JAX package's
(vqgan_tpu/serving/export.py with `param_specs` from vqgan_tpu.parallel.tp)
and against the port's artifact of whole weights, on the CPU at a small
size: a CFG U-Net of dim 32 (mults 1-2, 2 heads x 16) and a KL-VAE decode,
a DDIM chain of 5 steps at cond_scale 3.0, weights from JAX, the initial
and step noise numpy arrays fed to both sides.

- JAX exports `ddim_sample(init_noise=, step_noise=)` + `decode_latents`
  over 2 of conftest's 8 CPU devices, a (1, 2) ("data", "model") mesh,
  every to_qkv / to_q / to_k / to_v / to_out kernel split as
  `tp_spec_for_path` places it.
- The port exports the step and the decode with `tp_param_specs` of each,
  at model 2 (run on 2 gloo ranks) and at data 2 x model 2 (4 ranks).
  Its images:
  - equal JAX's TP artifact's within 1e-4 (test_torch_port_generate.py's
    chain rule: fp32 through 5 U-Net steps and a decode, summed in other
    orders; both sides gather whole kernels, so the split adds nothing);
  - equal the one-device artifact's within rtol 1e-4, atol 1e-5 (the JAX
    CLI's selftest rule: at data 2 the rows run as batches of 2), and bit
    for bit the artifact of whole weights on the same mesh and rank (the
    one-device artifact at model 2), since the gathered kernels are the
    whole ones.
- Each rank's programs hold only its pieces of the split kernels, 1 / 2 of
  their whole bytes, equal to its chunk of split_weights.pt's tensors.
- Over gloo, graph=True is refused rather than run eagerly.
- The KL-VAE's attention names (q, k, v, proj_out) match no TP key: the
  decode stays whole, as in JAX; `tp_param_specs` splits what JAX's
  `tp_spec_for_path` splits, dimension for dimension.
- `serve_generate` under torchrun builds the mesh from meta.json and
  writes what the one-device artifact writes.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

import _torch_dist_workers as workers
from vqgan_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from vqgan_tpu.models import CFGUnet as JCFGUnet
from vqgan_tpu.models import KLVAE as JKLVAE
from vqgan_tpu.models.autoencoder import AutoencoderConfig as JConfig
from vqgan_tpu.parallel.tp import tp_spec_for_path
from vqgan_tpu.serving import export_cfg_sampler as jexport_cfg_sampler
from vqgan_tpu.serving import load_cfg_sampler as jload_cfg_sampler
from vqgan_tpu_torch import export_serving
from vqgan_tpu_torch.checkpoint.from_jax import (
    cfg_unet_state_from_jax,
    klvae_state_from_jax,
)
from vqgan_tpu_torch.diffusion import GaussianDiffusion
from vqgan_tpu_torch.models import KLVAE, CFGUnet
from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig
from vqgan_tpu_torch.parallel.launch import free_port, spawn
from vqgan_tpu_torch.parallel.mesh import Mesh
from vqgan_tpu_torch.parallel.tp import tp_param_specs
from vqgan_tpu_torch.serving import export_cfg_sampler, load_cfg_sampler

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
UNET = dict(dim=32, num_classes=3, cond_drop_prob=0.0, dim_mults=(1, 2),
            channels=4, attn_dim_head=16, attn_heads=2)
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
           resolution=16, z_channels=4)
DIFF = dict(image_size=8, channels=4, timesteps=20, sampling_timesteps=5,
            objective="pred_v", beta_schedule="cosine", auto_normalize=False)
B, COND_SCALE, PHI = 4, 3.0, 0.7
RTOL, ATOL = 1e-4, 1e-5  # against the one-device artifact
JAX_ATOL = 1e-4  # against JAX's TP artifact
SPAWN_TIMEOUT = 600
MESHES = {"model2": {"data": 1, "model": 2},
          "data2_model2": {"data": 2, "model": 2}}


def random_params(module, *args, seed=0, **kwargs):
    """Parameter tree from jax.eval_shape, filled from a numpy seed."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args,
                            **kwargs)
    rng = np.random.default_rng(seed)
    out = {}
    for path, sds in flatten_dict(shapes).items():
        n = rng.standard_normal(sds.shape).astype(np.float32)
        if path[-1] == "kernel":
            n /= np.sqrt(np.prod(sds.shape[:-1]))
        elif path[-1] in ("scale", "g"):
            n = 1.0 + 0.05 * n
        elif path[-1] == "bias":
            n *= 0.05
        out[path] = n
    return unflatten_dict(out)


def noise():
    rng = np.random.default_rng(2)
    shape = (B, 8, 8, 4)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((5, *shape)).astype(np.float32),
            np.array([0, 2, 1, 1], np.int32))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX TP artifact's images, the port's artifacts (one device; TP
    and whole weights on each mesh) and its live step and decode."""
    root = tmp_path_factory.mktemp("tp_serving")
    jnet = JCFGUnet(**UNET)
    uparams = random_params(jnet, jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1,), jnp.int32),
                            cond_drop_mask=jnp.zeros((1,), bool), seed=0)
    jvae = JKLVAE(config=JConfig(**VAE))
    vparams = random_params(jvae, jnp.zeros((1, 16, 16, 3)), seed=1)

    def model_apply(p, x, t, classes, cond_drop_mask=None, **_):
        return jnet.apply(p, x, t, classes, cond_drop_mask=cond_drop_mask)

    jdiff = JGaussianDiffusion(model_apply, **DIFF)

    def pipeline(p, init, steps, classes):
        z = jdiff.ddim_sample(p["unet"], jax.random.PRNGKey(0), init.shape,
                              classes, cond_scale=COND_SCALE,
                              rescaled_phi=PHI, init_noise=init,
                              step_noise=steps)
        return jvae.apply(p["vae"], z, method=JKLVAE.decode_latents)

    params = {"unet": uparams, "vae": vparams}
    specs = jax.tree_util.tree_map_with_path(tp_spec_for_path, params)
    init, steps, classes = noise()
    jmesh = JMesh(np.array(jax.devices()[:2]).reshape(1, 2),
                  ("data", "model"))
    jexport_cfg_sampler(pipeline, params, (init, steps, classes),
                        root / "jax_tp", platforms=["cpu"], mesh=jmesh,
                        arg_specs=(JP(), JP(), JP()), param_specs=specs)
    jax_meta = json.loads((root / "jax_tp" / "meta.json").read_text())
    jax_images = np.asarray(jload_cfg_sampler(root / "jax_tp")(
        init, steps, classes))

    tnet = CFGUnet(**UNET).eval()
    tnet.load_state_dict(cfg_unet_state_from_jax(uparams))
    tvae = KLVAE(AutoencoderConfig(**VAE)).eval()
    tvae.load_state_dict(klvae_state_from_jax(vparams))
    tdiff = GaussianDiffusion(tnet, **DIFF, device="cpu")
    step, decode = export_serving.cfg_programs(tdiff, tvae, COND_SCALE, PHI)
    common = dict(batch_size=B, latent_shape=(4, 8, 8),
                  ddim_pairs=tdiff.ddim_time_pairs(), num_users=3,
                  cond_scale=COND_SCALE, rescaled_phi=PHI)
    dirs = {"one": root / "one"}
    metas = {"one": export_cfg_sampler(step, decode, dirs["one"], **common)}
    for name, shape in MESHES.items():
        mesh = Mesh(shape, "cpu")
        for kind, param_specs in (
                ("tp", {"step": tp_param_specs(step, mesh),
                        "decode": tp_param_specs(decode, mesh)}),
                ("whole", None)):
            if kind == "whole" and shape["data"] == 1:
                continue  # the one-device artifact is its partner
            key = f"{kind}_{name}"
            dirs[key] = root / key
            metas[key] = export_cfg_sampler(
                step, decode, dirs[key], mesh=mesh,
                arg_specs=(("data",),) * 5, param_specs=param_specs,
                **common)
    return {"jax_images": jax_images, "jax_meta": jax_meta, "dirs": dirs,
            "metas": metas, "step": step, "decode": decode}


def test_tp_artifact_records_the_mesh_and_the_split_kernels(served):
    step, decode = served["step"], served["decode"]
    # JAX's artifact splits its kernels over the same (1, 2) mesh
    assert served["jax_meta"]["mesh"] == {"shape": [1, 2],
                                          "axes": ["data", "model"],
                                          "nr_devices": 2}
    for name, shape in MESHES.items():
        meta = served["metas"][f"tp_{name}"]
        assert meta["mesh"] == {"axes": ["data", "model"],
                                "shape": list(shape.values()),
                                "nr_devices": shape["data"] * shape["model"]}
        assert meta["rank_batch_size"] == B // shape["data"]
        want = tp_param_specs(step)
        assert meta["param_specs"]["step"] == {
            k: list(v) for k, v in want.items()}
        # every to_qkv of the linear and mid attentions, the cross
        # attentions' to_q / to_k / to_v, every to_out; the KL-VAE's
        # attention (q, k, v, proj_out) matches no TP key
        assert sum("to_qkv" in k for k in want) == 5
        assert sum(k.endswith(("to_q.weight", "to_v.weight")) for k in
                   want) == 10
        assert sum("to_out" in k for k in want) == 10
        assert meta["param_specs"]["decode"] == {}
        assert tp_param_specs(decode) == {}
        wholes = torch.load(served["dirs"][f"tp_{name}"]
                            / "split_weights.pt", weights_only=True)
        params = dict(step.named_parameters())
        assert sorted(wholes["step"]) == sorted(want)
        for k, t in wholes["step"].items():
            torch.testing.assert_close(t, params[k].detach(), rtol=0,
                                       atol=0)
    # whole weights on a 2 x 2 mesh: the mesh recorded, nothing split
    meta = served["metas"]["whole_data2_model2"]
    assert meta["mesh"]["shape"] == [2, 2] and "param_specs" not in meta
    assert not (served["dirs"]["whole_data2_model2"]
                / "split_weights.pt").exists()
    assert served["metas"]["one"]["mesh"] is None


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_tp_artifact_on_gloo_ranks_matches_jax_and_whole_weights(served,
                                                                 mesh):
    shape = MESHES[mesh]
    world = shape["data"] * shape["model"]
    dirs = served["dirs"]
    partner = dirs["one"] if shape["data"] == 1 else dirs[f"whole_{mesh}"]
    init, steps, classes = noise()
    ranks = spawn(workers.tp_served, world,
                  (str(dirs[f"tp_{mesh}"]), str(partner), classes,
                   torch.from_numpy(init), torch.from_numpy(steps)),
                  timeout=SPAWN_TIMEOUT)
    one = load_cfg_sampler(dirs["one"], "cpu")(
        torch.from_numpy(classes), init_noise=init, step_noise=steps)
    wholes = torch.load(dirs[f"tp_{mesh}"] / "split_weights.pt",
                        weights_only=True)["step"]
    specs = served["metas"][f"tp_{mesh}"]["param_specs"]["step"]
    coords = []
    for images, whole_weights, coord, held, nbytes, refused in ranks:
        coords.append((coord["data"], coord["model"]))
        assert images.shape == (B, 16, 16, 3)
        # the gathered kernels are the whole ones
        torch.testing.assert_close(images, whole_weights, rtol=0, atol=0)
        torch.testing.assert_close(images, one, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(images.numpy(), served["jax_images"],
                                   rtol=0, atol=JAX_ATOL)
        # this rank holds its pieces only
        assert nbytes["split_held"] * 2 == nbytes["split_whole"] > 0
        for name, spec in specs.items():
            d = spec.index("model")
            want = wholes[name].chunk(2, dim=d)[coord["model"]]
            torch.testing.assert_close(held[name], want, rtol=0, atol=0)
        assert refused is not None and "gloo" in refused
    assert coords == [(r // 2, r % 2) for r in range(world)]


def test_tp_param_specs_place_what_jax_places():
    """Each leaf of JAX's CFG U-Net tree filled with its index along the
    dimension `tp_spec_for_path` splits (zeros where it splits none), then
    carried into the port's names and layout by `cfg_unet_state_from_jax`:
    a port parameter varies along a dimension exactly where
    `tp_param_specs` puts "model"."""
    jnet = JCFGUnet(**UNET)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,),
                                                              jnp.int32),
                            jnp.zeros((1,), jnp.int32),
                            cond_drop_mask=jnp.zeros((1,), bool))

    def marked(path, leaf):
        spec = tp_spec_for_path(path, leaf)
        out = np.zeros(leaf.shape, np.float32)
        if "model" in tuple(spec):
            d = tuple(spec).index("model")
            shape = [1] * leaf.ndim
            shape[d] = leaf.shape[d]
            out += np.arange(leaf.shape[d], dtype=np.float32).reshape(shape)
        return out

    state = cfg_unet_state_from_jax(
        jax.tree_util.tree_map_with_path(marked, shapes))
    net = CFGUnet(**UNET)
    specs = tp_param_specs(net, Mesh({"model": 2}, "cpu"))
    assert specs
    for name, _ in net.named_parameters():
        t = state[name]
        varies = tuple(d for d in range(t.ndim) if t.shape[d] > 1
                       and bool((t.diff(dim=d) != 0).any()))
        want = tuple(d for d, a in enumerate(specs.get(name, ()))
                     if a == "model")
        assert varies == want, name
    with pytest.raises(ValueError, match="does not divide over 3"):
        tp_param_specs(net, Mesh({"model": 3}, "cpu"))


def test_mesh_like_refuses_a_layout_that_does_not_add_up():
    from vqgan_tpu_torch.parallel.mesh import mesh_like

    assert mesh_like({"axes": ["data", "model"], "shape": [1, 1],
                      "nr_devices": 1}, "cpu").shape == {"data": 1,
                                                         "model": 1}
    with pytest.raises(ValueError, match="covers 2 ranks"):
        mesh_like({"axes": ["data", "model"], "shape": [1, 2],
                   "nr_devices": 4}, "cpu")


def test_serve_generate_runs_a_tp_artifact_under_torchrun(served, tmp_path):
    """`serve_generate` on 2 gloo ranks (torchrun, --device cpu) builds the
    mesh from meta.json; rank 0 writes the JPGs, the same bytes as the
    one-device artifact's from the same seed (one thread on each side:
    the gathered kernels are the whole ones)."""
    import os
    import subprocess
    import sys

    from vqgan_tpu_torch import serve_generate

    args = ["--device", "cpu", "--user_ids", "2", "--num_images", "4",
            "--seed", "3"]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(free_port()), "-m",
         "vqgan_tpu_torch.serve_generate", "--artifact",
         str(served["dirs"]["tp_model2"]), "--output_dir",
         str(tmp_path / "tp"), *args], check=True, cwd=REPO, env=env,
        capture_output=True, timeout=SPAWN_TIMEOUT)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        serve_generate.main(["--artifact", str(served["dirs"]["one"]),
                             "--output_dir", str(tmp_path / "one"), *args])
    finally:
        torch.set_num_threads(threads)
    got = sorted((tmp_path / "tp" / "ID_2").iterdir())
    want = sorted((tmp_path / "one" / "ID_2").iterdir())
    assert [p.name for p in got] == [f"generated_{i:03d}.jpg"
                                     for i in range(4)]
    assert [p.name for p in got] == [p.name for p in want]
    for a, b in zip(got, want):
        assert a.read_bytes() == b.read_bytes(), a.name
