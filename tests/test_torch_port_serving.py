"""The port's serving path (vqgan_tpu_torch/serving, export_serving,
serve_generate, serve_http) against the live port pipeline and the JAX
package, on the CPU at a small size.

- The exported CFG sampler (a tiny fp32 U-Net and KL-VAE, weights carried
  from JAX by `cfg_unet_state_from_jax` / `klvae_state_from_jax`) equals
  the live port pipeline (rtol 1e-4, atol 1e-5, the JAX CLI's selftest
  rule), and both match JAX's `ddim_sample(init_noise=, step_noise=)` +
  `decode_latents` on the same numpy noise (atol 1e-4, the tolerance of
  test_torch_port_generate.py), at cond_scale 1.0 and 3.0.
- The VQ codec's indices equal JAX's `encode_to_indices` exactly, its
  reconstruction JAX's `decode_from_indices`.
- bf16-weight artifacts reload, match the live pipeline on the same
  rounded weights, store bf16, and print their drift from fp32 weights.
- Each exported graph holds the `vqgan_tpu_torch` operators (and only aten
  and those), never a Python call into the ctypes wrappers.
- `torch.library.opcheck` of each operator on the CPU.
- The serving package and hosts import no model code (statically, and in
  a fresh interpreter).
- The multi-device exports' refusals: an uneven split, a spec naming no
  parameter, arg_specs or param_specs without a mesh, and a gloo group
  under graph=True.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import _torch_dist_workers as workers
from vqgan_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from vqgan_tpu.models import CFGUnet as JCFGUnet
from vqgan_tpu.models import KLVAE as JKLVAE
from vqgan_tpu.models import VQVAE as JVQVAE
from vqgan_tpu.models.autoencoder import AutoencoderConfig as JConfig
from vqgan_tpu_torch import export_serving
from vqgan_tpu_torch.checkpoint.from_jax import (
    cfg_unet_state_from_jax,
    klvae_state_from_jax,
    vqvae_state_from_jax,
)
from vqgan_tpu_torch.diffusion import GaussianDiffusion
from vqgan_tpu_torch.kernels import ops, reference
from vqgan_tpu_torch.models import KLVAE, VQVAE, CFGUnet
from vqgan_tpu_torch.models.autoencoder import AutoencoderConfig
from vqgan_tpu_torch.models.layers import AttnBlock
from vqgan_tpu_torch.models.unet_cfg import Attention
from vqgan_tpu_torch.parallel.launch import spawn
from vqgan_tpu_torch.parallel.mesh import Mesh
from vqgan_tpu_torch.parallel.tp import tp_param_specs
from vqgan_tpu_torch.serving import (
    export_cfg_sampler,
    export_vq_codec,
    load_cfg_sampler,
    load_vq_codec,
    round_weights,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
UNET = dict(dim=16, num_classes=3, cond_drop_prob=0.0, dim_mults=(1, 2),
            channels=4, attn_dim_head=16, attn_heads=2)
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
           resolution=16, z_channels=4)
DIFF = dict(image_size=8, channels=4, timesteps=20, sampling_timesteps=5,
            objective="pred_v", beta_schedule="cosine", auto_normalize=False)
VQ = dict(ch=16, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
          z_channels=16, num_embeddings=8, embedding_dim=16)
B = 3
RTOL, ATOL = 1e-4, 1e-5  # artifact vs live: the JAX CLI's selftest rule
JAX_ATOL = 1e-4  # port vs JAX: test_torch_port_generate.py's chain rule


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


@pytest.fixture(scope="module")
def pipelines():
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
    tnet = CFGUnet(**UNET).eval()
    tnet.load_state_dict(cfg_unet_state_from_jax(uparams))
    tvae = KLVAE(AutoencoderConfig(**VAE)).eval()
    tvae.load_state_dict(klvae_state_from_jax(vparams))
    tdiff = GaussianDiffusion(tnet, **DIFF, device="cpu")
    return (jdiff, uparams, jvae, vparams), (tdiff, tvae)


def noise(seed=2):
    rng = np.random.default_rng(seed)
    shape = (B, 8, 8, 4)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((5, *shape)).astype(np.float32))


@pytest.fixture(scope="module")
def tiny_artifact(pipelines, tmp_path_factory):
    """tiny_artifact(cond_scale, phi, params_dtype) -> (artifact directory,
    its meta), each exported once per module."""
    _, (tdiff, tvae) = pipelines
    made = {}

    def get(cond_scale, phi, params_dtype="float32"):
        key = (cond_scale, phi, params_dtype)
        if key not in made:
            outdir = tmp_path_factory.mktemp("artifact")
            step, decode = export_serving.cfg_programs(tdiff, tvae,
                                                       cond_scale, phi)
            made[key] = outdir, export_cfg_sampler(
                step, decode, outdir, batch_size=B, latent_shape=(4, 8, 8),
                ddim_pairs=tdiff.ddim_time_pairs(), num_users=3,
                cond_scale=cond_scale, rescaled_phi=phi,
                params_dtype=params_dtype)
        return made[key]

    return get


@pytest.mark.parametrize("cond_scale,phi", [(1.0, 0.0), (3.0, 0.7)])
def test_exported_sampler_matches_live_port_and_jax(pipelines, tiny_artifact,
                                                    cond_scale, phi):
    (jdiff, uparams, jvae, vparams), (tdiff, tvae) = pipelines
    init, steps = noise()
    classes = np.array([0, 2, 1], np.int32)
    tmp_path, meta = tiny_artifact(cond_scale, phi)
    assert meta["ddim_pairs"] == [list(p) for p in tdiff.ddim_time_pairs()]
    assert meta["device"] == "cpu" and meta["batch_size"] == B
    on_disk = json.loads((tmp_path / "meta.json").read_text())
    assert on_disk["cond_scale"] == cond_scale
    assert on_disk["rescaled_phi"] == phi
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "decode.pt2", "meta.json", "step.pt2"]

    sampler = load_cfg_sampler(tmp_path, "cpu")
    got = sampler(torch.from_numpy(classes), init_noise=init,
                  step_noise=steps).numpy()
    live = export_serving.live_pipeline(
        tdiff, tvae, torch.from_numpy(classes).long(), init, steps,
        cond_scale, phi).numpy()

    @jax.jit
    def j_pipeline(up, vp, init, steps, classes):
        z = jdiff.ddim_sample(up, jax.random.PRNGKey(0), init.shape,
                              classes, cond_scale=cond_scale,
                              rescaled_phi=phi, init_noise=init,
                              step_noise=steps)
        return jvae.apply(vp, z, method=JKLVAE.decode_latents)

    want = np.asarray(j_pipeline(uparams, vparams, init, steps, classes))
    assert got.shape == (B, 16, 16, 3)
    np.testing.assert_allclose(got, live, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want, atol=JAX_ATOL)
    np.testing.assert_allclose(live, want, atol=JAX_ATOL)


def test_sampler_draws_noise_in_the_live_order(pipelines, tiny_artifact):
    # from one seeded generator, the artifact draws what ddim_sample draws
    _, (tdiff, tvae) = pipelines
    tmp_path, _ = tiny_artifact(3.0, 0.7)
    classes = torch.tensor([1, 0, 2])
    got = load_cfg_sampler(tmp_path, "cpu")(
        classes, generator=torch.Generator().manual_seed(5))
    z = tdiff.ddim_sample((B, 8, 8, 4), classes, cond_scale=3.0,
                          rescaled_phi=0.7,
                          generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = tvae.decode_latents(z)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)
    with pytest.raises(ValueError, match="takes 3 classes"):
        load_cfg_sampler(tmp_path, "cpu")(torch.tensor([0, 1]))


@pytest.fixture(scope="module")
def codec():
    jnet = JVQVAE(**VQ)
    params = random_params(jnet, jnp.zeros((1, 32, 32, 3)), seed=0)
    net = VQVAE(**VQ).eval()
    net.load_state_dict(vqvae_state_from_jax(params))
    images = np.random.default_rng(1).random((2, 32, 32, 3)).astype(
        np.float32)
    return jnet, params, net, images


def test_codec_matches_jax_and_the_live_codec(codec, tmp_path):
    jnet, params, net, images = codec
    meta = export_vq_codec(export_serving.CodecEncode(net),
                           export_serving.CodecDecode(net), tmp_path,
                           batch_size=2, image_size=32, latent_size=16)
    assert meta["index_shape"] == [2, 16, 16]
    enc, dec = load_vq_codec(tmp_path, "cpu")
    idx = enc(images)
    recon = dec(idx).numpy()
    j_idx = np.asarray(jnet.apply(params, jnp.asarray(images),
                                  method=JVQVAE.encode_to_indices))
    j_recon = np.asarray(jnet.apply(params, jnp.asarray(j_idx),
                                    method=JVQVAE.decode_from_indices))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    assert len(np.unique(j_idx)) > 1  # more than one code in use
    # fp32 decoder through ~15 layers (test_torch_port_vqvae.py's rule)
    np.testing.assert_allclose(recon, j_recon, atol=1e-5)
    with torch.no_grad():
        live_idx = export_serving.CodecEncode(net)(torch.from_numpy(images))
        live = export_serving.CodecDecode(net)(live_idx).numpy()
    np.testing.assert_array_equal(idx.numpy(), live_idx.numpy())
    np.testing.assert_allclose(recon, live, rtol=RTOL, atol=ATOL)


def _stored_dtypes(path):
    """dtypes of a program's parameters (not its constants: the
    schedule stays fp32)."""
    program = torch.export.load(str(path))
    return {program.state_dict[name].dtype
            for name in program.graph_signature.parameters}


def test_bf16_weight_artifacts_reload_and_print_drift(pipelines, codec,
                                                      tiny_artifact,
                                                      tmp_path, capsys):
    _, (tdiff, tvae) = pipelines
    init, steps = noise(3)
    classes = torch.tensor([2, 1, 0])
    f32, _ = tiny_artifact(3.0, 0.7)
    b16, _ = tiny_artifact(3.0, 0.7, "bfloat16")
    for name in ("step.pt2", "decode.pt2"):
        assert _stored_dtypes(b16 / name) == {torch.bfloat16}
        assert _stored_dtypes(f32 / name) == {torch.float32}
    got = load_cfg_sampler(b16, "cpu")(
        classes, init_noise=init, step_noise=steps).numpy()
    rounded = dataclasses.replace(
        tdiff, model=round_weights(tdiff.model, "bfloat16"))
    live = export_serving.live_pipeline(
        rounded, round_weights(tvae, "bfloat16"), classes, init, steps, 3.0,
        0.7).numpy()
    fp32 = export_serving.live_pipeline(tdiff, tvae, classes, init, steps,
                                        3.0, 0.7).numpy()
    np.testing.assert_allclose(got, live, rtol=RTOL, atol=ATOL)
    drift = np.abs(got - fp32).max()
    print(f"bf16-weights pixel drift vs fp32 weights: max|d| {drift:.4f}")
    assert 0 < drift < 0.5

    _, _, net, images = codec
    export_vq_codec(export_serving.CodecEncode(net),
                    export_serving.CodecDecode(net), tmp_path / "codec",
                    batch_size=2, image_size=32, latent_size=16,
                    params_dtype="bfloat16")
    assert _stored_dtypes(tmp_path / "codec" / "encode.pt2") == {
        torch.bfloat16}
    enc, dec = load_vq_codec(tmp_path / "codec", "cpu")
    live_net = round_weights(net, "bfloat16")
    with torch.no_grad():
        want_idx = export_serving.CodecEncode(live_net)(
            torch.from_numpy(images))
    np.testing.assert_array_equal(enc(images).numpy(), want_idx.numpy())
    assert "drift" in capsys.readouterr().out


def _targets(path):
    graph = torch.export.load(str(path)).graph
    return [n.target for n in graph.nodes if n.op == "call_function"]


def _attention_blocks(module):
    return sum(isinstance(m, (AttnBlock, Attention)) for m in module.modules())


def test_exported_graphs_hold_the_kernel_operators(pipelines, tiny_artifact,
                                                   codec, tmp_path):
    cfg, _ = tiny_artifact(3.0, 0.7)
    _, _, net, _ = codec
    export_vq_codec(export_serving.CodecEncode(net),
                    export_serving.CodecDecode(net), tmp_path / "codec",
                    batch_size=2, image_size=32, latent_size=16)
    # one flash forward per attention block of each program's model
    (tdiff, tvae), (enc, dec) = pipelines[1], (net.encoder, net.decoder)
    want = {cfg / "step.pt2": {"flash_fwd": _attention_blocks(tdiff.model)},
            cfg / "decode.pt2": {"flash_fwd": _attention_blocks(tvae.decoder)},
            tmp_path / "codec/encode.pt2": {"flash_fwd": _attention_blocks(enc),
                                            "vq_nearest": 1},
            tmp_path / "codec/decode.pt2": {"flash_fwd": _attention_blocks(dec)}}
    assert want[cfg / "step.pt2"]["flash_fwd"] == 1  # the U-Net's mid block
    for name, counts in want.items():
        targets = _targets(name)
        ours = [t for t in targets if isinstance(t, torch._ops.OpOverload)
                and t.namespace == ops.NAMESPACE]
        got = {}
        for t in ours:
            got[t._opname] = got.get(t._opname, 0) + 1
        assert got == counts, name
        # nothing but aten and the port's operators, no Python callable
        # (such as a ctypes wrapper) in the graph
        for t in targets:
            assert (isinstance(t, torch._ops.OpOverload)
                    and t.namespace in ("aten", ops.NAMESPACE)) or (
                        getattr(t, "__module__", "") == "_operator"), t


def test_loaded_programs_drop_the_no_op_nodes(tiny_artifact):
    # the metadata assertions and same-dtype casts that torch.export keeps
    # cost the host-bound step a dispatcher call each and compute nothing
    from vqgan_tpu_torch.serving import load_program

    artifact, _ = tiny_artifact(3.0, 0.7)
    raw = torch.export.load(str(artifact / "step.pt2")).module()
    lean = load_program(artifact / "step.pt2")

    def count(module, target):
        return sum(n.target is target for n in module.graph.nodes)

    assert count(raw, torch.ops.aten._assert_tensor_metadata.default) > 0
    assert count(lean, torch.ops.aten._assert_tensor_metadata.default) == 0
    assert count(lean, torch.ops.aten.to.dtype) < count(
        raw, torch.ops.aten.to.dtype)
    g = torch.Generator().manual_seed(0)
    x, noise = torch.randn(B, 4, 8, 8, generator=g), torch.randn(
        B, 4, 8, 8, generator=g)
    args = (x, torch.full((B,), 15), torch.full((B,), 11),
            torch.tensor([0, 2, 1]), noise)
    with torch.inference_mode():
        torch.testing.assert_close(lean(*args), raw(*args), rtol=0, atol=0)


def _op_cases():
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g)

    q, k, v, do = rnd(2, 5, 2, 16), rnd(2, 7, 2, 16), rnd(2, 7, 2, 16), \
        rnd(2, 5, 2, 16)
    _, lse = reference.flash_forward_reference(q, k, v, 0.25)
    delta = rnd(2, 2, 5)
    return {
        "flash_fwd": (q, k, v, 0.25),
        "flash_bwd_dq": (q, k, v, do, lse, delta, 0.25),
        "flash_bwd_dkv": (q, k, v, do, lse, delta, 0.25),
        "vq_nearest": (rnd(40, 8), rnd(6, 8), "fp32"),
    }


@pytest.mark.parametrize("name", sorted(ops.OPS))
def test_opcheck_on_the_cpu(name):
    args = _op_cases()[name]
    torch.library.opcheck(ops.OPS[name], args)
    # the CPU implementation is the plain version
    plain = {"flash_fwd": reference.flash_forward_reference,
             "flash_bwd_dq": reference.flash_bwd_dq_reference,
             "flash_bwd_dkv": reference.flash_bwd_dkv_reference}
    got = ops.OPS[name](*args)
    if name in plain:
        want = plain[name](*args)
    else:
        _, idx = reference.vq_lookup_reference(*args)
        want = (idx, reference.codebook_usage(idx, 6))
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


_HOSTS = sorted(
    p.relative_to(REPO).as_posix()
    for p in [*(REPO / "vqgan_tpu_torch" / "serving").glob("*.py"),
              REPO / "vqgan_tpu_torch" / "serve_generate.py",
              REPO / "vqgan_tpu_torch" / "serve_http.py"])
_MODEL_CODE = ("vqgan_tpu_torch.models", "vqgan_tpu_torch.diffusion",
               "vqgan_tpu_torch.training", "vqgan_tpu_torch.build")


def _absolute_imports(path: Path):
    package = ".".join(path.relative_to(REPO).with_suffix("").parts[:-1])
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")
            base = base[:len(base) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            yield mod
            yield from (f"{mod}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", _HOSTS)
def test_serving_hosts_import_no_model_code(path):
    bad = [m for m in _absolute_imports(REPO / path)
           if m.startswith(_MODEL_CODE)]
    assert not bad, f"{path} imports {bad}"


def test_serving_hosts_load_no_model_code_at_run_time():
    code = ("import sys, vqgan_tpu_torch.serve_http, "
            "vqgan_tpu_torch.serve_generate; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('vqgan_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    loaded = eval(out.stdout)
    assert "vqgan_tpu_torch.kernels.ops" in loaded
    assert not [m for m in loaded if m.startswith(_MODEL_CODE)], loaded


REFUSALS = {
    # a split that does not divide, as JAX's NamedSharding refuses it
    "uneven_split": (dict(mesh=Mesh({"model": 3}, "cpu"), param_specs=None),
                     "does not divide over 3 'model' ranks"),
    "spec_naming_no_parameter": (
        dict(mesh=Mesh({"model": 2}, "cpu"),
             param_specs={"step": {"model.no_such.weight": ("model",)}}),
        "no parameter 'model.no_such.weight'"),
    "arg_specs_without_mesh": (dict(arg_specs=(("data",),)),
                               "arg_specs needs a mesh"),
    "param_specs_without_mesh": (dict(param_specs={"step": {}}),
                                 "param_specs needs a mesh"),
    "gloo_group_under_graph": (None, "gloo, which a CUDA graph cannot"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_multi_device_export_refusals(pipelines, tmp_path, case):
    # data-parallel artifacts: test_torch_port_pipeline.py; tensor-parallel
    # ones: test_torch_port_tp_serving.py
    _, (tdiff, tvae) = pipelines
    step, decode = export_serving.cfg_programs(tdiff, tvae, 1.0, 0.0)
    kwargs, message = REFUSALS[case]
    kwargs = None if kwargs is None else dict(kwargs)
    common = dict(batch_size=B, latent_shape=(4, 8, 8),
                  ddim_pairs=tdiff.ddim_time_pairs(), num_users=3,
                  cond_scale=1.0, rescaled_phi=0.0)
    if case == "uneven_split":
        kwargs["param_specs"] = {"step": tp_param_specs(step)}
        with pytest.raises(ValueError, match=message):
            tp_param_specs(step, kwargs["mesh"])
    if kwargs is not None:
        with pytest.raises(ValueError, match=message):
            export_cfg_sampler(step, decode, tmp_path, **kwargs, **common)
        assert not (tmp_path / "step.pt2").exists()
        return
    # a TP artifact on a gloo group of one: graph=True is refused, not run
    # eagerly
    mesh = Mesh({"model": 1}, "cpu")
    export_cfg_sampler(step, decode, tmp_path, mesh=mesh,
                       param_specs={"step": tp_param_specs(step, mesh)},
                       **common)
    init, steps = noise()
    (images, _, _, _, nbytes, refused), = spawn(
        workers.tp_served, 1,
        (str(tmp_path), None, np.array([0, 2, 1]), torch.from_numpy(init),
         torch.from_numpy(steps)), timeout=300)
    assert refused is not None and message in refused
    assert nbytes["split_held"] == nbytes["split_whole"] > 0
    assert torch.isfinite(images).all()
