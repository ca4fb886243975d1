"""Serving artifacts with `torch.export`: programs that run with no model
code.

Counterpart of vqgan_tpu/serving/export.py. An artifact is a directory:

    <program>.pt2   a program saved with `torch.export.save`, weights inside
    meta.json       config, batch size, shapes, export device, export
                    seconds and bytes of each program

- `export_program` / `load_program`: any module, traced at its example
  inputs' shapes.
- `export_cfg_sampler` / `load_cfg_sampler`: the generation pipeline as two
  programs: `step.pt2`, one CFG DDIM step (the U-Net forward, the CFG
  combine at the baked cond_scale and rescaled_phi, the update), and
  `decode.pt2`, the KL-VAE decode of the final latents to NHWC images in
  [0, 1]. The loader loops over the step with the DDIM (t, t_next) pairs
  that meta.json holds. This diverges from the JAX package, which exports
  the DDIM scan and the decode as one program: `torch.export` has no
  stable scan, and unrolling 150 U-Net calls (about 1453 launches each)
  would give a graph of over 200,000 nodes. The loop body is the program
  JAX's scan compiles, so the loader's loop computes the same thing.
- Noise comes in as tensors. The loader draws the initial and per-step
  noise from a `torch.Generator` (the hosts seed one per request), or takes
  `init_noise` and `step_noise`. JAX's PRNG key stream is not reproduced.
- `export_vq_codec` / `load_vq_codec`: the VQ-VAE index codec as two
  programs, `encode.pt2` (NHWC images -> int32 indices, through the VQ
  kernel) and `decode.pt2` (indices -> NHWC images).
- `params_dtype="bfloat16"` stores the floating weights in bf16, half the
  bytes; each program casts them back to their own dtype as it starts, as
  the JAX package's bf16 weights are promoted where they meet fp32
  activations. `round_weights` gives the live modules the same weights.
- The programs call the hand-written kernels as the operators of
  `kernels/ops.py`; a loader imports that module (and `device.py`) and no
  model code. Artifacts are tied to the device type they were exported on.
- Data-parallel artifacts (`mesh` with a "data" axis of dp ranks,
  `arg_specs` () or ("data",) per call-time input): the programs are
  traced at the per-rank batch B / dp and meta.json records the mesh. The
  loader runs on dp ranks of a process group: each draws the global
  batch's noise (or takes the given noise), runs its rows, and the ranks
  gather the images, so every rank returns what one device returns for
  the whole batch. `param_specs` (weights split over the mesh, TP serving)
  raises `NotImplementedError`: the port's TP placement gathers its
  kernels for compute, which an exported program cannot do.
"""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..graphs import ChainGraphs, ChainStep, resolve_graph, run_chain
from ..kernels import ops  # noqa: F401  (registers the operators)

__all__ = ["export_program", "load_program", "export_cfg_sampler",
           "load_cfg_sampler", "CFGSampler", "export_vq_codec",
           "load_vq_codec", "round_weights"]

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _flat(name: str) -> str:
    return name.replace(".", "__")


class _StoredWeights(nn.Module):
    """`module` with its floating parameters stored in `dtype` (as they are
    for None) and cast back to each one's own dtype when the program runs.
    Only these copies are the program's parameters; what else the module
    reads (buffers, the diffusion schedule) `torch.export` keeps as
    constants."""

    def __init__(self, module: nn.Module, dtype):
        super().__init__()
        object.__setattr__(self, "_module", module)  # not a submodule
        self._params = []
        for name, p in module.named_parameters():
            stored = p.detach()
            if dtype is not None and p.is_floating_point():
                stored = stored.to(dtype)
            self.register_parameter(_flat(name),
                                    nn.Parameter(stored, requires_grad=False))
            self._params.append((name, p.dtype))

    def forward(self, *args):
        state = {n: getattr(self, _flat(n)).to(d) for n, d in self._params}
        return torch.func.functional_call(self._module, state, args)


def round_weights(module: nn.Module, params_dtype: str) -> nn.Module:
    """`module` with the weights an artifact of `params_dtype` computes
    with: itself for "float32", else a copy whose floating parameters are
    rounded through that dtype."""
    dtype = _DTYPES[params_dtype]
    if dtype is None:
        return module
    out = copy.deepcopy(module)
    with torch.no_grad():
        for p in out.parameters():
            if p.is_floating_point():
                p.copy_(p.to(dtype).to(p.dtype))
    return out


def export_program(module: nn.Module, example_args: Sequence, path,
                   params_dtype: str = "float32") -> dict:
    """Trace `module` with `torch.export` at `example_args`' shapes (no
    gradient), its floating weights stored in `params_dtype`, and save it
    to `path` (a .pt2 file). Returns {"seconds": export and save, "bytes":
    the file's size}."""
    if params_dtype not in _DTYPES:
        raise ValueError(f"params_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {params_dtype!r}")
    t0 = time.perf_counter()
    program = _StoredWeights(module.eval(), _DTYPES[params_dtype])
    with torch.no_grad():
        exported = torch.export.export(program, tuple(example_args))
    torch.export.save(exported, str(path))
    return {"seconds": time.perf_counter() - t0,
            "bytes": Path(path).stat().st_size}


def load_program(path, location: Optional[dict] = None):
    """The module of a saved program; it runs with the operators of
    `kernels/ops.py` and no model code. The nodes that compute nothing are
    dropped first (`_drop_no_ops`). `location` maps the device it was saved
    on to another of the same type ({"cuda:0": "cuda:1"})."""
    program = torch.export.load(str(path))
    if location:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, location)
    module = program.module()
    _drop_no_ops(module.graph)
    module.recompile()
    return module


def _drop_no_ops(graph) -> None:
    """Remove from an exported graph what costs the host a dispatcher call
    and computes nothing: the metadata assertion `torch.export` places
    beside each cast, and each cast to the dtype its input already has (the
    layers cast their inputs and weights to their compute dtype). The U-Net
    step is host-bound, so each call counts."""
    assert_metadata = torch.ops.aten._assert_tensor_metadata.default
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target is assert_metadata and not node.users:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and not node.kwargs
              and len(node.args) == 2):
            val = node.args[0].meta.get("val")
            if val is not None and val.dtype == node.args[1]:
                node.replace_all_uses_with(node.args[0])
                graph.erase_node(node)
    graph.lint()


def _data_parallel(mesh, arg_specs, param_specs, batch_size: int) -> int:
    """The data-parallel degree of an export (1 without a mesh)."""
    if param_specs is not None:
        raise NotImplementedError(
            "param_specs: tensor-parallel serving artifacts are not ported; "
            "the weights of an artifact are whole on each device")
    if mesh is None:
        if arg_specs is not None:
            raise ValueError("arg_specs needs a mesh")
        return 1
    if any(n > 1 for a, n in mesh.shape.items() if a != "data"):
        raise NotImplementedError(
            f"serving meshes split the batch over 'data' only, got "
            f"{dict(mesh.shape)}")
    for spec in arg_specs or ():
        if tuple(spec)[:1] not in ((), ("data",), (None,)):
            raise NotImplementedError(
                f"call-time inputs split over 'data' or whole, got {spec}")
    dp = mesh.shape["data"]
    if batch_size % dp:
        raise ValueError(f"batch {batch_size} does not divide over dp={dp}")
    return dp


def _device_of(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def _write_meta(outdir: Path, meta: dict) -> dict:
    (outdir / "meta.json").write_text(json.dumps(meta, indent=1))
    return meta


def _read_meta(outdir, device) -> dict:
    """meta.json of an artifact, after checking that it was exported for
    `device`'s type, which must be present."""
    want = resolve_device(device)
    meta = json.loads((Path(outdir) / "meta.json").read_text())
    have = torch.device(meta["device"])
    if have.type != want.type:
        raise ValueError(
            f"{outdir} was exported on {have}; it runs there only (export "
            f"it again with --device {want.type})")
    return meta


# --------------------------------------------------------------------------
# the generation pipeline: one CFG DDIM step and the decode


def export_cfg_sampler(step: nn.Module, decode: nn.Module, outdir, *,
                       batch_size: int, latent_shape: Sequence[int],
                       ddim_pairs: Sequence[Sequence[int]], num_users: int,
                       cond_scale: float, rescaled_phi: float,
                       params_dtype: str = "float32",
                       config: dict | None = None, mesh=None, arg_specs=None,
                       param_specs=None) -> dict:
    """Export the generation pipeline as a serving directory.

    step(img [B,C,h,w], t [B], t_next [B], classes [B], noise [B,C,h,w]) ->
    img: one CFG DDIM step at the baked cond_scale and rescaled_phi (e.g.
    `diffusion.gaussian.DDIMStep`); decode(img [B,C,h,w]) -> NHWC images in
    [0, 1]. `latent_shape` is (C, h, w); `ddim_pairs` the (t, t_next) pairs
    the loader loops over, in order. `mesh` (a "data" axis of dp ranks)
    makes a data-parallel artifact: the programs run B / dp rows on each
    rank. Returns the meta.json written."""
    dp = _data_parallel(mesh, arg_specs, param_specs, batch_size)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    device = _device_of(step)
    b = batch_size // dp

    def img():
        return torch.zeros((b, *latent_shape), device=device)

    def labels():
        return torch.zeros((b,), dtype=torch.long, device=device)

    # a tensor of its own for each input: an input given twice would be
    # traced as one
    programs = {
        "step": export_program(step, (img(), labels(), labels(), labels(),
                                      img()),
                               outdir / "step.pt2", params_dtype),
        "decode": export_program(decode, (img(),), outdir / "decode.pt2",
                                 params_dtype),
    }
    return _write_meta(outdir, {
        "kind": "cfg_sampler", "programs": programs,
        "batch_size": batch_size, "rank_batch_size": b,
        "mesh": ({"axes": ["data"], "shape": [dp], "nr_devices": dp}
                 if dp > 1 else None),
        "latent_shape": list(latent_shape),
        "ddim_pairs": [list(map(int, p)) for p in ddim_pairs],
        "num_users": int(num_users), "cond_scale": float(cond_scale),
        "rescaled_phi": float(rescaled_phi), "params_dtype": params_dtype,
        "device": str(device), "config": config or {}})


def _as_nchw(x, device):
    """An NHWC array or tensor (any leading axes) as fp32 NCHW on
    `device`."""
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                        dtype=torch.float32, device=device)
    return t.movedim(-1, -3)


class CFGSampler:
    """A loaded cfg_sampler artifact: `sampler(classes)` -> NHWC images
    [B, H, W, 3] in [0, 1], fp32, on the artifact's device. `classes` are B
    0-based labels. Noise: `init_noise` [B, h, w, C] and `step_noise` [S,
    B, h, w, C] (NHWC, as `GaussianDiffusion.ddim_sample` takes them), else
    drawn from `generator` in the live sampler's order: the initial noise,
    then one draw per step.

    On the card (`graph` None) each step of the loop replays one CUDA graph
    of the loaded step (`graphs.ChainStep`), captured per kind of noise at
    the first call's second step and kept; given noise goes in through its
    static buffers, and a replay draws from `generator` what the loop
    draws. `graph` False runs the loaded step from Python; True on the CPU
    raises. The decode runs after the loop, outside the graph.

    A data-parallel artifact runs on the "data" axis of `mesh` (by
    default a mesh over every rank of the process group), which must have
    the artifact's dp ranks: each rank takes its rows of the classes and
    of the global batch's noise, and the images of all ranks are gathered,
    so each rank returns [B, H, W, 3]."""

    def __init__(self, outdir, device="cuda", mesh=None):
        outdir = Path(outdir)
        self.meta = _read_meta(outdir, device)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        saved = torch.device(self.meta["device"])
        if saved.type == "cuda" and saved.index is None:
            saved = torch.device("cuda", 0)
        # a rank of a data-parallel artifact runs it on its own card
        location = ({str(saved): str(self.device)}
                    if saved != self.device else None)
        self.batch_size = int(self.meta["batch_size"])
        self.rank_batch = int(self.meta.get("rank_batch_size",
                                            self.batch_size))
        self.mesh = None
        layout = self.meta.get("mesh")
        if layout is not None:
            from ..parallel.mesh import named_mesh

            dp = layout["shape"][0]
            self.mesh = mesh or named_mesh({"data": dp}, self.device)
            if self.mesh.shape.get("data") != dp:
                raise ValueError(f"{outdir} serves on {dp} data-parallel "
                                 f"ranks, the mesh has {self.mesh.shape}")
        self.num_users = int(self.meta["num_users"])
        self.latent_shape = tuple(self.meta["latent_shape"])
        self._step = load_program(outdir / "step.pt2", location)
        self._decode = load_program(outdir / "decode.pt2", location)
        pairs = torch.tensor(self.meta["ddim_pairs"], dtype=torch.long,
                             device=self.device)
        self._pairs = pairs[:, :, None].expand(-1, -1, self.rank_batch)
        self.graphs = ChainGraphs()

    def __call__(self, classes, *, generator: torch.Generator = None,
                 init_noise=None, step_noise=None,
                 graph: Optional[bool] = None):
        b, dev = self.batch_size, self.device
        classes = torch.as_tensor(classes, dtype=torch.long, device=dev)
        if classes.shape != (b,):
            raise ValueError(f"the artifact takes {b} classes, got "
                             f"{tuple(classes.shape)}")
        given = {name: _as_nchw(x, dev) for name, x in
                 (("init_noise", init_noise), ("step_noise", step_noise))
                 if x is not None}
        if self.mesh is not None:
            classes = self._rows(classes)
            if "init_noise" in given:
                given["init_noise"] = self._rows(given["init_noise"])
            if "step_noise" in given:
                given["step_noise"] = self._rows(
                    given["step_noise"].transpose(0, 1)).transpose(
                        0, 1).contiguous()

        def body(generators, carry, consts, row):
            noise = (row["noise"] if "noise" in row
                     else self._randn(generators[0]))
            return {"img": self._step(carry["img"], row["time"],
                                      row["time_next"], consts["classes"],
                                      noise)}

        step = ChainStep(body, graphs=self.graphs, key="served DDIM step",
                         graph=resolve_graph(graph, dev),
                         name="served DDIM step")
        with torch.inference_mode():
            img = given.get("init_noise")
            if img is None:
                img = self._randn(generator)
            img = run_chain(step, {"img": img}, len(self._pairs),
                            consts={"classes": classes},
                            table={"time": self._pairs[:, 0],
                                   "time_next": self._pairs[:, 1],
                                   "noise": given.get("step_noise")},
                            generators=[generator])["img"]
            images = self._decode(img)
        if self.mesh is not None:
            from ..parallel.comm import all_gather_cat

            images = all_gather_cat(images, 0, self.mesh.group("data"))
        return images

    def _rows(self, x):
        """This rank's rows of a global batch."""
        i = self.mesh.coord("data") * self.rank_batch
        return x[i:i + self.rank_batch]

    def _randn(self, generator):
        """The global batch's noise; this rank's rows of it."""
        noise = torch.randn((self.batch_size, *self.latent_shape),
                            generator=generator, device=self.device)
        return noise if self.mesh is None else self._rows(noise)


def load_cfg_sampler(outdir, device="cuda", mesh=None) -> CFGSampler:
    """Load a serving directory of `export_cfg_sampler` on `device` (the
    type it was exported on, on this process's card of that type); a
    data-parallel one on `mesh`'s "data" axis (default: every rank of the
    process group)."""
    return CFGSampler(outdir, device, mesh)


# --------------------------------------------------------------------------
# the VQ index codec: two programs over one VQ-VAE


def export_vq_codec(encode: nn.Module, decode: nn.Module, outdir, *,
                    batch_size: int, image_size: int, latent_size: int,
                    params_dtype: str = "float32",
                    config: dict | None = None) -> dict:
    """Export the VQ-VAE index codec as a serving directory: encode(NHWC
    images [B, S, S, 3] fp32) -> int32 indices [B, h, h] and decode(indices)
    -> NHWC images, at batch `batch_size`. Returns the meta.json written."""
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    device = _device_of(encode)
    b = batch_size
    images = torch.zeros((b, image_size, image_size, 3), device=device)
    indices = torch.zeros((b, latent_size, latent_size), dtype=torch.int32,
                          device=device)
    programs = {
        "encode": export_program(encode, (images,), outdir / "encode.pt2",
                                 params_dtype),
        "decode": export_program(decode, (indices,), outdir / "decode.pt2",
                                 params_dtype),
    }
    return _write_meta(outdir, {
        "kind": "vq_codec", "programs": programs, "batch_size": b,
        "image_shape": list(images.shape), "index_shape": list(indices.shape),
        "params_dtype": params_dtype, "device": str(device),
        "config": config or {}})


def load_vq_codec(outdir, device="cuda"):
    """(encode, decode) of a codec directory, on `device` (the type it was
    exported on); each runs under `torch.inference_mode()`."""
    outdir = Path(outdir)
    meta = _read_meta(outdir, device)
    dev = torch.device(meta["device"])
    run_enc = load_program(outdir / "encode.pt2")
    run_dec = load_program(outdir / "decode.pt2")

    def encode(images):
        with torch.inference_mode():
            return run_enc(torch.as_tensor(images, dtype=torch.float32,
                                           device=dev))

    def decode(indices):
        with torch.inference_mode():
            return run_dec(torch.as_tensor(indices, dtype=torch.int32,
                                           device=dev))

    return encode, decode
