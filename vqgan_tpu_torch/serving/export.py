"""Serving artifacts with `torch.export`: programs that run with no model
code.

Counterpart of vqgan_tpu/serving/export.py. An artifact is a directory:

    <program>.pt2   a program saved with `torch.export.save`, weights inside
    meta.json       config, batch size, shapes, export device, export
                    seconds and bytes of each program, the mesh and the
                    split parameters' specs
    split_weights.pt  the whole tensors of the split parameters (only
                    where `param_specs` splits some)

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
  the whole batch.
- Tensor-parallel artifacts (`param_specs`, e.g. `parallel.tp.
  tp_param_specs` of each program: the to_qkv / to_q / to_k / to_v
  kernels split on their output features over "model", the to_out
  kernels on their input features), on a mesh of any axes ("data" x
  "model" in JAX's order): each program is traced with piece-shaped
  parameters, and gathers each whole kernel from the ranks' pieces where
  it runs (`torch.ops.vqgan_tpu_torch.tp_gather`), as GSPMD gathers a
  kernel whose placement its consumer does not take. So a rank's device
  holds only its pieces of the split kernels between calls, and the
  images are those of the whole-weight artifact bit for bit. As JAX
  saves whole weights and places them at load, `split_weights.pt` holds
  the whole split tensors and the loader writes this rank's pieces into
  its programs, so one directory serves any ranks of the same axis
  layout. The call-time inputs are split over "data" and whole over the
  other axes, as above.
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
from ..kernels import ops

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
    constants. A parameter that `splits` places over axes of a mesh of
    `mesh_shape` is stored as a piece (the first rank's; a loader writes
    its own) and gathered whole where the program runs; `wholes` keeps
    the whole stored tensors of those."""

    def __init__(self, module: nn.Module, dtype, splits=None,
                 mesh_shape=None):
        super().__init__()
        object.__setattr__(self, "_module", module)  # not a submodule
        self._params = []
        self.wholes = {}
        for name, p in module.named_parameters():
            stored = p.detach()
            if dtype is not None and p.is_floating_point():
                stored = stored.to(dtype)
            gathers = tuple((d, mesh_shape[axis], axis) for d, axis in
                            enumerate((splits or {}).get(name, ()))
                            if axis is not None)
            if gathers:
                self.wholes[name] = stored.cpu()
                for d, n, _ in gathers:
                    stored = stored.chunk(n, dim=d)[0]
                stored = stored.clone(memory_format=torch.contiguous_format)
            self.register_parameter(_flat(name),
                                    nn.Parameter(stored, requires_grad=False))
            self._params.append((name, p.dtype, gathers))

    def forward(self, *args):
        state = {}
        for name, dtype, gathers in self._params:
            t = getattr(self, _flat(name))
            for d, n, axis in gathers:
                t = ops.tp_gather_op(t, d, n, axis)
            state[name] = t.to(dtype)
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
                   params_dtype: str = "float32", splits=None,
                   mesh_shape=None) -> dict:
    """Trace `module` with `torch.export` at `example_args`' shapes (no
    gradient), its floating weights stored in `params_dtype` and those that
    `splits` places over a mesh of `mesh_shape` as pieces gathered where
    it runs (`_StoredWeights`), and save it to `path` (a .pt2 file).
    Returns {"seconds": export and save, "bytes": the file's size}, and
    with `splits` "wholes": the whole stored tensors of the split
    parameters, by name."""
    if params_dtype not in _DTYPES:
        raise ValueError(f"params_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {params_dtype!r}")
    t0 = time.perf_counter()
    program = _StoredWeights(module.eval(), _DTYPES[params_dtype], splits,
                             mesh_shape)
    with torch.no_grad():
        exported = torch.export.export(program, tuple(example_args))
    torch.export.save(exported, str(path))
    out = {"seconds": time.perf_counter() - t0,
           "bytes": Path(path).stat().st_size}
    if splits:
        out["wholes"] = program.wholes
    return out


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


def _layout(mesh, arg_specs, param_specs, batch_size: int, programs: dict):
    """(the data-parallel degree, meta.json's "mesh", the split parameters
    of each program: name -> spec) of an export; (1, None, {}) without a
    mesh."""
    if mesh is None:
        for name, given in (("arg_specs", arg_specs),
                            ("param_specs", param_specs)):
            if given is not None:
                raise ValueError(f"{name} needs a mesh")
        return 1, None, {}
    for spec in arg_specs or ():
        if tuple(spec)[:1] not in ((), ("data",), (None,)) or any(
                a is not None for a in tuple(spec)[1:]):
            raise NotImplementedError(
                f"call-time inputs split over 'data' or whole, got {spec}")
    splits = {}
    for prog, specs in (param_specs or {}).items():
        if prog not in programs:
            raise ValueError(f"param_specs: no program {prog!r}; the "
                             f"programs are {sorted(programs)}")
        params = dict(programs[prog].named_parameters())
        splits[prog] = {}
        for name, spec in specs.items():
            if name not in params:
                raise ValueError(f"param_specs: {prog} has no parameter "
                                 f"{name!r}")
            shape = tuple(params[name].shape)
            spec = tuple(spec) + (None,) * (len(shape) - len(spec))
            axes = [a for a in spec if a is not None]
            if len(spec) > len(shape) or len(set(axes)) != len(axes) or any(
                    a not in mesh.shape for a in axes):
                raise ValueError(f"param_specs: {prog}.{name} {shape} cannot "
                                 f"take {spec} on a mesh {mesh.shape}")
            for d, a in enumerate(spec):
                if a is not None and shape[d] % mesh.shape[a]:
                    raise ValueError(
                        f"param_specs: {prog}.{name}: dimension {d} of "
                        f"{shape} does not divide over {mesh.shape[a]} "
                        f"{a!r} ranks")
            if axes:
                splits[prog][name] = spec
    dp = mesh.shape.get("data", 1)
    if batch_size % dp:
        raise ValueError(f"batch {batch_size} does not divide over dp={dp}")
    if not any(splits.values()) and all(
            n == 1 for a, n in mesh.shape.items() if a != "data"):
        # only the batch is split: the one-axis record of a data-parallel
        # artifact, which needs no mesh where dp is 1
        layout = ({"axes": ["data"], "shape": [dp], "nr_devices": dp}
                  if dp > 1 else None)
    else:
        layout = {"axes": list(mesh.shape), "shape": list(mesh.shape.values()),
                  "nr_devices": mesh.size}
    return dp, layout, splits


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
    the loader loops over, in order. `mesh` makes a multi-rank artifact:
    its "data" axis (dp ranks) splits the batch, so the programs run
    B / dp rows on each rank, and `param_specs` ({"step": {name: spec},
    "decode": {...}}, a spec per parameter as `parallel.tp.tp_param_specs`
    gives them; the parameters it does not list stay whole) splits
    weights over its axes. The mesh is only read for its shape: the
    export runs in one process. Returns the meta.json written."""
    programs = {"step": step, "decode": decode}
    dp, layout, splits = _layout(mesh, arg_specs, param_specs, batch_size,
                                 programs)
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
    examples = {"step": (img(), labels(), labels(), labels(), img()),
                "decode": (img(),)}
    exported, wholes = {}, {}
    for name, module in programs.items():
        out = export_program(module, examples[name], outdir / f"{name}.pt2",
                             params_dtype, splits.get(name),
                             None if mesh is None else mesh.shape)
        wholes[name] = out.pop("wholes", {})
        exported[name] = out
    meta = {"kind": "cfg_sampler", "programs": exported,
            "batch_size": batch_size, "rank_batch_size": b, "mesh": layout}
    if any(splits.values()):
        torch.save(wholes, outdir / "split_weights.pt")
        meta["param_specs"] = {name: {p: list(spec) for p, spec in
                                      specs.items()}
                               for name, specs in splits.items()}
    return _write_meta(outdir, {
        **meta, "latent_shape": list(latent_shape),
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

    A multi-rank artifact runs on `mesh` (by default a mesh of meta.json's
    axes over every rank of the process group, as JAX's loader builds one
    over the first devices), which must have the artifact's axes: each
    rank takes its "data" rows of the classes and of the global batch's
    noise, and the images of all "data" ranks are gathered, so each rank
    returns [B, H, W, 3]. Where the artifact splits weights, this rank's
    pieces of them are written into its programs from split_weights.pt,
    and the programs gather them over their axes' groups when they run. A
    CUDA graph captures those gathers only where NCCL runs them: over a
    gloo group `graph` True raises, rather than run eagerly, and None runs
    eagerly."""

    def __init__(self, outdir, device="cuda", mesh=None):
        outdir = Path(outdir)
        self.meta = _read_meta(outdir, device)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        saved = torch.device(self.meta["device"])
        if saved.type == "cuda" and saved.index is None:
            saved = torch.device("cuda", 0)
        # a rank of a multi-rank artifact runs it on its own card
        location = ({str(saved): str(self.device)}
                    if saved != self.device else None)
        self.batch_size = int(self.meta["batch_size"])
        self.rank_batch = int(self.meta.get("rank_batch_size",
                                            self.batch_size))
        self.mesh, self._dp = None, 1
        layout = self.meta.get("mesh")
        if layout is not None:
            from ..parallel.mesh import mesh_like

            shape = dict(zip(layout["axes"], layout["shape"]))
            self.mesh = mesh or mesh_like(layout, self.device)
            self._dp = shape.get("data", 1)
            for axis, n in shape.items():
                if self.mesh.shape.get(axis, 1) == n:
                    continue
                if axis == "data":
                    raise ValueError(f"{outdir} serves on {n} data-parallel "
                                     f"ranks, the mesh has {self.mesh.shape}")
                raise ValueError(f"{outdir} serves on a {axis!r} axis of {n} "
                                 f"ranks, the mesh has {self.mesh.shape}")
        self.num_users = int(self.meta["num_users"])
        self.latent_shape = tuple(self.meta["latent_shape"])
        self._step = load_program(outdir / "step.pt2", location)
        self._decode = load_program(outdir / "decode.pt2", location)
        splits = self.meta.get("param_specs") or {}
        self._axes = {}
        if any(splits.values()):
            wholes = torch.load(outdir / "split_weights.pt",
                                map_location="cpu", weights_only=True,
                                mmap=True)
            for name, program in (("step", self._step),
                                  ("decode", self._decode)):
                self._place_pieces(program, splits.get(name, {}),
                                   wholes.get(name, {}))
            self._axes = {a: self.mesh.group(a) for specs in splits.values()
                          for spec in specs.values() for a in spec
                          if a is not None}
        pairs = torch.tensor(self.meta["ddim_pairs"], dtype=torch.long,
                             device=self.device)
        self._pairs = pairs[:, :, None].expand(-1, -1, self.rank_batch)
        self.graphs = ChainGraphs()

    @torch.no_grad()
    def _place_pieces(self, program, specs: dict, wholes: dict) -> None:
        """Write this rank's piece of each whole split tensor into the
        parameter that holds it in `program`."""
        for name, spec in specs.items():
            piece = wholes[name]
            for d, axis in enumerate(spec):
                if axis is not None:
                    piece = piece.chunk(self.mesh.shape[axis], dim=d)[
                        self.mesh.coord(axis)]
            param = program.get_parameter(_flat(name))
            if param.shape != piece.shape:
                raise ValueError(f"split_weights.pt's {name}: a piece of "
                                 f"{tuple(piece.shape)}, the program holds "
                                 f"{tuple(param.shape)}")
            param.copy_(piece)

    def weight_bytes(self) -> dict:
        """{"held": the bytes of every parameter this rank's programs hold,
        "split_held": of it the split parameters' pieces, "split_whole":
        those parameters' whole bytes}."""
        splits = self.meta.get("param_specs") or {}
        held = split_held = split_whole = 0
        for name, program in (("step", self._step), ("decode", self._decode)):
            specs = {_flat(k): v for k, v in splits.get(name, {}).items()}
            for pname, p in program.named_parameters():
                n = p.numel() * p.element_size()
                held += n
                spec = specs.get(pname)
                if spec is not None:
                    split_held += n
                    split_whole += n * int(np.prod(
                        [self.mesh.shape[a] for a in spec if a is not None]))
        return {"held": held, "split_held": split_held,
                "split_whole": split_whole}

    def _graph(self, graph: Optional[bool]) -> bool:
        """Whether the loop runs as a CUDA graph: `resolve_graph`'s rule,
        where NCCL runs the weights' gathers or there are none."""
        hosted = [a for a, g in self._axes.items()
                  if g is not None and torch.distributed.get_backend(g)
                  != "nccl"]
        if hosted and graph:
            raise ValueError(
                f"graph=True: the weights' gathers over {hosted} run on "
                f"gloo, which a CUDA graph cannot capture; an NCCL group "
                f"replays them (graph=False runs eagerly)")
        return False if hosted else resolve_graph(graph, self.device)

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
        if self._dp > 1:
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
                         graph=self._graph(graph), name="served DDIM step")
        with torch.inference_mode(), ops.mesh_axes(self._axes):
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
        if self._dp > 1:
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
        return noise if self._dp == 1 else self._rows(noise)


def load_cfg_sampler(outdir, device="cuda", mesh=None) -> CFGSampler:
    """Load a serving directory of `export_cfg_sampler` on `device` (the
    type it was exported on, on this process's card of that type); a
    multi-rank one on `mesh` (default: meta.json's axes over every rank of
    the process group)."""
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
