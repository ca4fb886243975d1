"""Parameter placements over the mesh: ZeRO-1, FSDP (ZeRO-3), TP and
FSDP x TP, and the train state placed by them.

Counterpart of vqgan_tpu/parallel/fsdp.py with its rules:
- `fsdp_spec_for`: one dimension of a tensor split over "data", the
  largest that divides by the axis size, the later on ties; tensors under
  `min_size` (2^14) elements, and those with no such dimension, whole.
  The rule reads the dimensions in flax's order (`jax_layout`: a
  convolution's torch [out, in, *k] is flax's [*k, in, out], a linear
  layer's [out, in] is [in, out]), so each tensor is split where JAX
  splits it.
- `sharding_spec_for`: the TP placement (tp.py), then FSDP on a dimension
  TP left free, by mode: "replicated" | "fsdp" | "tp" | "fsdp_tp".
- `state_specs`: the placements of the parameters, the Adam moments and
  the EMA copy; under "zero1" the parameters stay whole while the moments
  and the EMA are split as "fsdp" splits them.

GSPMD derives the collectives from the placements, and XLA runs them one
layer at a time. Here `ShardedState` does what they amount to, with
explicit collectives (parallel/comm.py), one module at a time:
- each module that owns parameters stored split (fsdp, fsdp_tp, and the
  split kernels of tp) gathers its own over their axes just before it
  runs (a forward pre-hook) and drops the whole copies when it returns (a
  forward hook), so in the forward only the running module's parameters
  are whole: there is no prefetch of the next module's. A module's own
  parameters stay whole through its children's forward too (the DiT's
  `pos_emb`, the root's, through the whole forward; no U-Net module that
  owns a split parameter has a child that owns one);
- the gather is an autograd function (`_Gathered`) whose output stands in
  for the parameter, and what autograd saves of it for the backward (the
  gathered tensor, its cast to the compute dtype, or a view of either) is
  kept as a note (`holding_pieces`'s saved-tensor hooks) from which the
  backward gathers it again, so that no whole parameter lives from the
  forward to the backward. Hooks on saved tensors, rather than a gather
  before each module's backward, because the tensors saved are casts
  (`models/layers.py` casts the weight to the compute dtype) that no
  module hook sees; the function's backward is where the gradient is
  complete;
- the function's backward takes the whole gradient into this rank's
  piece at once: the mean over "data" by a reduce-scatter, and along
  "model" a slice (the ranks there hold the same rows and the same
  gradient). It runs once for each gathering: a module called twice, or
  recomputed by `gradient_checkpointing`'s `torch.utils.checkpoint` (its
  recomputation gathers again, but its graph takes no gradient), adds
  each use's piece into the piece's gradient;
- under ZeRO-1 the parameters are whole and their moments split: a hook
  after each whole gradient's accumulation reduce-scatters it into the
  moments' piece and frees it;
- the parameters stored whole (small or indivisible tensors, and all of
  them under "replicated") keep one flat all-reduce after the backward
  (`mean_over_data`);
- the optimizer and the EMA update each rank's pieces only (Adam is
  elementwise, so a piece updates as it would inside the whole); the
  clipping norm is that of the whole averaged gradient, summed from the
  pieces where any gradient is split (`piece_norm`);
- after the update, ZeRO-1's whole parameters are gathered from their
  updated pieces (`pin`, the counterpart of `pin_state_shardings`).
`materialize` gathers the whole model for sampling and checkpoints, and
`reshard` frees it again; between the two the module hooks stand aside.
Parameters read outside their owner's forward are not gathered: the
DiT's GPipe path (`dit_pipeline_forward`, which reads the blocks through
`stacked_block_params`) takes a model with whole parameters.

`state_dict` gathers every piece, so a checkpoint of any mode holds whole
tensors under the names and in the format of the single-device trainer,
and `load_state_dict` splits one again.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn

from . import comm
from .mesh import mean_over_data, replicate_module
from .tp import tp_spec_for_path

__all__ = ["fsdp_spec_for", "apply_fsdp_sharding", "compose_fsdp_with_tp",
           "sharding_spec_for", "state_specs", "place_state",
           "pin_state_shardings", "shard_tensor", "gather_tensor",
           "jax_layout", "ShardedState", "MODES"]

MODES = ("replicated", "zero1", "fsdp", "tp", "fsdp_tp")
_DEFAULT_MIN_SIZE = 2 ** 14  # 16k elements = 64 KiB fp32


def jax_layout(module: nn.Module, pname: str, ndim: int):
    """(the tensor's dimensions in flax's order, whether it is a kernel)."""
    if pname == "weight" and ndim >= 2:
        if isinstance(module, nn.modules.conv._ConvTransposeNd):
            return (*range(2, ndim), 0, 1), True
        if isinstance(module, nn.modules.conv._ConvNd):
            return (*range(2, ndim), 1, 0), True
        if isinstance(module, nn.Linear):
            return (1, 0), True
    return tuple(range(ndim)), False


def _named_layouts(model: nn.Module) -> Dict[str, tuple]:
    out = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            out.setdefault(name, jax_layout(mod, pname, p.ndim))
    return out


def fsdp_spec_for(leaf, mesh, axis: str = "data",
                  min_size: int = _DEFAULT_MIN_SIZE,
                  taken: Optional[tuple] = None,
                  layout: Optional[Sequence[int]] = None) -> tuple:
    """The placement splitting ONE dimension of `leaf` over `axis`: the
    largest that divides by the axis size, the later (in `layout`, flax's
    order) on ties; dimensions in `taken` are skipped. () for small or
    indivisible tensors."""
    shape = tuple(leaf.shape)
    n = mesh.shape[axis]
    size = 1
    for s in shape:
        size *= s
    if not shape or size < min_size or n == 1:
        return ()
    layout = tuple(range(len(shape))) if layout is None else tuple(layout)
    taken = taken or ()
    best = None
    for d in layout:
        if d in taken:
            continue
        if shape[d] % n == 0:
            if best is None or shape[d] >= shape[best]:
                best = d  # >= prefers the later dim on ties
    if best is None:
        return ()
    return tuple(axis if i == best else None for i in range(len(shape)))


def sharding_spec_for(path: str, leaf, mesh, mode: str,
                      min_size: int = _DEFAULT_MIN_SIZE,
                      layout: Optional[Sequence[int]] = None,
                      is_kernel: Optional[bool] = None) -> tuple:
    """The placement of a state tensor under a parameter-sharding mode
    ('replicated' | 'fsdp' | 'tp' | 'fsdp_tp')."""
    spec = (tp_spec_for_path(path, leaf, layout, is_kernel)
            if "tp" in mode else ())
    if "fsdp" not in mode:
        return spec
    taken = tuple(i for i, s in enumerate(spec) if s is not None)
    fs = fsdp_spec_for(leaf, mesh, "data", min_size, taken=taken,
                       layout=layout)
    ndim = len(leaf.shape)
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    fs = tuple(fs) + (None,) * (ndim - len(fs))
    merged = tuple(t if t is not None else f for t, f in zip(spec, fs))
    return merged if any(a is not None for a in merged) else ()


def state_specs(model: nn.Module, mesh, mode: str,
                min_size: int = _DEFAULT_MIN_SIZE) -> Dict[str, dict]:
    """{"params", "opt", "ema"}: name -> placement of each parameter, of
    its Adam moments and of its EMA copy under `mode` (or "zero1").
    Parameters that take no gradient stay whole."""
    if mode not in MODES:
        raise ValueError(f"param_sharding must be one of {MODES}, got "
                         f"{mode!r}")
    layouts = _named_layouts(model)
    out = {"params": {}, "opt": {}, "ema": {}}
    for name, p in model.named_parameters():
        layout, kernel = layouts[name]

        def spec(m):
            if m == "replicated" or not p.requires_grad:
                return ()
            return sharding_spec_for(name, p, mesh, m, min_size, layout,
                                     kernel)

        if mode == "zero1":
            out["params"][name] = ()
            out["opt"][name] = out["ema"][name] = spec("fsdp")
        else:
            out["params"][name] = out["opt"][name] = out["ema"][name] = (
                spec(mode))
    return out


def shard_tensor(full: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's piece of `full` under `spec` (its own storage)."""
    x = full
    for d, axis in enumerate(spec):
        if axis is not None:
            x = x.chunk(mesh.shape[axis], dim=d)[mesh.coord(axis)]
    return x.clone(memory_format=torch.contiguous_format)


def gather_tensor(local: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The whole tensor from every rank's piece under `spec`."""
    x = local
    for d, axis in enumerate(spec):
        if axis is not None:
            x = comm.all_gather_cat(x, d, mesh.group(axis))
    return x


def _pieces(model: nn.Module, mesh, mode: str, min_size: int):
    specs = state_specs(model, mesh, mode, min_size)["params"]
    return {name: shard_tensor(p.detach(), specs[name], mesh)
            for name, p in model.named_parameters()}


def apply_fsdp_sharding(model: nn.Module, mesh, axis: str = "data",
                        min_size: int = _DEFAULT_MIN_SIZE) -> dict:
    """Each parameter's piece on this rank under the FSDP placement."""
    assert axis == "data", "the FSDP axis is 'data'"
    return _pieces(model, mesh, "fsdp", min_size)


def compose_fsdp_with_tp(model: nn.Module, mesh,
                         min_size: int = _DEFAULT_MIN_SIZE) -> dict:
    """Each parameter's piece under TP on "model" plus FSDP on "data"."""
    return _pieces(model, mesh, "fsdp_tp", min_size)


class _AllGatherRows(torch.autograd.Function):
    """Every data rank's rows, concatenated; the backward sums the
    cotangents over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        ctx.index = comm.group_rank(group)
        return comm.all_gather_cat(x, 0, group)

    @staticmethod
    def backward(ctx, g):
        g = comm.all_reduce_(g.contiguous().clone(), ctx.group)
        i = ctx.index * ctx.rows
        return g[i:i + ctx.rows], None


def all_gather_rows(x: torch.Tensor, mesh, axis: str = "data"):
    """Differentiable gather of every rank's rows along `axis`."""
    if not mesh.distributed:
        return x
    return _AllGatherRows.apply(x, mesh.group(axis))


class _Gathered(torch.autograd.Function):
    """The whole parameter `name` of `sharded` from this rank's piece; the
    backward takes the whole gradient into the piece
    (`ShardedState.piece_of_mean`)."""

    @staticmethod
    def forward(ctx, piece, sharded, name):
        ctx.sharded, ctx.name = sharded, name
        whole = gather_tensor(piece, sharded.param_specs[name], sharded.mesh)
        # with no process group the gather is the piece itself
        return piece.clone() if whole is piece else whole

    @staticmethod
    def backward(ctx, g):
        sharded = ctx.sharded
        sharded.regathered.pop(ctx.name, None)
        return (sharded.piece_of_mean(g, sharded.param_specs[ctx.name]),
                None, None)


class _Regather:
    """What autograd keeps of a saved gathered parameter: its name, the
    dtype of the cast saved (None: the gathered tensor itself) and the
    view's geometry."""

    __slots__ = ("name", "dtype", "size", "stride", "offset")

    def __init__(self, name, dtype, t):
        self.name, self.dtype = name, dtype
        self.size, self.stride = t.shape, t.stride()
        self.offset = t.storage_offset()


class ShardedState:
    """An `LDMTrainState` placed on `mesh` under `mode` (see the module
    docstring). It replaces the state's optimizer by one over this rank's
    pieces (same hyperparameters) and keeps the pieces of the EMA copy;
    the modules hold whole tensors for what is stored whole, and for what
    is stored split, whole tensors only while their module runs (or
    between `materialize` and `reshard`). Every rank starts from rank 0's
    values. The sharded step runs its forward inside `holding_pieces`."""

    def __init__(self, state, mesh, mode: str,
                 min_size: int = _DEFAULT_MIN_SIZE):
        self.state, self.mesh, self.mode = state, mesh, mode
        model, ema = state.model, state.ema_model
        specs = state_specs(model, mesh, mode, min_size)
        self.param_specs, self.opt_specs = specs["params"], specs["opt"]
        self.ema_specs = specs["ema"]
        self.params = dict(model.named_parameters())
        self.ema_params = dict(ema.named_parameters())
        self.trainable = [n for n, p in self.params.items()
                          if p.requires_grad]
        # whether any gradient is held in pieces smaller than the whole
        self.splits = any(self._ways(self.opt_specs[n]) > 1
                          for n in self.trainable)
        # every rank starts from rank 0's values
        replicate_module(model, mesh)
        replicate_module(ema, mesh)

        def piece(full, spec, grad):
            return (shard_tensor(full.detach(), spec, mesh)
                    .requires_grad_(grad) if spec else full)

        self.opt_tensors = {n: piece(self.params[n], self.opt_specs[n], True)
                            for n in self.trainable}
        self.ema_tensors = {n: piece(self.ema_params[n], self.ema_specs[n],
                                     False) for n in self.ema_params}
        old = state.optimizer
        group = old.inner.param_groups[0]
        state.optimizer = type(old)(
            [self.opt_tensors[n] for n in self.trainable],
            old.learning_rate, group.get("weight_decay", 0.0),
            tuple(group["betas"]), old.max_grad_norm, old.warmup_steps,
            old.every, schedule=old.schedule)
        if self.splits:
            state.optimizer.norm_fn = self.piece_norm
        self.optimizer = state.optimizer
        # name -> {dtype: the whole tensor gathered again for the backward}
        self.regathered: Dict[str, dict] = {}
        self._whole = False  # between materialize("model") and reshard
        self._owned = {}     # module -> [(attribute, parameter name)]
        for mname, mod in model.named_modules():
            for pname, _ in mod.named_parameters(recurse=False):
                n = f"{mname}.{pname}" if mname else pname
                if self.param_specs.get(n):
                    self._owned.setdefault(mod, []).append((pname, n))
        for mod in self._owned:
            mod.register_forward_pre_hook(self._gather_own)
            mod.register_forward_hook(self._drop_own, always_call=True)
        for n in self.trainable:
            if self.opt_specs[n] and not self.param_specs[n]:
                self.params[n].register_post_accumulate_grad_hook(
                    self._zero1_hook(n))
        self.reshard()

    def _ways(self, spec) -> int:
        """Into how many pieces `spec` splits a tensor."""
        out = 1
        for axis in spec:
            if axis is not None:
                out *= self.mesh.shape[axis]
        return out

    # -- one module at a time ------------------------------------------

    def _gather_own(self, module, args) -> None:
        if self._whole:
            return
        for attr, n in self._owned[module]:
            module._parameters[attr] = _Gathered.apply(
                self.opt_tensors[n], self, n)

    def _drop_own(self, module, args, out) -> None:
        if self._whole:
            return
        for attr, n in self._owned[module]:
            module._parameters[attr] = self.params[n]

    def _pack(self, t: torch.Tensor):
        base = t if t._base is None else t._base
        fn, dtype = base.grad_fn, None
        if type(fn).__name__ == "ToCopyBackward0":
            fn, dtype = fn.next_functions[0][0], base.dtype
        if (not isinstance(fn, _Gathered._backward_cls)
                or fn.sharded is not self or base.storage_offset()
                or not base.is_contiguous()):
            # detached: a tensor a node saves of its own output would
            # otherwise hold that node, and a node the backward never runs
            # (a branch the loss does not use) would live on in the cycle
            return t.detach()
        return _Regather(fn.name, dtype, t)

    def _unpack(self, saved):
        if not isinstance(saved, _Regather):
            return saved
        by_dtype = self.regathered.setdefault(saved.name, {})
        whole = by_dtype.get(saved.dtype)
        if whole is None:
            with torch.no_grad():
                whole = gather_tensor(self.opt_tensors[saved.name].detach(),
                                      self.param_specs[saved.name],
                                      self.mesh)
                if saved.dtype is not None:
                    whole = whole.to(saved.dtype)
            by_dtype[saved.dtype] = whole
        return whole.as_strided(saved.size, saved.stride, saved.offset)

    def holding_pieces(self):
        """A context within which autograd keeps a saved gathered
        parameter as a note (`_Regather`), and the backward gathers it
        again."""
        return torch.autograd.graph.saved_tensors_hooks(self._pack,
                                                        self._unpack)

    def _zero1_hook(self, name: str):
        # a weak reference: the parameter keeps its hooks where the cycle
        # collector does not look, so a strong one would keep the state
        sharded = weakref.ref(self)

        def hook(p):
            g, p.grad = p.grad, None
            placed = sharded()
            placed._add_grad(name, placed.piece_of_mean(
                g, placed.opt_specs[name]))
        return hook

    def _add_grad(self, name: str, g: torch.Tensor) -> None:
        piece = self.opt_tensors[name]
        piece.grad = g if piece.grad is None else piece.grad + g

    # -- the step's collectives ----------------------------------------

    @property
    def split_params(self):
        return [n for n, s in self.param_specs.items() if s]

    @torch.no_grad()
    def piece_of_mean(self, g: torch.Tensor, spec) -> torch.Tensor:
        """This rank's piece under `spec` of the mean over "data" of the
        whole gradient `g`: a reduce-scatter along the dimension split over
        "data" (an all-reduce of the piece where none is), and along
        "model" a slice."""
        mesh = self.mesh
        scatter = None
        for d, axis in enumerate(spec):
            if axis == "model":
                g = g.chunk(mesh.shape["model"], d)[mesh.coord("model")]
            elif axis == "data":
                scatter = d
        if not mesh.distributed:
            return g.contiguous()
        group = mesh.group("data")
        if scatter is None:
            g = comm.all_reduce_(g.clone(memory_format=torch.contiguous_format),
                                 group)
        else:
            g = comm.reduce_scatter(g, scatter, group)
        n = mesh.shape["data"]
        return g.div_(float(n)) if n > 1 else g

    def zero_grad(self) -> None:
        self.optimizer.zero_grad()
        for n in self.trainable:
            self.params[n].grad = None

    @torch.no_grad()
    def gradients(self) -> list:
        """After the backward: each trainable parameter's gradient averaged
        over "data", in its moments' placement (zero where it took no
        part). The pieces come from the backward's hooks; the gradients of
        what is stored whole are averaged here, in one flat all-reduce."""
        whole = [n for n in self.trainable if not self.opt_specs[n]]
        grads = []
        for n in whole:
            p = self.params[n]
            grads.append(p.grad if p.grad is not None
                         else torch.zeros_like(p))
            p.grad = None
        means = dict(zip(whole, mean_over_data(grads, self.mesh)))
        self.regathered.clear()
        out = []
        for n in self.trainable:
            if n in means:
                out.append(means[n])
            else:
                piece = self.opt_tensors[n]
                out.append(piece.grad if piece.grad is not None
                           else torch.zeros_like(piece))
        return out

    @torch.no_grad()
    def reshard(self) -> None:
        """Free the model's gathered copies of split parameters, and the
        EMA module's tensors that the EMA keeps in pieces."""
        self._whole = False
        for n in self.split_params:
            self.params[n].data = self.params[n].data.new_empty(0)
        for n, spec in self.ema_specs.items():
            if spec:
                self.ema_params[n].data = self.ema_params[n].data.new_empty(0)

    @torch.no_grad()
    def pin(self) -> None:
        """ZeRO-1: the whole parameters again, from their updated pieces."""
        for n in self.trainable:
            if self.opt_specs[n] and not self.param_specs[n]:
                self.params[n].data.copy_(gather_tensor(
                    self.opt_tensors[n], self.opt_specs[n], self.mesh))

    def piece_norm(self, pieces: list) -> torch.Tensor:
        """The global norm of a gradient held in pieces (each step's, and
        the accumulated gradient of MultiSteps k > 1): each piece's sum of
        squares over the ranks that hold it once."""
        world = comm.group_size(None) if self.mesh.distributed else 1
        total = torch.zeros((), dtype=torch.float32,
                            device=pieces[0].device)
        for n, g in zip(self.trainable, pieces):
            split = self._ways(self.opt_specs[n])
            total = total + g.float().pow(2).sum() * (split / world)
        if self.mesh.distributed:
            comm.all_reduce_(total, None)
        return total.sqrt()

    def ema_sources(self) -> list:
        """The tensors the EMA follows, each in its EMA piece's placement
        (the moments' placement), in the order of the EMA module's
        parameters."""
        return [self.opt_tensors[n] if self.ema_specs[n] else self.params[n]
                for n in self.ema_params]

    def ema_targets(self) -> list:
        return [self.ema_tensors[n] for n in self.ema_params]

    # -- whole tensors -------------------------------------------------

    @torch.no_grad()
    def gathered(self, which: str = "model") -> Dict[str, torch.Tensor]:
        """The whole parameters of the model or of its EMA copy."""
        if which == "model":
            return {n: (gather_tensor(self.opt_tensors[n],
                                      self.param_specs[n], self.mesh)
                        if self.param_specs[n] else self.params[n].detach())
                    for n in self.params}
        return {n: (gather_tensor(self.ema_tensors[n], self.ema_specs[n],
                                  self.mesh)
                    if self.ema_specs[n] else self.ema_params[n].detach())
                for n in self.ema_params}

    @torch.no_grad()
    def materialize(self, which: str = "ema") -> nn.Module:
        """The model (or the EMA copy) with every parameter whole again,
        for sampling; `reshard` frees it."""
        module = self.state.model if which == "model" else (
            self.state.ema_model)
        params = self.params if which == "model" else self.ema_params
        self._whole = self._whole or which == "model"
        for n, t in self.gathered(which).items():
            params[n].data = t
        return module

    def _module_state(self, module: nn.Module, params: dict) -> dict:
        out = {}
        for k, v in module.state_dict().items():
            out[k] = params[k] if k in params else v
        return out

    @torch.no_grad()
    def state_dict(self) -> dict:
        """The single-device trainer's state dict, every tensor whole."""
        opt = self.optimizer.state_dict()
        inner = opt["inner"]
        state = {}
        for i, n in enumerate(self.trainable):
            s = inner["state"].get(i)
            if s is None:
                continue
            spec = self.opt_specs[n]
            state[i] = {k: (gather_tensor(v, spec, self.mesh)
                            if spec and torch.is_tensor(v) and v.ndim
                            else v) for k, v in s.items()}
        acc = opt["acc"]
        if acc is not None:
            acc = [gather_tensor(a, self.opt_specs[n], self.mesh)
                   if self.opt_specs[n] else a
                   for n, a in zip(self.trainable, acc)]
        return {"step": self.state.step,
                "model": self._module_state(self.state.model,
                                            self.gathered("model")),
                "ema": self._module_state(self.state.ema_model,
                                          self.gathered("ema")),
                "optimizer": {**opt, "inner": {**inner, "state": state},
                              "acc": acc}}

    @torch.no_grad()
    def load_state_dict(self, full: dict) -> None:
        """Place a single-device state dict (whole tensors) again."""
        self.state.step = int(full["step"])
        for which, params, tensors, specs in (
                ("model", self.params, self.opt_tensors, self.param_specs),
                ("ema", self.ema_params, self.ema_tensors, self.ema_specs)):
            for k, v in full[which].items():
                if k not in params:
                    continue
                v = v.to(params[k].device, params[k].dtype)
                if which == "model" and k in self.opt_tensors:
                    spec = self.opt_specs[k]
                    if spec:
                        self.opt_tensors[k].copy_(
                            shard_tensor(v, spec, self.mesh))
                    if not self.param_specs[k]:
                        params[k].data = v.clone()
                elif which == "ema" and specs[k]:
                    tensors[k].copy_(shard_tensor(v, specs[k], self.mesh))
                else:
                    params[k].data = v.clone()
        buffers = dict(self.state.model.named_buffers())
        for k, v in full["model"].items():
            if k in buffers:
                buffers[k].copy_(v)
        opt = full["optimizer"]
        inner = opt["inner"]
        state = {}
        for i, n in enumerate(self.trainable):
            s = inner["state"].get(i)
            if s is None:
                continue
            spec = self.opt_specs[n]
            state[i] = {k: (shard_tensor(v, spec, self.mesh)
                            if spec and torch.is_tensor(v) and v.ndim
                            else v) for k, v in s.items()}
        acc = opt["acc"]
        if acc is not None:
            acc = [shard_tensor(a, self.opt_specs[n], self.mesh)
                   if self.opt_specs[n] else a
                   for n, a in zip(self.trainable, acc)]
        self.optimizer.load_state_dict(
            {**opt, "inner": {**inner, "state": state}, "acc": acc})
        self.reshard()


def place_state(state, mesh, mode: str,
                min_size: int = _DEFAULT_MIN_SIZE) -> ShardedState:
    """Place a whole train state (parameters, Adam moments, EMA) under a
    parameter-sharding mode: 'replicated' | 'zero1' | 'fsdp' | 'tp' |
    'fsdp_tp'."""
    return ShardedState(state, mesh, mode, min_size)


def pin_state_shardings(step_fn: Callable, placed: ShardedState) -> Callable:
    """Wrap a step so that the state keeps its placement after it: under
    ZeRO-1 the whole parameters are gathered again from their updated
    pieces, as JAX's sharding constraint keeps them replicated."""

    def wrapped(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        placed.pin()
        return out

    return wrapped
