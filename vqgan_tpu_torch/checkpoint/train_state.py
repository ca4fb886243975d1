"""The JAX package's train states as the port's state dicts, so that a
trainer of the port resumes a run that the JAX package saved.

A milestone of the JAX package's trainers (`model-{m}/`, `vqgan-{m}/`)
holds the whole train state, read by `orbax.read_orbax` as nested dicts:
- `LDMTrainState` (the LDM, Diffusers-style and DDPM trainers): `step`
  (micro-steps taken), `params`, `ema_params`, `opt_state`;
- `VQGANTrainState`: `step`, `vqvae_params`, `disc_params`, `disc_stats`
  (the discriminator's BatchNorm running statistics), `opt_g`, `opt_d`.

Each `opt_state` is `make_ldm_optimizer`'s (or `make_gan_optimizers`')
optax chain, read back as lists (tuples) and dicts (named tuples), with
an empty state as None:
- `chain(clip_by_global_norm, adam | adamw)`: [clip (empty), inner], or
  [inner] without clipping;
- adam's inner chain: [ScaleByAdamState(count, mu, nu), the learning
  rate's state]; adamw's: [ScaleByAdamState, add_decayed_weights (empty),
  the learning rate's state]; the learning rate's state is
  ScaleByScheduleState(count) under a warmup schedule, else empty;
- with gradient accumulation k > 1 all of it inside
  MultiStepsState(mini_step, gradient_step, inner_opt_state, acc_grads,
  skip_state).

The form is read from the port optimizer's own settings (clipping, weight
decay, schedule, accumulation); a tree of another form is refused with a
message that says which. `mu`, `nu` and `acc_grads` have the parameters'
tree and go through the parameters' own `from_jax` converter: the
converters only rearrange (transpose, flip the taps, reshape), so each
moment carries over element for element. Adam's `count` is the port's
update count and every parameter's Adam `step`; a schedule's count must
equal it. MultiSteps' running mean of the gradients,
acc + (g - acc) / (n + 1) with n the mini-step, is the port's `acc`
(`ldm_step.LDMOptimizer.step`), taken as is. Nothing is zero-filled: a
missing, extra or mis-shaped leaf raises, naming its path. JAX's PRNG key
is not part of the state: the port draws its own noise after a resume.

The result is exactly the dict the port's own `state_dict()` gives
(`LDMTrainState`, `VQGANTrainState`, `parallel.fsdp.ShardedState`), so the
port's `load_state_dict` takes it: the eager `LDMOptimizer`, the
`CapturableOptimizer` and a sharded state alike.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .load import jax_state_for

__all__ = ["optimizer_state_from_jax", "train_state_from_jax"]

_MULTI_STEPS = {"mini_step", "gradient_step", "inner_opt_state", "acc_grads",
                "skip_state"}


def _empty(node) -> bool:
    return node is None or (isinstance(node, (dict, list)) and not node)


def _describe(node) -> str:
    if isinstance(node, dict):
        return f"a state with fields {sorted(node)}"
    if isinstance(node, list):
        return f"a chain of {len(node)} states"
    return "an empty state" if node is None else f"a {type(node).__name__}"


def _int(node, where: str) -> int:
    a = np.asarray(node)
    if a.shape != () or a.dtype.kind not in "iu":
        raise ValueError(f"{where}: an integer count expected, got "
                         f"{a.dtype} {a.shape}")
    return int(a)


def _leaves(node, path=()) -> Dict[tuple, np.ndarray]:
    if isinstance(node, dict):
        node = node.items()
    elif isinstance(node, list):
        node = enumerate(node)
    else:
        return {path: node}
    out = {}
    for key, child in node:
        out.update(_leaves(child, (*path, str(key))))
    return out


def _check_like(tree, params, where: str) -> None:
    """`tree` has the leaves of `params`, path for path and shape for
    shape."""
    got, want = _leaves(tree), _leaves(params)
    for path, leaf in want.items():
        name = ".".join((where, *path))
        if path not in got:
            raise ValueError(f"{name} is missing: the parameters have a "
                             f"leaf there")
        if np.shape(got[path]) != np.shape(leaf):
            raise ValueError(f"{name} has shape {np.shape(got[path])}, its "
                             f"parameter {np.shape(leaf)}")
    for path in got:
        if path not in want:
            raise ValueError(f"{'.'.join((where, *path))}: no parameter "
                             f"has this leaf")


def _convert(convert: Callable, tree, where: str) -> dict:
    try:
        return convert(tree)
    except KeyError as e:
        raise ValueError(f"{where}: the converter finds no leaf {e}") from e


def _per_parameter(convert, tree, params, names, shapes, where: str
                   ) -> List[torch.Tensor]:
    """`tree` (a moment or the accumulated gradient) as one fp32 tensor
    per trainable parameter, in the optimizer's order."""
    if params is not None:
        _check_like(tree, params, where)
    state = _convert(convert, tree, where)
    missing = [n for n in names if n not in state]
    extra = sorted(set(state) - set(names))
    if missing or extra:
        raise ValueError(f"{where}: the converted tree lacks the port "
                         f"optimizer's {missing[:3]} and has {extra[:3]}, "
                         f"which it does not train")
    out = []
    for n in names:
        if tuple(state[n].shape) != tuple(shapes[n]):
            raise ValueError(f"{where}: {n} converts to shape "
                             f"{tuple(state[n].shape)}, the parameter is "
                             f"{tuple(shapes[n])}")
        out.append(state[n])
    return out


def _adam_chain(tree, optimizer, where: str):
    """(ScaleByAdamState, the schedule's count or None) of the chain the
    port optimizer's settings build, checked for that form."""
    decay = optimizer.inner.param_groups[0].get("weight_decay", 0.0) > 0
    clip = optimizer.max_grad_norm is not None
    scheduled = optimizer.schedule is not None or optimizer.warmup_steps > 0
    adam = "adamw" if decay else "adam"
    form = (f"{'clip_by_global_norm then ' if clip else ''}optax.{adam} "
            f"with {'a schedule' if scheduled else 'a constant rate'}")
    n_outer = 2 if clip else 1
    if not isinstance(tree, list) or len(tree) != n_outer:
        raise ValueError(f"{where}: the port's optimizer is {form}, whose "
                         f"chain keeps {n_outer} state(s); the tree holds "
                         f"{_describe(tree)}")
    if clip and not _empty(tree[0]):
        raise ValueError(f"{where}.0: clip_by_global_norm keeps an empty "
                         f"state; the tree holds {_describe(tree[0])}")
    where = f"{where}.{n_outer - 1}"
    inner = tree[-1]
    n_inner = 3 if decay else 2
    if not isinstance(inner, list) or len(inner) != n_inner:
        written = ("" if not isinstance(inner, list) else
                   " (optax.adamw: weight decay)" if len(inner) == 3 else
                   " (optax.adam: no weight decay)" if len(inner) == 2
                   else "")
        raise ValueError(f"{where}: the port's optimizer is {form}, and "
                         f"optax.{adam} keeps {n_inner} states; the tree "
                         f"holds {_describe(inner)}{written}")
    state = inner[0]
    if not isinstance(state, dict) or set(state) != {"count", "mu", "nu"}:
        raise ValueError(f"{where}.0: ScaleByAdamState (count, mu, nu) "
                         f"expected, got {_describe(state)}")
    if decay and not _empty(inner[1]):
        raise ValueError(f"{where}.1: add_decayed_weights keeps an empty "
                         f"state; the tree holds {_describe(inner[1])}")
    lr = inner[-1]
    lr_where = f"{where}.{n_inner - 1}"
    if scheduled:
        if not isinstance(lr, dict) or set(lr) != {"count"}:
            raise ValueError(f"{lr_where}: the port's optimizer follows a "
                             f"learning-rate schedule, whose "
                             f"ScaleByScheduleState(count) the tree lacks "
                             f"({_describe(lr)}): it was written with a "
                             f"constant rate")
        return state, _int(lr["count"], f"{lr_where}.count")
    if not _empty(lr):
        raise ValueError(f"{lr_where}: the tree holds a schedule's state "
                         f"({_describe(lr)}); the port's optimizer has a "
                         f"constant learning rate")
    return state, None


def _trainable_names(model, optimizer) -> List[str]:
    """The model's names of the optimizer's parameters, in its order."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    names = [by_id.get(id(p)) for p in optimizer.params]
    if None in names:
        raise ValueError("the optimizer holds a tensor that is not a "
                         "parameter of the model")
    return names


def optimizer_state_from_jax(opt_tree, optimizer, model,
                             convert: Optional[Callable] = None, *,
                             params=None,
                             names: Optional[Sequence[str]] = None,
                             shapes: Optional[dict] = None,
                             param_groups: Optional[list] = None,
                             where: str = "opt_state") -> dict:
    """`opt_tree`, an optax state of the JAX package read by `read_orbax`,
    as `optimizer.state_dict()` would give it (`LDMOptimizer`'s form).

    `convert` maps a tree of the model's JAX parameters onto its state
    dict (by default the converter of the model's class,
    `load.jax_state_for`); `params`, the JAX parameter tree, makes each
    moment match it leaf for leaf first. `names` (the optimizer's
    parameters' names in its order; by default read from `model` by
    identity), `shapes` (their whole shapes) and `param_groups` (the torch
    optimizer's) stand in for the model's and the optimizer's own where
    those hold pieces (a sharded state). `where` names the tree in the
    messages."""
    if convert is None:
        def convert(tree):
            return jax_state_for(model, tree)
    if names is None:
        names = _trainable_names(model, optimizer)
    if shapes is None:
        shapes = {n: p.shape for n, p in model.named_parameters()}
    if param_groups is None:
        param_groups = optimizer.inner.state_dict()["param_groups"]
    multi = isinstance(opt_tree, dict) and set(opt_tree) == _MULTI_STEPS
    if optimizer.every > 1:
        if not multi:
            raise ValueError(
                f"{where}: the port's optimizer accumulates "
                f"{optimizer.every} gradients per update (optax.MultiSteps); "
                f"the tree holds {_describe(opt_tree)}, no MultiStepsState")
        mini = _int(opt_tree["mini_step"], f"{where}.mini_step")
        if not 0 <= mini < optimizer.every:
            raise ValueError(f"{where}.mini_step is {mini}, outside "
                             f"0..{optimizer.every - 1}")
        if not _empty(opt_tree["skip_state"]):
            raise ValueError(f"{where}.skip_state: the JAX package skips no "
                             f"update; the tree holds "
                             f"{_describe(opt_tree['skip_state'])}")
        adam, schedule_count = _adam_chain(
            opt_tree["inner_opt_state"], optimizer,
            f"{where}.inner_opt_state")
        acc = _per_parameter(convert, opt_tree["acc_grads"], params, names,
                             shapes, f"{where}.acc_grads")
        gradient_step = _int(opt_tree["gradient_step"],
                             f"{where}.gradient_step")
        adam_where = f"{where}.inner_opt_state"
    else:
        if multi:
            raise ValueError(
                f"{where}: the tree is optax.MultiSteps' (gradient "
                f"accumulation); the port's optimizer takes one gradient "
                f"per update (gradient_accumulate_every 1)")
        adam, schedule_count = _adam_chain(opt_tree, optimizer, where)
        mini, acc, gradient_step, adam_where = 0, None, None, where
    adam_where += f".{1 if optimizer.max_grad_norm is not None else 0}.0"
    count = _int(adam["count"], f"{adam_where}.count")
    if schedule_count is not None and schedule_count != count:
        raise ValueError(f"the schedule's count {schedule_count} disagrees "
                         f"with Adam's count {count} ({adam_where}.count): "
                         f"the warmup would resume at another update")
    if gradient_step is not None and gradient_step != count:
        raise ValueError(f"{where}.gradient_step {gradient_step} disagrees "
                         f"with Adam's count {count}")
    mu = _per_parameter(convert, adam["mu"], params, names, shapes,
                        f"{adam_where}.mu")
    nu = _per_parameter(convert, adam["nu"], params, names, shapes,
                        f"{adam_where}.nu")
    step = torch.tensor(float(count))
    return {"inner": {"state": {i: {"step": step.clone(), "exp_avg": m,
                                    "exp_avg_sq": v}
                                for i, (m, v) in enumerate(zip(mu, nu))},
                      "param_groups": param_groups},
            "count": count, "mini_step": mini, "acc": acc}


def _module_state(template: dict, state: dict, where: str) -> dict:
    """`state` (converted from JAX) on the keys, shapes and dtypes of the
    port module's `template`."""
    missing = [k for k in template if k not in state]
    extra = sorted(set(state) - set(template))
    if missing or extra:
        raise ValueError(f"{where}: the converted tree lacks the port "
                         f"module's {missing[:3]} and has {extra[:3]}, which "
                         f"the module does not")
    out = {}
    for k, v in template.items():
        if tuple(state[k].shape) != tuple(v.shape):
            raise ValueError(f"{where}: {k} converts to shape "
                             f"{tuple(state[k].shape)}, the module's is "
                             f"{tuple(v.shape)}")
        out[k] = state[k].to(v.dtype)
    return out


def _optimizer(tree, template: dict, optimizer, model, params, names,
               where: str) -> dict:
    shapes = {n: template["model"][n].shape for n in names}
    groups = template["optimizer"]["inner"]["param_groups"]
    dtypes = [template["model"][n].dtype for n in names]
    out = optimizer_state_from_jax(
        tree, optimizer, model, params=params, names=names, shapes=shapes,
        param_groups=groups, where=where)
    for i, dtype in enumerate(dtypes):  # the moments in the parameters'
        s = out["inner"]["state"][i]    # dtype, as torch's Adam keeps them
        s["exp_avg"], s["exp_avg_sq"] = (s["exp_avg"].to(dtype),
                                         s["exp_avg_sq"].to(dtype))
    if out["acc"] is not None:
        out["acc"] = [a.to(d) for a, d in zip(out["acc"], dtypes)]
    return out


def _vqgan_state_from_jax(tree, state) -> dict:
    template = state.state_dict()
    disc_vars = {**tree["disc_params"], **(tree["disc_stats"] or {})}
    # the port's BatchNorm keeps the running mean and variance only, the
    # buffers of JAX's batch_stats (no num_batches_tracked): every buffer
    # of the discriminator comes from disc_stats
    out = {"step": _int(tree["step"], "step"),
           "vqvae": _module_state(template["vqvae"], jax_state_for(
               state.vqvae, tree["vqvae_params"]), "vqvae_params"),
           "disc": _module_state(template["disc"], jax_state_for(
               state.disc, disc_vars), "disc_params + disc_stats")}
    for key, module, params, opt in (
            ("opt_g", state.vqvae, tree["vqvae_params"], state.opt_g),
            ("opt_d", state.disc, tree["disc_params"], state.opt_d)):
        names = _trainable_names(module, opt)
        part = {"model": template["vqvae" if key == "opt_g" else "disc"],
                "optimizer": template[key]}
        out[key] = _optimizer(tree[key], part, opt, module, params, names,
                              key)
    return out


def _ldm_state_from_jax(tree, state) -> dict:
    template = state.state_dict()
    sharded = getattr(state, "trainable", None)  # a ShardedState
    inner = state.state if sharded is not None else state
    model, optimizer = inner.model, inner.optimizer
    names = (list(sharded) if sharded is not None
             else _trainable_names(model, optimizer))
    return {"step": _int(tree["step"], "step"),
            "model": _module_state(template["model"], jax_state_for(
                model, tree["params"]), "params"),
            "ema": _module_state(template["ema"], jax_state_for(
                inner.ema_model, tree["ema_params"]), "ema_params"),
            "optimizer": _optimizer(tree["opt_state"], template, optimizer,
                                    model, tree["params"], names,
                                    "opt_state")}


def train_state_from_jax(tree: dict, state) -> dict:
    """`tree`, the JAX package's train state as `read_orbax` reads a
    trainer's milestone, as `state.state_dict()` would give it. `state` is
    the port's `LDMTrainState` (the LDM, Diffusers-style and DDPM
    trainers), its `ShardedState` (a trainer under `param_sharding`), or
    a `VQGANTrainState`; the JAX state must be the counterpart's, with
    the optimizer form of `state`'s optimizers. A model without a
    converter raises TypeError (`load.jax_state_for`)."""
    if hasattr(state, "opt_g"):
        wanted = {"step", "vqvae_params", "disc_params", "disc_stats",
                  "opt_g", "opt_d"}
        convert = _vqgan_state_from_jax
    else:
        wanted = {"step", "params", "ema_params", "opt_state"}
        convert = _ldm_state_from_jax
    if set(tree) != wanted:
        raise ValueError(f"the JAX train state has {sorted(tree)}; the "
                         f"port's {type(state).__name__} resumes "
                         f"{sorted(wanted)}")
    return convert(tree, state)
