"""Read the JAX package's Orbax checkpoints as nested dicts of numpy arrays,
with no JAX, Orbax, TensorStore or zarr.

A checkpoint directory that `orbax.checkpoint.StandardCheckpointer` writes
(the JAX package's `CheckpointManager` milestones `{prefix}-{m}/`, and the
KL-VAE parameters of its `train_kl_vae`) holds:

- `_METADATA`, JSON: each leaf's key path (`key_type` 1 for a sequence
  index, 2 for a dict key or attribute name) and its value type
  ("jax.Array", "np.ndarray" and "scalar" are arrays; "None", "Dict",
  "List" and "Tuple" are a None, {}, [] or () that has no data, such as
  optax.MultiSteps' empty `skip_state`), and the storage flags
  `use_ocdbt` and `use_zarr3`;
- an OCDBT database (`ocdbt.OcdbtReader`) of zarr v2 arrays: leaf
  `a.b.0` has the metadata `a.b.0/.zarray` and its chunks `a.b.0/i.j`,
  each compressed by zstd (`_zstd`). A leaf that was sharded over devices
  is several chunks.

Named tuples and dataclasses (optax states, flax train states) come back
as dicts keyed by field name, tuples as lists. bf16 arrays come back as
fp32 (widened exactly: the 16 bits shifted up), as the port's converters
take fp32 (`from_jax._t`). Anything the JAX package does not write (zarr
v3, no OCDBT, a compressor other than zstd or none, zarr filters, Fortran
order, a missing chunk, an unknown value type) raises.
"""

from __future__ import annotations

import itertools
import json
import math
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from . import _zstd
from .ocdbt import OcdbtReader

__all__ = ["is_orbax_checkpoint", "read_orbax", "top_level_keys"]

_ARRAYS = ("jax.Array", "np.ndarray", "scalar")
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": list}
_SEQUENCE, _DICT = 1, 2


def is_orbax_checkpoint(path) -> bool:
    """Whether `path` is a directory that Orbax wrote (it has _METADATA)."""
    path = Path(path)
    return path.is_dir() and (path / "_METADATA").is_file()


def _metadata(path: Path) -> dict:
    if not is_orbax_checkpoint(path):
        raise ValueError(f"{path} is not an Orbax checkpoint (no _METADATA)")
    meta = json.loads((path / "_METADATA").read_text())
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr v3 arrays (use_zarr3) are not read; "
                         f"the JAX package writes zarr v2")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{path}: a checkpoint without OCDBT (use_ocdbt "
                         f"false) is not read; the JAX package writes OCDBT")
    return meta


def _leaves(meta: dict):
    """(keys, key types, value type) of every leaf, in _METADATA's order."""
    for entry in meta["tree_metadata"].values():
        path = entry["key_metadata"]
        yield ([str(k["key"]) for k in path], [k["key_type"] for k in path],
               entry["value_metadata"]["value_type"])


def _top_level(meta: dict) -> List[str]:
    return list(dict.fromkeys(keys[0] for keys, _, _ in _leaves(meta)))


def top_level_keys(path) -> List[str]:
    """The names of a checkpoint's top-level subtrees, from _METADATA."""
    return _top_level(_metadata(Path(path)))


def _dtype(spec: str, where: str):
    """(numpy dtype as stored, whether it is bf16 to widen)."""
    if spec == "bfloat16":
        return np.dtype("<u2"), True
    dtype = np.dtype(spec)
    if dtype.kind not in "biuf":
        raise ValueError(f"{where}: dtype {spec!r} is not read")
    return dtype, False


def _read_array(db: OcdbtReader, name: str) -> np.ndarray:
    where = f"{db.root}: {name}"
    try:
        meta = json.loads(db.read(f"{name}/.zarray"))
    except KeyError:
        raise ValueError(f"{where}: no .zarray") from None
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr format {meta.get('zarr_format')}")
    if meta.get("filters"):
        raise ValueError(f"{where}: zarr filters {meta['filters']} are not "
                         f"read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{where}: order {meta['order']!r} is not read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {compressor.get('id')!r} is "
                         f"not read (zstd or none)")
    dtype, bf16 = _dtype(meta["dtype"], where)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or 0 in chunks:
        raise ValueError(f"{where}: chunks {chunks} for shape {shape}")
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    whole = chunks == shape  # one chunk: decompressed in place
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*map(range, grid)):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        try:
            data = db.read(key)
        except KeyError:
            raise ValueError(f"{where}: chunk {key} is missing") from None
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        buf = out if whole else np.empty(chunks, dtype)
        if compressor is None:
            if len(data) != buf.nbytes:
                raise ValueError(f"{where}: chunk {key} has {len(data)} "
                                 f"bytes, {buf.nbytes} expected")
            buf[...] = np.frombuffer(data, dtype).reshape(chunks)
        else:
            _zstd.decompress_into(data, buf)
        if not whole:
            out[region] = buf[tuple(slice(0, r.stop - r.start)
                                    for r in region)]
    if bf16:
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out.astype(out.dtype.newbyteorder("="), copy=False)


def _finish(node, kinds: Dict[int, int]):
    """Nested dicts with the sequence levels turned into lists."""
    if not isinstance(node, dict):
        return node
    if kinds.get(id(node)) == _SEQUENCE:
        n = len(node)
        if sorted(node) != list(range(n)):
            raise ValueError(f"sequence indices {sorted(node)} are not "
                             f"0..{n - 1}")
        return [_finish(node[i], kinds) for i in range(n)]
    return {k: _finish(v, kinds) for k, v in node.items()}


def read_orbax(path, select: Optional[Iterable[str]] = None) -> Dict[str, Any]:
    """The tree that Orbax saved at `path`, as nested dicts and lists of
    numpy arrays (and Python scalars, None, {} and [] where those were
    saved). `select` names the top-level subtrees to read (for example
    ("ema_params",)): only those are decompressed, and a missing name
    raises KeyError."""
    path = Path(path)
    meta = _metadata(path)
    wanted = None if select is None else list(select)
    if wanted is not None:
        missing = [k for k in wanted if k not in _top_level(meta)]
        if missing:
            raise KeyError(f"{path} has no subtree {missing}; it has "
                           f"{_top_level(meta)}")
    root: Dict[Any, Any] = {}
    kinds: Dict[int, int] = {}  # id of each inner node: sequence or dict
    with OcdbtReader(path) as db:
        for keys, types, value_type in _leaves(meta):
            if wanted is not None and keys[0] not in wanted:
                continue
            if value_type in _ARRAYS:
                value = _read_array(db, ".".join(keys))
                if value_type == "scalar":
                    value = value.item()
            elif value_type in _EMPTY:
                value = _EMPTY[value_type]()
            else:
                raise ValueError(f"{path}: leaf {'.'.join(keys)} has value "
                                 f"type {value_type!r}, which is not read")
            node = root
            for depth, (key, kind) in enumerate(zip(keys, types)):
                if kind not in (_SEQUENCE, _DICT):
                    raise ValueError(f"{path}: key type {kind} at "
                                     f"{'.'.join(keys)}")
                if kinds.setdefault(id(node), kind) != kind:
                    raise ValueError(f"{path}: {'.'.join(keys[:depth])} is "
                                     f"both a sequence and a dict")
                if kind == _SEQUENCE:
                    key = int(key)
                if depth == len(keys) - 1:
                    node[key] = value
                else:
                    node = node.setdefault(key, {})
    return _finish(root, kinds)
