"""The port's reader of the JAX package's Orbax checkpoints
(`vqgan_tpu_torch/checkpoint/{_zstd,ocdbt,orbax}.py`), held to `orbax` and
`tensorstore`, which the port never imports.

- Checkpoints written by `vqgan_tpu.checkpoint.CheckpointManager` (every
  dtype the JAX package stores, scalars, None, tuples, named tuples, a
  real `optax.adamw` state, arrays sharded over the 8 CPU devices, and
  over 300 leaves in several data files) read leaf for leaf, bit for bit,
  as `orbax.checkpoint` restores them; the OCDBT keys and values as
  `tensorstore` lists and reads them, at both levels Orbax writes.
- OCDBT stores that `tensorstore` writes with interior B-tree nodes, many
  versions, and with or without zstd.
- `select` decompresses only the named subtrees.
- Each case the JAX package never writes, and each broken file, raises.
- The committed fixture (tests/fixtures/jax_orbax/) reads as `orbax`
  restores it.
"""

import collections
import json
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vqgan_tpu.checkpoint import CheckpointManager
from vqgan_tpu_torch.checkpoint import _zstd, ocdbt, orbax

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_orbax"

Pair = collections.namedtuple("Pair", ["first", "second"])


def save(tmp_path, state, prefix="model") -> Path:
    CheckpointManager(tmp_path, prefix=prefix).save(1, state)
    return tmp_path / f"{prefix}-1"


def assert_same(ref, got, path="tree"):
    """`got` (the port's read) equals `ref` (orbax's restore) bit for bit;
    bf16 leaves as their exact fp32 widening, tuples as lists."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(got) == set(ref), path
        for k in ref:
            assert_same(ref[k], got[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_same(a, b, f"{path}.{i}")
    elif ref is None:
        assert got is None, path
    elif isinstance(ref, (int, float)):
        assert type(got) is type(ref) and got == ref, path
    else:
        ref = np.asarray(ref)
        if ref.dtype == jnp.bfloat16:
            ref = ref.astype(np.float32)
        assert isinstance(got, np.ndarray), path
        assert got.dtype == ref.dtype and got.shape == ref.shape, (
            path, got.dtype, ref.dtype, got.shape, ref.shape)
        assert got.tobytes() == ref.tobytes(), path


def assert_db_matches_tensorstore(root):
    store = ts.KvStore.open({"driver": "ocdbt",
                             "base": f"file://{root}"}).result()
    keys = [k.decode() for k in store.list().result()]
    with ocdbt.OcdbtReader(root) as db:
        assert sorted(db.keys()) == sorted(keys)
        for k in keys:
            assert db.read(k) == store.read(k).result().value, k
    return keys


def params_tree():
    rng = np.random.default_rng(0)
    return {"dense": {"kernel": jnp.asarray(rng.standard_normal((6, 5)),
                                            jnp.float32),
                      "bias": jnp.asarray(rng.standard_normal(5),
                                          jnp.float32)},
            "norm": {"scale": jnp.ones((5,), jnp.float32)}}


def state_of(case):
    rng = np.random.default_rng(1)
    if case == "dtypes":
        params = params_tree()
        return {
            "step": jnp.int32(7),
            "params": params,
            "opt_state": optax.adamw(1e-3).init(params),
            "f64": rng.standard_normal((3, 2)),
            "f16": rng.standard_normal(4).astype(np.float16),
            "bf16": jnp.asarray(rng.standard_normal((2, 3)), jnp.bfloat16),
            "i32": jnp.arange(5, dtype=jnp.int32) - 2,
            "i64": np.arange(-3, 3, dtype=np.int64) * 2**40,
            "u32": np.array([0, 1, 2**32 - 1], np.uint32),
            "u8": np.array([0, 7, 255], np.uint8),
            "bool": np.array([True, False, True]),
            "scalars": {"py_int": 3, "py_float": 2.5,
                        "f32": jnp.float32(-1.5)},
            "none": None,
            "empty_dict": {},
            "empty_list": [],
            "tuple": (jnp.zeros(2), (jnp.ones(1), None)),
            "named": Pair(jnp.full((2, 2), 3.0), np.array([1, 2], np.int32)),
        }
    if case == "sharded":
        devices = np.array(jax.devices())
        rows = Mesh(devices, ("data",))
        grid = Mesh(devices.reshape(4, 2), ("a", "b"))
        x = rng.standard_normal((64, 8)).astype(np.float32)
        y = rng.standard_normal((16, 6)).astype(np.float32)
        return {
            "rows": jax.device_put(x, NamedSharding(rows, P("data"))),
            "grid": jax.device_put(y, NamedSharding(grid, P("a", "b"))),
            "bf16_rows": jax.device_put(jnp.asarray(x, jnp.bfloat16),
                                        NamedSharding(rows, P("data"))),
            "replicated": jax.device_put(y, NamedSharding(rows, P())),
        }
    assert case == "many_leaves"
    return {"layers": [{"w": rng.standard_normal((32, 48)).astype(
        np.float32), "b": rng.standard_normal(48).astype(np.float32)}
        for _ in range(160)], "step": np.int64(3)}


@pytest.mark.parametrize("case", ["dtypes", "sharded", "many_leaves"])
def test_read_orbax_equals_orbax_restore(tmp_path, case):
    path = save(tmp_path, state_of(case))
    ref = ocp.StandardCheckpointer().restore(path)
    got = orbax.read_orbax(path)
    assert_same(ref, got)
    assert orbax.is_orbax_checkpoint(path)
    keys = assert_db_matches_tensorstore(path)
    # the per-process database under the merged top-level one
    assert_db_matches_tensorstore(path / "ocdbt.process_0")
    if case == "sharded":
        assert [k for k in keys if k.startswith("rows/")] == [
            "rows/.zarray", *[f"rows/{i}.0" for i in range(8)]]
        assert sum(k.startswith("grid/") for k in keys) == 1 + 8
    if case == "many_leaves":
        assert len(jax.tree.leaves(ref)) >= 300
        assert len(list((path / "ocdbt.process_0" / "d").iterdir())) > 2


@pytest.mark.parametrize("compression", [{"id": "zstd"}, None])
def test_ocdbt_interior_nodes_and_versions_match_tensorstore(
        tmp_path, compression, monkeypatch):
    config = {"max_decoded_node_bytes": 256, "max_inline_value_bytes": 8,
              "compression": compression}
    store = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}",
                             "config": config}).result()
    # 40 commits: versions past the 16 a manifest lists, values inline and
    # in data files
    for i in range(40):
        store.write(f"key{i:03d}/{'x' * (i % 5)}", bytes([i]) * (i + 1)
                    ).result()
    store.delete_range(ts.KvStore.KeyRange("key010", "key013")).result()
    heights = []
    walk = ocdbt.OcdbtReader._walk

    def spy(self, files, file_id, offset, length, height, prefix):
        heights.append(height)
        return walk(self, files, file_id, offset, length, height, prefix)

    monkeypatch.setattr(ocdbt.OcdbtReader, "_walk", spy)
    keys = assert_db_matches_tensorstore(tmp_path)
    assert len(keys) == 37 and max(heights) >= 2


def test_select_decompresses_only_the_named_subtrees(tmp_path, monkeypatch):
    params = params_tree()
    path = save(tmp_path, {"step": jnp.int32(2), "params": params,
                           "ema_params": jax.tree.map(lambda x: x + 1, params),
                           "opt_state": optax.adam(1e-3).init(params)})
    calls = []
    real = _zstd.decompress_into
    monkeypatch.setattr(_zstd, "decompress_into",
                        lambda src, dst: calls.append(dst.shape) or
                        real(src, dst))
    assert orbax.top_level_keys(path) == ["ema_params", "opt_state",
                                          "params", "step"]
    got = orbax.read_orbax(path, select=("ema_params",))
    assert list(got) == ["ema_params"] and len(calls) == 3
    assert_same(jax.tree.map(lambda x: x + 1, params), got["ema_params"])
    with pytest.raises(KeyError, match="no subtree"):
        orbax.read_orbax(path, select=("ema",))


def _reframe(blob: bytearray):
    """Recompute a framed file's CRC-32C after an edit."""
    blob[-4:] = struct.pack("<I", ocdbt.crc32c(bytes(blob[:-4])))


def _top_node(path: Path) -> Path:
    (node,) = (path / "d").iterdir()
    return node


def _edit_zarray(path: Path, name: str, **changes):
    store = ts.KvStore.open({"driver": "ocdbt",
                             "base": f"file://{path}"}).result()
    meta = json.loads(store.read(f"{name}/.zarray").result().value)
    store.write(f"{name}/.zarray", json.dumps({**meta, **changes})).result()


def _break(path: Path, how: str):
    if how in ("zarr3", "no_ocdbt"):
        meta = json.loads((path / "_METADATA").read_text())
        meta["use_zarr3" if how == "zarr3" else "use_ocdbt"] = how == "zarr3"
        (path / "_METADATA").write_text(json.dumps(meta))
    elif how == "truncated_node":
        node = _top_node(path)
        node.write_bytes(node.read_bytes()[:-10])
    elif how == "truncated_manifest":
        manifest = path / "manifest.ocdbt"
        manifest.write_bytes(manifest.read_bytes()[:40])
    elif how in ("bad_crc", "unknown_version", "unknown_compression",
                 "bad_magic"):
        node = _top_node(path)
        blob = bytearray(node.read_bytes())
        if how == "bad_crc":
            blob[len(blob) // 2] ^= 0x40
        else:
            where, value = {"unknown_version": (12, 1),
                            "unknown_compression": (13, 2),
                            "bad_magic": (0, 0x0D)}[how]
            blob[where] = value
            _reframe(blob)
        node.write_bytes(bytes(blob))
    elif how == "missing_chunk":
        store = ts.KvStore.open({"driver": "ocdbt",
                                 "base": f"file://{path}"}).result()
        key = "params.dense.kernel/0.0"
        store.delete_range(ts.KvStore.KeyRange(key, key + "\0")).result()
    elif how == "compressor":
        _edit_zarray(path, "params.dense.kernel",
                     compressor={"id": "blosc", "cname": "lz4"})
    elif how == "filters":
        _edit_zarray(path, "params.dense.kernel",
                     filters=[{"id": "delta", "dtype": "<f4"}])
    elif how == "order_F":
        _edit_zarray(path, "params.dense.kernel", order="F")
    elif how == "not_orbax":
        (path / "_METADATA").unlink()
    else:
        raise AssertionError(how)


@pytest.mark.parametrize("how,message", [
    ("zarr3", "zarr v3"),
    ("no_ocdbt", "without OCDBT"),
    ("not_orbax", "not an Orbax checkpoint"),
    ("truncated_node", "truncated"),
    ("truncated_manifest", "truncated"),
    ("bad_crc", "CRC-32C"),
    ("bad_magic", "magic"),
    ("unknown_version", "format version 1"),
    ("unknown_compression", "compression 2"),
    ("missing_chunk", "params.dense.kernel/0.0 is missing"),
    ("compressor", "compressor 'blosc'"),
    ("filters", "filters"),
    ("order_F", "order 'F'"),
])
def test_read_orbax_refuses(tmp_path, how, message):
    path = save(tmp_path, {"params": params_tree(), "step": jnp.int32(1)})
    orbax.read_orbax(path)  # whole, it reads
    _break(path, how)
    with pytest.raises(ValueError, match=message):
        orbax.read_orbax(path)


def test_zstd_binding(monkeypatch):
    assert _zstd.version().count(".") == 2
    # a frame as the zarr writer makes it: no content size in its header
    spec = {"driver": "zarr", "kvstore": {"driver": "memory"},
            "metadata": {"shape": [64], "chunks": [64], "dtype": "<f4",
                         "compressor": {"id": "zstd", "level": 1}},
            "create": True}
    arr = ts.open(spec).result()
    values = np.linspace(-1, 1, 64, dtype=np.float32)
    arr.write(values).result()
    frame = arr.kvstore.read("0").result().value
    out = np.empty(64, np.float32)
    _zstd.decompress_into(frame, out)
    np.testing.assert_array_equal(out, values)
    with pytest.raises(ValueError, match="more than the 128 bytes"):
        _zstd.decompress_into(frame, np.empty(32, np.float32))
    with pytest.raises(ValueError, match="holds 256 bytes, 512 expected"):
        _zstd.decompress_into(frame, np.empty(128, np.float32))
    with pytest.raises(ValueError, match="zstd"):
        _zstd.decompress(b"not a frame", 1 << 20)
    monkeypatch.setattr(_zstd, "_lib", None)
    monkeypatch.setattr(_zstd, "LIBRARY", "libzstd-absent.so.1")
    with pytest.raises(RuntimeError, match="libzstd-absent.so.1"):
        _zstd.version()


def test_committed_fixture_reads_as_orbax_restores_it():
    meta = json.loads((FIXTURE / "fixture.json").read_text())
    for name, prefix in (("ldm", "model"), ("kl_vae", "kl_vae"),
                         ("vqgan", "vqgan")):
        path = FIXTURE / name / f"{prefix}-{meta[f'{name}_milestone']}"
        assert_same(ocp.StandardCheckpointer().restore(path),
                    orbax.read_orbax(path))
