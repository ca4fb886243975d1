"""A read-only reader of OCDBT databases, the key-value store under the JAX
package's Orbax checkpoints, in Python with no TensorStore.

OCDBT ("optionally cooperative distributed B+tree", TensorStore's
`kvstore/ocdbt` format) keeps a B+tree of keys in immutable files. Orbax
writes one database per process (`ocdbt.process_0/`) and a top-level one
whose manifest points at a merged tree, whose values lie in the
per-process data files; the reader follows paths as the files name them,
so both levels read alike. What this module reads:

- every file is framed: a magic number (u32 big-endian; 0x0cdb3a2a for a
  manifest, 0x0cdb20de for a B-tree node), the framed length (u64 LE),
  a format version (varint, 0) and a compression (varint: 0 none,
  1 zstd), the body, then a CRC-32C of all before it (u32 LE);
- the manifest's body: the config (uuid[16]; manifest kind, varint, 0 for
  a single manifest file; max inline value bytes, max decoded node bytes;
  version-tree arity log2, one byte; compression, varint, with an int32
  zstd level after 1), a data-file table, then the latest versions as
  parallel arrays: generation, root height (one byte each), root
  location (file, offset, length), key count, tree bytes, indirect value
  bytes (varints) and commit time (u64 LE). References to older versions'
  nodes follow; the latest version is always among the listed ones;
- a data-file table: count; common-prefix lengths with the previous path
  (count - 1); suffix lengths; base-path lengths; the suffix bytes. A
  file lives at `base_path + relative_path` below the database's root;
- a B-tree node: height (one byte), its own data-file table, the entry
  count, key prefix lengths (count - 1), suffix lengths, and for an
  interior node each child's common key-prefix length; the key suffixes;
  then an interior node's children (file, offset, length, key count, tree
  bytes, indirect bytes) or a leaf's values (lengths; kinds, 0 inline and
  1 indirect; file and offset of each indirect value; the inline bytes).
  A child's keys omit the first `subtree_common_prefix_length` bytes of
  its entry's key. An empty tree's root has offset and length 2**64 - 1.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Dict, List, Tuple, Union

from . import _zstd

__all__ = ["OcdbtReader", "crc32c"]

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_EMPTY = 2**64 - 1
# decoded manifests and nodes; a node is split well below this
_MAX_DECODED = 1 << 31

_CRC_TABLE: List[int] = []


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT frames its files."""
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
            _CRC_TABLE.append(c)
    table = _CRC_TABLE
    c = 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Reads varints, fixed integers and bytes off a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int):
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated at byte {self.pos}")

    def varint(self) -> int:
        out = shift = 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint over 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        self._need(n)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


def _unframe(blob: bytes, magic: int, what: str) -> bytes:
    """The decoded body of a framed manifest or node."""
    if len(blob) < 4 + 8 + 2 + 4:
        raise ValueError(f"{what}: truncated ({len(blob)} bytes)")
    (got_magic,) = struct.unpack_from(">I", blob)
    (length,) = struct.unpack_from("<Q", blob, 4)
    if got_magic != magic:
        raise ValueError(f"{what}: magic {got_magic:#010x}, not {magic:#010x}")
    if length != len(blob):
        raise ValueError(f"{what}: truncated, it states {length} bytes and "
                         f"has {len(blob)}")
    crc = struct.unpack_from("<I", blob, len(blob) - 4)[0]
    if crc32c(blob[:-4]) != crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    head = _Cursor(blob[:-4], what)
    head.pos = 12
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version} is unknown")
    compression = head.varint()
    body = blob[head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return _zstd.decompress(body, _MAX_DECODED)
    raise ValueError(f"{what}: compression {compression} is unknown")


def _prefixed(c: _Cursor, prefix: List[int], suffix: List[int]):
    """Strings stored as (length shared with the previous one, the rest)."""
    out, prev = [], b""
    for shared, rest in zip(prefix, suffix):
        if shared > len(prev):
            raise ValueError(f"{c.what}: a prefix longer than its string")
        prev = prev[:shared] + c.take(rest)
        out.append(prev)
    return out


def _data_file_table(c: _Cursor) -> List[str]:
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    c.varints(n)  # base-path lengths: the path is used whole
    return [p.decode() for p in _prefixed(c, prefix, suffix)]


def _keys(c: _Cursor, n: int, interior: bool):
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    sub = c.varints(n) if interior else None
    return _prefixed(c, prefix, suffix), sub


# a value: its bytes, or (data file, offset, length)
_Value = Union[bytes, Tuple[str, int, int]]


class OcdbtReader:
    """The latest version of the OCDBT database at `root` as a read-only
    key -> bytes map. The whole B-tree is walked at open; values are read
    when asked for. Close it (or use it as a context manager) to release
    the data files."""

    def __init__(self, root):
        self.root = Path(root)
        self._files: Dict[str, int] = {}
        self._values: Dict[str, _Value] = {}
        try:
            self._open()
        except BaseException:
            self.close()
            raise

    # ------------------------------------------------------------------

    def keys(self) -> List[str]:
        return list(self._values)

    def read(self, key: str) -> bytes:
        try:
            value = self._values[key]
        except KeyError:
            raise KeyError(f"{self.root}: no key {key!r}") from None
        if isinstance(value, bytes):
            return value
        return self._read_range(*value)

    def close(self):
        for fd in self._files.values():
            os.close(fd)
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------

    def _fd(self, path: str) -> int:
        if path not in self._files:
            parts = Path(path).parts
            if not parts or Path(path).is_absolute() or ".." in parts:
                raise ValueError(f"{self.root}: data file {path!r} lies "
                                 f"outside the database")
            self._files[path] = os.open(self.root / path, os.O_RDONLY)
        return self._files[path]

    def _read_range(self, path: str, offset: int, length: int) -> bytes:
        out = os.pread(self._fd(path), length, offset)
        if len(out) != length:
            raise ValueError(f"{self.root / path}: truncated, {length} bytes "
                             f"wanted at {offset}, {len(out)} there")
        return out

    def _open(self):
        what = str(self.root / "manifest.ocdbt")
        c = _Cursor(_unframe(Path(what).read_bytes(), MANIFEST_MAGIC, what),
                    what)
        c.take(16)  # uuid
        kind = c.varint()
        if kind != 0:
            raise ValueError(f"{what}: manifest kind {kind} (numbered "
                             f"manifest files) is not read")
        c.varint()  # max inline value bytes
        c.varint()  # max decoded node bytes
        c.take(1)  # version-tree arity log2
        compression = c.varint()
        if compression == 1:
            c.take(4)  # zstd level
        elif compression != 0:
            raise ValueError(f"{what}: compression {compression} is unknown")
        files = _data_file_table(c)
        n = c.varint()
        if n == 0:
            return
        generation = c.varints(n)
        height = list(c.take(n))
        file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
        num_keys = c.varints(n)
        latest = max(range(n), key=generation.__getitem__)
        if offset[latest] == _EMPTY or num_keys[latest] == 0:
            return
        self._walk(files, file_id[latest], offset[latest], length[latest],
                   height[latest], b"")

    def _walk(self, files, file_id, offset, length, height, prefix):
        if file_id >= len(files):
            raise ValueError(f"{self.root}: data file {file_id} of "
                             f"{len(files)}")
        path = files[file_id]
        what = f"{self.root / path}@{offset}"
        body = _unframe(self._read_range(path, offset, length), NODE_MAGIC,
                        what)
        c = _Cursor(body, what)
        got = c.take(1)[0]
        if got != height:
            raise ValueError(f"{what}: height {got}, {height} expected")
        node_files = _data_file_table(c)
        n = c.varint()
        keys, sub = _keys(c, n, interior=height > 0)
        if height > 0:
            fid, off, ln = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)  # key counts, tree bytes, indirect bytes
            for k in range(n):
                self._walk(node_files, fid[k], off[k], ln[k], height - 1,
                           prefix + keys[k][:sub[k]])
            return
        lengths, kinds = c.varints(n), c.varints(n)
        indirect = [k for k in range(n) if kinds[k] == 1]
        if len(indirect) + kinds.count(0) != n:
            raise ValueError(f"{what}: unknown value kind in {set(kinds)}")
        fid, off = c.varints(len(indirect)), c.varints(len(indirect))
        where = dict(zip(indirect, zip(fid, off)))
        for k in range(n):
            key = (prefix + keys[k]).decode()
            if k in where:
                f, o = where[k]
                if f >= len(node_files):
                    raise ValueError(f"{what}: data file {f} of "
                                     f"{len(node_files)}")
                self._values[key] = (node_files[f], o, lengths[k])
            else:
                self._values[key] = c.take(lengths[k])
        if c.pos != len(body):
            raise ValueError(f"{what}: {len(body) - c.pos} bytes left over")
