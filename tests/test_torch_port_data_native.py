"""Port parity: the native input pipeline (vqgan_tpu_torch/data/
native_image.py, native_loader.py, native_build.py, prefetch.py and the
native paths of datasets.py / latent_cache.py) against the JAX package's.

Both sides build their own copy of the C++ sources with g++ (libjpeg for
the decoder) and read the same seeded files.

- The decoder against JAX's bit for bit (atol 0) on JAX's fixture kinds
  (square, landscape, portrait, grayscale, no resize), and against the
  port's PIL `load_image` within JAX's own rule (mean |d| < 4/255, 99th
  percentile < 16/255). A file that fails to decode raises.
- `ImageFolderDataset.get_batch` against JAX's; the BatchLoader takes it.
- `NativePipeline` against JAX's: equal batches and indices over two
  epochs, shuffled and in order; a decode error raises; the labels of
  `NativeBatchLoader` track the shuffled images.
- `make_batch_loader` makes JAX's choice (ring, Python loader or error) in
  every case, and `loader_kind` names it.
- `NativeLatentBatcher` and `LatentDataset.native_batch_loader` against
  JAX's: equal gathers and batches; a missing file raises OSError.
- `device_prefetch`: JAX's cases, and closing it closes the loader.
- The native build: the library's name follows the source, the flags and the
  CPU; two processes that build at once both load a whole library; the
  port's sources are JAX's below their header comments.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from vqgan_tpu.data import LatentCache as JLatentCache
from vqgan_tpu.data import LatentDataset as JLatentDataset
from vqgan_tpu.data import datasets as jdatasets
from vqgan_tpu.data import native_image as jnative
from vqgan_tpu.data.native_loader import NativeLatentBatcher as JBatcher
from vqgan_tpu.data.prefetch import device_prefetch as j_device_prefetch
from vqgan_tpu_torch.data import LatentCache, LatentDataset, datasets
from vqgan_tpu_torch.data import native_build, native_image
from vqgan_tpu_torch.data.native_loader import NativeLatentBatcher
from vqgan_tpu_torch.data.prefetch import device_prefetch, to_device

from _jax_native_libs import jax_native_libs  # noqa: F401

# every test waits until the JAX package's native libraries load
pytestmark = pytest.mark.usefixtures("jax_native_libs")
REPO = Path(__file__).resolve().parent.parent
KINDS = [("square", (64, 64), "RGB"), ("landscape", (96, 48), "RGB"),
         ("portrait", (40, 80), "RGB"), ("gray", (72, 56), "L"),
         ("exact", (32, 32), "RGB")]


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """JAX's fixture kinds: smooth seeded content, quality 95."""
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(3)
    paths = []
    for name, (w, h), mode in KINDS:
        shape = (h, w, 3) if mode == "RGB" else (h, w)
        yy, xx = np.mgrid[0:h, 0:w]
        base = 128 + 60 * np.sin(xx / 9.0) + 50 * np.cos(yy / 7.0)
        arr = (np.stack([base, base[::-1], base.T[:w].T], -1)
               if mode == "RGB" else base)
        arr = np.clip(arr + rng.normal(0, 3, shape), 0, 255).astype(np.uint8)
        p = d / f"{name}.jpg"
        Image.fromarray(arr, mode).save(p, quality=95)
        paths.append(p)
    return paths


def test_library_builds():
    assert native_image.load_decoder_lib() is not None
    assert jnative.load_decoder_lib() is not None


@pytest.mark.parametrize("kind", [k[0] for k in KINDS])
@pytest.mark.parametrize("size", [32, 24])
def test_decode_equals_jax_bit_for_bit(jpegs, kind, size):
    path = [p for p in jpegs if p.stem == kind]
    got = native_image.decode_jpeg_batch(path, size)
    want = jnative.decode_jpeg_batch(path, size)
    assert got.shape == (1, size, size, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_decode_batch_equals_jax_and_thread_count_does_not_matter(jpegs):
    got = native_image.decode_jpeg_batch(jpegs, 32, n_threads=3)
    np.testing.assert_array_equal(got, jnative.decode_jpeg_batch(jpegs, 32))
    np.testing.assert_array_equal(
        got, native_image.decode_jpeg_batch(jpegs, 32, n_threads=1))


@pytest.mark.parametrize("kind", [k[0] for k in KINDS])
def test_decode_matches_the_pil_path(jpegs, kind):
    path = [p for p in jpegs if p.stem == kind]
    batch = native_image.decode_jpeg_batch(path, 32)
    assert 0.0 <= float(batch.min()) and float(batch.max()) <= 1.0
    # PIL quantises to uint8 after resampling, the native path keeps float
    diff = np.abs(batch[0] - datasets.load_image(path[0], 32))
    assert diff.mean() < 4 / 255, diff.mean()
    assert np.quantile(diff, 0.99) < 16 / 255
    if kind == "exact":  # no resample: only the uint8 -> float step
        assert diff.max() <= 1.01 / 255


def test_decode_error_raises(jpegs, tmp_path):
    bad = tmp_path / "corrupt.jpg"
    bad.write_bytes(b"not a jpeg at all")
    with pytest.raises(RuntimeError, match="decode failed"):
        native_image.decode_jpeg_batch([jpegs[0], bad], 16)
    with pytest.raises(RuntimeError, match="decode failed"):
        native_image.decode_jpeg_batch([tmp_path / "missing.jpg"], 16)
    # the JAX package returns None here, and its get_batch decodes with PIL
    assert jnative.decode_jpeg_batch([bad], 16) is None
    assert native_image.decode_jpeg_batch([], 16) is None


def write_user_folder(root, jpegs, png=False):
    """ID_1 with copies of the fixture JPEGs (and a PNG with `png`) and a
    split listing them."""
    (root / "ID_1").mkdir(parents=True)
    names = []
    for i, p in enumerate(jpegs):
        names.append(f"img{i}.jpg")
        (root / "ID_1" / names[-1]).write_bytes(Path(p).read_bytes())
    if png:
        Image.open(jpegs[0]).save(root / "ID_1" / "extra.png")
        names.append("extra.png")
    return {"users": {"ID_1": {"train_images": names, "test_images": []}}}


@pytest.mark.parametrize("imagenet_norm", [False, True])
def test_get_batch_equals_jax(jpegs, tmp_path, imagenet_norm):
    split = write_user_folder(tmp_path, jpegs)
    kw = dict(image_size=32, imagenet_norm=imagenet_norm)
    ds = datasets.ImageFolderDataset(tmp_path, split, "train", **kw)
    jds = jdatasets.ImageFolderDataset(tmp_path, split, "train", **kw)
    idxs = [3, 0, 4, 1]
    got, labels = ds.get_batch(idxs)
    want, j_labels = jds.get_batch(idxs)
    np.testing.assert_array_equal(labels, j_labels)
    if imagenet_norm:  # PIL on both sides
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[0], ds[3][0], rtol=0, atol=0)
        assert not datasets.native_decodable(ds)
    else:
        np.testing.assert_array_equal(got, want)
        assert datasets.native_decodable(ds)


def test_get_batch_of_a_png_batch_decodes_with_pil(jpegs, tmp_path):
    split = write_user_folder(tmp_path, jpegs[:2], png=True)
    ds = datasets.ImageFolderDataset(tmp_path, split, "train", image_size=32)
    got, _ = ds.get_batch([0, 2])
    want = np.stack([ds[0][0], ds[2][0]])
    np.testing.assert_array_equal(got, want)
    assert not datasets.native_decodable(ds)
    # a JPEG-only batch of the same dataset still decodes natively
    np.testing.assert_array_equal(
        ds.get_batch([1])[0], native_image.decode_jpeg_batch(
            [ds.items[1][0]], 32))


def test_batch_loader_takes_get_batch_and_matches_jax(jpegs, tmp_path):
    split = write_user_folder(tmp_path, jpegs)
    ds = datasets.ImageFolderDataset(tmp_path, split, "train", image_size=16)
    jds = jdatasets.ImageFolderDataset(tmp_path, split, "train",
                                       image_size=16)
    got = list(datasets.BatchLoader(ds, 2, seed=4))
    want = list(jdatasets.BatchLoader(jds, 2, seed=4))
    assert len(got) == len(want) == 2
    for (a, la), (b, lb) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)

    class Spy:
        image_size = 16

        def __len__(self):
            return len(jpegs)

        def __getitem__(self, i):
            raise AssertionError("the BatchLoader must take get_batch")

        def get_batch(self, idxs):
            return (native_image.decode_jpeg_batch(
                [jpegs[int(i)] for i in idxs], 16),
                np.zeros(len(idxs), np.int32))

    images, _ = next(iter(datasets.BatchLoader(Spy(), 2, shuffle=False)))
    assert images.shape == (2, 16, 16, 3)


def pipeline_stream(module, paths, shuffle, seed=7, epochs=2, batch=2):
    n = len(paths) // batch
    with module.NativePipeline(paths, 16, batch, n_threads=2, depth=3,
                               seed=seed, shuffle=shuffle) as pipe:
        assert pipe.available
        return [pipe.next(return_indices=True) for _ in range(epochs * n)]


@pytest.mark.parametrize("shuffle", [True, False])
def test_pipeline_equals_jax_over_two_epochs(jpegs, shuffle):
    paths = jpegs * 2  # 10 paths: 5 batches of 2 per epoch
    got = pipeline_stream(native_image, paths, shuffle)
    want = pipeline_stream(jnative, paths, shuffle)
    assert len(got) == 10
    for (a, ia), (b, ib) in zip(got, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(
            a, native_image.decode_jpeg_batch([paths[i] for i in ia], 16))
    order = np.concatenate([i for _, i in got])
    if shuffle:  # each epoch a permutation, reshuffled between epochs
        assert sorted(order[:10]) == list(range(10))
        assert not np.array_equal(order[:10], order[10:])
    else:
        np.testing.assert_array_equal(order, np.tile(np.arange(10), 2))
    # the same seed repeats the stream; drop-last with 5 paths per batch 2
    again = pipeline_stream(native_image, paths, shuffle)
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(got, again))
    assert native_image.NativePipeline(paths[:5], 16, 2).batches_per_epoch == 2


def test_pipeline_decode_error_raises(jpegs, tmp_path):
    bad = tmp_path / "corrupt.jpg"
    bad.write_bytes(b"not a jpeg at all")
    with native_image.NativePipeline([jpegs[0], bad], 16, 2,
                                     shuffle=False) as pipe:
        with pytest.raises(RuntimeError, match="decode failed"):
            pipe.next()
    pipe = native_image.NativePipeline(jpegs[:1], 16, 2)  # < one batch
    assert not pipe.available
    with pytest.raises(RuntimeError, match="not available"):
        pipe.next()


def test_native_batch_loader_labels_track_the_shuffled_images(tmp_path):
    items = []
    for label in range(6):  # each image a uniform grey of its label
        p = tmp_path / f"u{label}.jpg"
        Image.fromarray(np.full((40, 40, 3), label * 40, np.uint8)).save(
            p, quality=95)
        items.append((p, label))

    class DS:
        image_size = 32
        imagenet_norm = False

    DS.items = items
    loader = native_image.NativeBatchLoader(DS(), 2, shuffle=True, seed=5)
    j_loader = jnative.NativeBatchLoader(DS(), 2, shuffle=True, seed=5)
    seen = []
    for (imgs, labels), (j_imgs, j_labels) in zip(
            [b for b, _ in zip(loader, range(6))],
            [b for b, _ in zip(j_loader, range(6))]):
        np.testing.assert_array_equal(imgs, j_imgs)
        np.testing.assert_array_equal(labels, j_labels)
        for img, lab in zip(imgs, labels):
            assert int(round(float(img.mean()) * 255 / 40)) == int(lab)
        seen.extend(int(v) for v in labels)
    loader.close()
    j_loader.close()
    assert sorted(seen[:6]) == list(range(6))


def _dispatch(module, dataset, batch, **kw):
    """The class name make_batch_loader returns, or "raises"."""
    try:
        loader = module.make_batch_loader(dataset, batch, **kw)
    except RuntimeError:
        return "raises"
    name = type(loader).__name__
    if hasattr(loader, "close"):
        loader.close()
    return name


def _dataset(jpegs, kind):
    class Plain:
        image_size = 16
        imagenet_norm = kind == "imagenet"

        def __len__(self):
            return len(self.items)

        def __getitem__(self, i):
            return np.zeros((16, 16, 3), np.float32), 0

    Plain.items = [(p, 0) for p in jpegs]
    if kind == "png":
        Plain.items = Plain.items + [(Path("x.png"), 0)]
    if kind == "few":
        Plain.items = Plain.items[:1]
    if kind == "no_items":
        del Plain.items
        Plain.__len__ = lambda self: 4
    return Plain()


@pytest.mark.parametrize("kind", ["plain", "imagenet", "png", "few",
                                  "no_items"])
@pytest.mark.parametrize("native", ["auto", True, False])
@pytest.mark.parametrize("cores", [8, 1])
def test_make_batch_loader_chooses_as_jax(jpegs, monkeypatch, capsys, kind,
                                          native, cores):
    import os

    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    ds = _dataset(jpegs, kind)
    if kind == "few" and native is not True:
        # fewer items than a batch: no loader at all with drop-last
        with pytest.raises(ValueError):
            native_image.make_batch_loader(ds, 2, native=native)
        with pytest.raises(ValueError):
            jnative.make_batch_loader(ds, 2, native=native)
        return
    got = _dispatch(native_image, ds, 2, native=native)
    assert got == _dispatch(jnative, ds, 2, native=native)
    plain = kind == "plain"
    want = ("NativeBatchLoader" if native is True and plain
            else "raises" if native is True
            else "NativeBatchLoader" if native and plain and cores >= 3
            else "BatchLoader")
    assert got == want
    # "auto" prints why it took the Python loader
    out = capsys.readouterr().out
    assert ("input pipeline: Python BatchLoader" in out) == (
        native == "auto" and want == "BatchLoader")


def test_loader_kind_names_each_loader(jpegs, tmp_path):
    split = write_user_folder(tmp_path, jpegs)
    ds = datasets.ImageFolderDataset(tmp_path, split, "train", image_size=16)
    ring = native_image.make_batch_loader(ds, 2, native=True)
    assert native_image.loader_kind(ring) == "native_ring"
    ring.close()
    assert native_image.loader_kind(native_image.make_batch_loader(
        ds, 2, native=False)) == "native_get_batch"
    norm = datasets.ImageFolderDataset(tmp_path, split, "train",
                                       image_size=16, imagenet_norm=True)
    assert native_image.loader_kind(native_image.make_batch_loader(
        norm, 2)) == "python"
    # JPEG items without a `get_batch` (the DDPM FolderDataset) read by PIL
    from vqgan_tpu_torch.training.ddpm_trainer import FolderDataset

    assert native_image.loader_kind(native_image.make_batch_loader(
        FolderDataset(tmp_path, 16), 2, native=False)) == "python"


@pytest.fixture(scope="module")
def npy_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("latents")
    rng = np.random.default_rng(0)
    arrays, paths = [], []
    for i in range(64):
        a = rng.normal(size=(8, 8, 4)).astype(np.float32)
        p = d / f"user_{i % 3:02d}_f{i:03d}.npy"
        np.save(p, a)
        arrays.append(a)
        paths.append(p)
    return paths, arrays


@pytest.mark.parametrize("which", ["picked", "whole_shuffled"])
def test_latent_batcher_equals_jax(npy_files, which):
    paths, arrays = npy_files
    idx = ([5, 0, 63, 17] if which == "picked" else
           np.random.default_rng(1).permutation(64).tolist())
    got = NativeLatentBatcher(paths, n_threads=4).gather(idx)
    np.testing.assert_array_equal(got, JBatcher(paths, n_threads=4).gather(
        idx))
    np.testing.assert_array_equal(got, np.stack([arrays[i] for i in idx]))


def test_latent_batcher_raises(npy_files, tmp_path):
    paths, _ = npy_files
    batcher = NativeLatentBatcher(paths[:4])
    batcher.paths[2] = str(tmp_path / "missing.npy").encode()
    with pytest.raises(OSError):
        batcher.gather([0, 1, 2, 3])
    other = tmp_path / "other.npy"
    np.save(other, np.zeros((4, 4, 4), np.float32))
    with pytest.raises(ValueError, match="the others"):
        NativeLatentBatcher([paths[0], other])


def test_native_batch_loader_of_a_latent_dataset_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    split = {"users": {}}
    for user in (1, 2, 3):
        names = [f"frame_{i:03d}.png" for i in range(7)]
        split["users"][f"ID_{user}"] = {"train_images": names,
                                        "test_images": []}
        for name in names:
            np.save(tmp_path / f"user_{user - 1:02d}_{Path(name).stem}.npy",
                    rng.standard_normal((4, 4, 4)).astype(np.float32))
    ds = LatentDataset(tmp_path, split, LatentCache(tmp_path))
    jds = JLatentDataset(tmp_path, split, JLatentCache(tmp_path))
    assert ds.fully_cached() and ds.items == jds.items
    for shuffle in (True, False):
        kw = dict(shuffle=shuffle, seed=3, repeat=True)
        got = ds.native_batch_loader(4, **kw)
        want = jds.native_batch_loader(4, **kw)
        for _ in range(12):  # 5 batches an epoch (21 // 4): past two epochs
            (a, la), (b, lb) = next(got), next(want)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)
    once = list(ds.native_batch_loader(4, seed=3))
    assert len(once) == 5
    # the batches are the items' own latents
    lat, lab = once[0]
    first = [i for i, (_, _, l) in enumerate(ds.items)
             if np.array_equal(ds[i][0], lat[0])]
    assert first and ds.items[first[0]][2] == lab[0]


def test_prefetch_preserves_order_and_values():
    batches = [np.full((2, 3), i, np.float32) for i in range(5)]
    got = list(device_prefetch(batches, torch.from_numpy, depth=2))
    want = list(j_device_prefetch(batches, np.asarray, depth=2))
    assert len(got) == len(want) == 5
    for i, ((host, dev), (j_host, j_dev)) in enumerate(zip(got, want)):
        assert host is batches[i] and j_host is batches[i]
        np.testing.assert_array_equal(dev.numpy(), np.asarray(j_dev))


@pytest.mark.parametrize("module", ["port", "jax"])
def test_prefetch_runs_depth_ahead(module):
    prefetch = device_prefetch if module == "port" else j_device_prefetch
    calls = []

    def put(b):
        calls.append(b)
        return b

    gen = prefetch(iter(range(10)), put, depth=3)
    assert next(gen) == (0, 0) and calls == [0, 1, 2]
    assert next(gen) == (1, 1) and calls == [0, 1, 2, 3]


def test_prefetch_short_iterator_and_depth_one():
    assert list(device_prefetch([], torch.from_numpy)) == []
    assert len(list(device_prefetch([np.ones(2)], torch.from_numpy,
                                    depth=4))) == 1
    out = list(device_prefetch([1, 2, 3], lambda x: x * 10, depth=1))
    assert out == [(1, 10), (2, 20), (3, 30)]
    assert out == list(j_device_prefetch([1, 2, 3], lambda x: x * 10,
                                         depth=1))
    with pytest.raises(ValueError):
        next(device_prefetch([1], lambda x: x, depth=0))


def test_prefetch_close_closes_the_loader(jpegs, tmp_path):
    split = write_user_folder(tmp_path, jpegs)
    ds = datasets.ImageFolderDataset(tmp_path, split, "train", image_size=16)
    closed = []

    def source():
        try:
            yield from datasets.BatchLoader(ds, 2, repeat=True)
        finally:
            closed.append(True)

    gen = device_prefetch(source(), lambda b: to_device(b[0], torch.device(
        "cpu")))
    (images, _), dev = next(gen)
    assert torch.equal(dev, torch.from_numpy(images))
    gen.close()
    assert closed == [True]


def test_to_device_on_the_cpu_is_the_host_tensor():
    arr = np.arange(6, dtype=np.int32)
    out = to_device(arr, torch.device("cpu"), torch.long)
    assert out.dtype == torch.long and out.tolist() == list(range(6))
    f = np.ones((2, 2), np.float32)
    same = to_device(f, torch.device("cpu"))
    assert same.data_ptr() == f.ctypes.data  # no copy, as .to("cpu")


def test_library_name_follows_source_flags_and_cpu(tmp_path):
    src = native_build.NATIVE_SRC / "batch_loader.cpp"
    base = native_build.library_path(src, ["-lpthread"])
    assert base.parent == native_build.BUILD_DIR
    assert base.name.startswith("batch_loader-") and base.suffix == ".so"
    assert base == native_build.library_path(src, ["-lpthread"])
    assert base != native_build.library_path(src, ["-lpthread", "-g"])
    assert base != native_build.library_path(src, ["-lpthread"],
                                             cpu="another cpu")
    assert base == native_build.library_path(
        src, ["-lpthread"], cpu=native_build.cpu_identity())
    edited = tmp_path / "batch_loader.cpp"
    edited.write_text(src.read_text() + "\n// edited\n")
    assert base.name != native_build.library_path(edited,
                                                  ["-lpthread"]).name
    assert "flags" in native_build.cpu_identity()


def test_two_processes_building_at_once_each_load_a_whole_library(tmp_path):
    src = tmp_path / "batch_loader.cpp"
    src.write_text((native_build.NATIVE_SRC / "batch_loader.cpp").read_text()
                   + f"\n// {tmp_path.name}\n")  # not built before
    code = (
        "import ctypes, sys\n"
        "from pathlib import Path\n"
        "from vqgan_tpu_torch.data import native_build as nb\n"
        f"nb.BUILD_DIR = Path({str(tmp_path / 'build')!r})\n"
        f"so = nb.build_native_lib(Path({str(src)!r}), ['-lpthread'])\n"
        "lib = ctypes.CDLL(str(so))\n"
        "print(so.name, lib.batch_loader_abi_version())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1] and outs[0][1] == "1"
    built = list((tmp_path / "build").iterdir())
    assert [p.name for p in built] == [outs[0][0]]  # no temporary left


@pytest.mark.parametrize("name", ["image_decoder.cpp", "batch_loader.cpp"])
def test_port_sources_are_the_jax_sources_below_the_header(name):
    def code(path):
        text = path.read_text()
        return text[text.index("#include"):]

    assert code(native_build.NATIVE_SRC / name) == code(REPO / "native" /
                                                        name)
