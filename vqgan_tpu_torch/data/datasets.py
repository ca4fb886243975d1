"""Host-side data pipeline: the port's copy of what training needs from
vqgan_tpu/data/datasets.py.

- `load_image`: Resize(shorter side) + CenterCrop + [0, 1] float32 HWC,
  with PIL (the reference's torchvision transform); with
  `imagenet_norm`, then normalised by `IMAGENET_MEAN` / `IMAGENET_STD`
  (the classifier's input).
- `ImageFolderDataset`: the split's images of each `ID_x` user folder,
  (image, 0-based label) items; `get_batch` decodes a whole batch with the
  native C++ decoder (`native_image.decode_jpeg_batch`) where the batch is
  all JPEG and not ImageNet-normalised (`native_decodable`), with PIL
  otherwise.
- `SyntheticDataset`: every image of the `ID_x` folders of generated
  images, label x - 1, optionally only the 0-based labels of
  `user_filter`.
- `pad_to_batch`: zero rows up to a whole batch, so an encoder runs at one
  shape; callers slice the real rows back out.
- `BatchLoader`: a shuffling batch iterator that assembles batches on a
  background thread, double-buffered, so the device does not wait on the
  host; through the dataset's `get_batch` where it has one. Same seed, same
  batches as the JAX package's. `native_image.make_batch_loader` chooses
  between it and the native ring.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .splits import IMAGE_EXTENSIONS, train_images_for_user

__all__ = ["load_image", "ImageFolderDataset", "SyntheticDataset",
           "BatchLoader", "IMAGENET_MEAN", "IMAGENET_STD", "pad_to_batch",
           "is_jpeg", "native_decodable"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def pad_to_batch(imgs: np.ndarray, batch_size: int) -> np.ndarray:
    """Zero-pad a partial batch up to `batch_size` rows."""
    pad = batch_size - len(imgs)
    if pad <= 0:
        return imgs
    return np.concatenate(
        [imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])


def load_image(path: str | Path, image_size: int,
               imagenet_norm: bool = False) -> np.ndarray:
    """[image_size, image_size, 3] float32 in [0, 1], or ImageNet-normalised
    after the resize and crop."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = image_size / min(w, h)
    img = img.resize((max(image_size, round(w * scale)),
                      max(image_size, round(h * scale))), Image.BILINEAR)
    w, h = img.size
    left, top = (w - image_size) // 2, (h - image_size) // 2
    img = img.crop((left, top, left + image_size, top + image_size))
    arr = np.asarray(img, np.float32) / 255.0
    if imagenet_norm:
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr


class ImageFolderDataset:
    """Split-driven dataset over `ID_x` user folders. subset: "train" |
    "test" | "gen_train" | "class_train", the split list read per user
    (gen/class fall back to train_images when absent)."""

    def __init__(self, data_path: str | Path, split: Dict,
                 subset: str = "train", image_size: int = 256,
                 imagenet_norm: bool = False):
        self.data_path = Path(data_path)
        self.image_size = image_size
        self.imagenet_norm = imagenet_norm
        self.items: List[Tuple[Path, int]] = []  # (path, 0-based label)
        for user, info in split["users"].items():
            label = int(user.split("_")[1]) - 1
            if subset == "train":
                names = train_images_for_user(split, user)
            elif subset == "test":
                names = info["test_images"]
            elif subset == "gen_train":
                names = info.get("gen_train_images",
                                 info.get("train_images", []))
            elif subset == "class_train":
                names = info.get("class_train_images",
                                 info.get("train_images", []))
            else:
                raise ValueError(f"unknown subset {subset!r}")
            for name in names:
                self.items.append((self.data_path / user / name, label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        path, label = self.items[i]
        return load_image(path, self.image_size, self.imagenet_norm), label

    def get_batch(self, idxs) -> Tuple[np.ndarray, np.ndarray]:
        """The batch of `idxs` at once: the native C++ decoder (threaded
        decode, resize and crop into one contiguous buffer) for an all-JPEG
        batch without ImageNet normalisation where the library is present,
        else PIL per item. A decode error raises."""
        paths = [self.items[int(i)][0] for i in idxs]
        labels = np.asarray([self.items[int(i)][1] for i in idxs], np.int32)
        if native_decodable(self, paths):
            from .native_image import decode_jpeg_batch

            batch = decode_jpeg_batch(paths, self.image_size)
            if batch is not None:
                return batch, labels
        imgs = [load_image(p, self.image_size, self.imagenet_norm)
                for p in paths]
        return np.stack(imgs), labels


def is_jpeg(path) -> bool:
    """Whether `path` names a JPEG (the native decoder reads no other)."""
    return str(path).lower().endswith((".jpg", ".jpeg"))


def native_decodable(dataset, paths=None) -> bool:
    """Whether the native decoder may read `paths` of `dataset` (default:
    every path of its `.items`): the dataset has `.items` and an
    `image_size`, is not ImageNet-normalised, and every path is a JPEG.
    The one rule behind `get_batch`, `make_batch_loader` and
    `loader_kind`; whether the library is present is theirs to ask."""
    if not (hasattr(dataset, "items") and hasattr(dataset, "image_size")):
        return False
    if getattr(dataset, "imagenet_norm", False):
        return False
    if paths is None:
        paths = (p for p, _ in dataset.items)
    return all(is_jpeg(p) for p in paths)


class SyntheticDataset:
    """Generated images in `ID_x/*.{png,jpg,jpeg}` folders, label x - 1;
    `user_filter`: the 0-based labels to keep (default all)."""

    def __init__(self, synthetic_folder: str | Path, image_size: int = 256,
                 imagenet_norm: bool = False,
                 user_filter: Optional[Sequence[int]] = None):
        self.image_size = image_size
        self.imagenet_norm = imagenet_norm
        self.items: List[Tuple[Path, int]] = []
        for d in sorted(Path(synthetic_folder).glob("ID_*")):
            if not d.is_dir():
                continue
            label = int(d.name.split("_")[1]) - 1
            if user_filter is not None and label not in user_filter:
                continue
            self.items += [(p, label) for p in sorted(d.iterdir())
                           if p.suffix.lower() in IMAGE_EXTENSIONS]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        path, label = self.items[i]
        return load_image(path, self.image_size, self.imagenet_norm), label


class BatchLoader:
    """Shuffling, prefetching batch iterator over an indexable dataset of
    (array, label) items; yields (stacked arrays, int32 labels)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2,
                 repeat: bool = False):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if drop_last and len(dataset) < batch_size:
            raise ValueError(
                f"dataset has {len(dataset)} items < batch_size {batch_size} "
                f"with drop_last=True: no batch can ever be produced")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch
        self.repeat = repeat

    def _epoch_order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def _make_batch(self, idxs):
        get_batch = getattr(self.dataset, "get_batch", None)
        if get_batch is not None:
            return get_batch(idxs)
        items, labels = zip(*(self.dataset[int(i)] for i in idxs))
        return np.stack(items), np.asarray(labels, np.int32)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            """put() that observes `stop` while the queue is full."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                while True:
                    order = self._epoch_order()
                    n = len(order)
                    end = n - (n % self.batch_size) if self.drop_last else n
                    for s in range(0, end, self.batch_size):
                        if not put(self._make_batch(
                                order[s:s + self.batch_size])):
                            return
                    if not self.repeat:
                        break
                put(None)
            except BaseException as ex:
                # a dataset error reaches the consumer instead of leaving it
                # blocked on an empty queue
                put(ex)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)
