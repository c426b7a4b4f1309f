"""Host-side image loading (eqxvision_tpu/data.py).

Host threads decode images into fixed-size uint8 canvases, batches are
prefetched into a bounded queue, and the resize, crop, augmentation and
normalisation run on the card (``ops.preprocessing``, ``ops.augment``):

    loader = ImageFolderLoader("/data/imagenet/val", batch_size=128)
    for x_u8, y in device_prefetch(loader, 2, "cuda"):
        logits = model(imagenet_eval_pipeline(x_u8))

PIL is imported only where an image is decoded.
"""
from __future__ import annotations

import collections
import itertools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch


def find_imagefolder_samples(root: str) -> Tuple[List[Tuple[str, int]], List[str]]:
    """ImageFolder layout, root/<class>/<image>: the classes sorted
    lexicographically onto indices, as torchvision maps them."""
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    samples = []
    for idx, c in enumerate(classes):
        cdir = os.path.join(root, c)
        for fname in sorted(os.listdir(cdir)):
            samples.append((os.path.join(cdir, fname), idx))
    return samples, classes


def decode_to_canvas(path: str, side: int) -> np.ndarray:
    """Decode an image to a (side, side, 3) uint8 canvas: the shorter side
    scaled to ``side`` (PIL bilinear), then the centre square."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = side / min(w, h)
    img = img.resize((max(side, round(w * scale)), max(side, round(h * scale))), Image.BILINEAR)
    left = (img.width - side) // 2
    top = (img.height - side) // 2
    img = img.crop((left, top, left + side, top + side))
    return np.asarray(img, np.uint8)


class ImageFolderLoader:
    """Threaded, prefetching uint8 batch loader.

    Yields ``(images, labels)``: np.uint8 (B, side, side, 3) and np.int32
    (B,). The ragged tail batch is dropped, so every batch has one shape.
    ``shuffle`` orders the samples by ``np.random.RandomState(seed)``, as
    the JAX loader does, so both give the same batches.

    ``process_shard`` keeps this process's share of the samples
    (``parallel.local_shard``: contiguous, the tail padded by repeating its
    last sample, so that every process yields as many batches): ``True``
    shards by the world's rank and size, an ``(index, count)`` pair by
    another grid's, e.g. a mesh's data index and data size, whose model
    ranks then read the same samples.
    """

    def __init__(
        self,
        root: str,
        batch_size: int = 128,
        side: int = 256,
        shuffle: bool = False,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 4,
        limit: Optional[int] = None,
        process_shard: Union[bool, Tuple[int, int]] = False,
    ):
        self.samples, self.classes = find_imagefolder_samples(root)
        if limit:
            self.samples = self.samples[:limit]
        if process_shard:
            from .parallel.multihost import local_shard

            index, count = (None, None) if process_shard is True else process_shard
            self.samples = local_shard(self.samples, index, count)
        self.batch_size = batch_size
        self.side = side
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.samples) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.samples))
        if self.shuffle:
            np.random.RandomState(self.seed).shuffle(order)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce(pool):
            try:
                for b in range(len(self)):
                    items = [self.samples[i] for i in order[b * self.batch_size : (b + 1) * self.batch_size]]
                    imgs = list(pool.map(lambda it: decode_to_canvas(it[0], self.side), items))
                    if not put((np.stack(imgs), np.asarray([it[1] for it in items], np.int32))):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                put(e)
            finally:
                put(None)

        with ThreadPoolExecutor(self.num_workers) as pool:
            producer = threading.Thread(target=produce, args=(pool,), daemon=True)
            producer.start()
            try:
                while (item := q.get()) is not None:
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()  # a consumer that stops early releases the producer
                producer.join()


def device_prefetch(iterator: Iterable, size: int = 2, device: Union[str, torch.device] = "cuda"):
    """Yield each batch of ``iterator`` (a tuple of arrays) as tensors on
    ``device``, keeping ``size`` batches in flight ahead of the consumer.

    On the card each batch is copied from pinned host memory on a side
    stream with ``non_blocking=True``, so the copy of batch k + 1 overlaps
    the step on batch k; the consumer's stream waits for the copy before it
    reads the tensors. Elsewhere the arrays become tensors in place.
    """
    device = torch.device(device)
    it = iter(iterator)
    if device.type != "cuda":
        for batch in it:
            yield tuple(torch.as_tensor(np.asarray(a), device=device) for a in batch)
        return
    stream = torch.cuda.Stream(device)

    def put(batch):
        with torch.cuda.stream(stream):
            tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(device, non_blocking=True)
                            for a in batch)
        return tensors, stream.record_event()

    buf = collections.deque(put(b) for b in itertools.islice(it, size))
    while buf:
        tensors, copied = buf.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(copied)
        for t in tensors:
            t.record_stream(consumer)  # made on the side stream, freed after the consumer's use
        yield tensors
        buf.extend(put(b) for b in itertools.islice(it, 1))
