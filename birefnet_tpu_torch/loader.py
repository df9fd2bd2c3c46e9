"""Serving data loader: host-side decode and batching for the pipeline.

Counterpart of birefnet_tpu/loader.py. It turns a stream of images of
any sizes into fixed-shape uint8 batches on the host: decode (PIL, or an
array given as is) and the native antialiased triangle resize to the
model size (utils/native.py, OpenMP) run on a thread pool, and prepared
batches are buffered ahead of the consumer, while normalization and the
model run on the device (pipeline.py). finetune.py reads its frames with
`load_frame`; serve.main reads its batches from `BatchLoader`.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .utils import native

ImageSource = Union[str, np.ndarray]


def _decode(src: ImageSource) -> np.ndarray:
    """[H, W, 3] uint8 from a path (PIL) or an array (gray arrays are
    repeated to three channels, a fourth channel is dropped)."""
    if isinstance(src, np.ndarray):
        arr = src
        if arr.ndim == 2:
            arr = arr[..., None].repeat(3, -1)
        return np.ascontiguousarray(arr[..., :3], np.uint8)
    from PIL import Image
    with Image.open(src) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def load_frame(src: ImageSource,
               size: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Decode and triangle-resize one image to [size, size, 3] uint8.
    Returns (frame, (orig_h, orig_w))."""
    img = _decode(src)
    oh, ow = img.shape[:2]
    if (oh, ow) != (size, size):
        img = native.resize_triangle_u8(img, size, size)
    return img, (oh, ow)


class BatchLoader:
    """Iterate fixed-shape uint8 batches over an image stream.

    Decode and resize run on `workers` threads (the native resize releases
    the GIL inside OpenMP); up to `prefetch` prepared batches are buffered
    so the host stays ahead of the device. The batches are bitwise those
    of birefnet_tpu.loader.BatchLoader for the same sources.
    """

    def __init__(self, sources: Sequence[ImageSource], batch_size: int = 4,
                 size: int = 1024, workers: Optional[int] = None,
                 prefetch: int = 2, drop_remainder: bool = False):
        self.sources = list(sources)
        self.batch_size = batch_size
        self.size = size
        self.workers = workers or min(8, os.cpu_count() or 4)
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder

    def __len__(self) -> int:
        n = len(self.sources)
        return (n // self.batch_size if self.drop_remainder
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, List[Tuple[int, int]]]]:
        """Yields (frames [B, size, size, 3] uint8, list of original sizes).

        The final batch is zero-padded to batch_size (one input shape, so
        one CUDA graph, per run) unless drop_remainder; its size list keeps
        the true length.
        """
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        # Set when the consumer abandons the iterator early (generator close
        # or an exception): the producer checks it around every bounded put,
        # so the thread and its pool always wind down in a long-lived server.
        cancelled = threading.Event()

        def _put(item) -> bool:
            while not cancelled.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            with cf.ThreadPoolExecutor(self.workers) as pool:
                bs = self.batch_size
                n = len(self.sources)
                end = (n // bs) * bs if self.drop_remainder else n
                for i in range(0, end, bs):
                    if cancelled.is_set():
                        return
                    chunk = self.sources[i:i + bs]
                    results = list(pool.map(
                        lambda s: load_frame(s, self.size), chunk))
                    frames = np.stack([r[0] for r in results])
                    sizes = [r[1] for r in results]
                    if frames.shape[0] < bs:
                        pad = bs - frames.shape[0]
                        frames = np.concatenate(
                            [frames, np.zeros((pad, *frames.shape[1:]),
                                              np.uint8)])
                    if not _put((frames, sizes)):
                        return
            _put(stop)

        def producer():
            # A source that fails to decode reaches the consumer as its
            # exception: a producer that died silently would leave it
            # waiting on the queue forever.
            try:
                produce()
            except Exception as e:  # noqa: BLE001 - re-raised by the consumer
                _put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            cancelled.set()
            t.join()
