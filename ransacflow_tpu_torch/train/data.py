"""Training data on the host (a copy of `ransacflow_tpu/train/data.py`): PIL's
resize, or the native Lanczos resampler with `use_native`.

Pre-aligned image groups named ``{index}_{1..cycle}.jpg``; each sample draws
2 distinct views, resizes both to one of {crop, 1.5*crop, 2*crop} min-side
(floored to a multiple of 8) and applies the SAME random crop and
horizontal flip to both. The same seed gives the JAX module's batches. The
port keeps its own copy because importing the JAX package's module imports
JAX.
"""

import os
import queue
import threading

import numpy as np
from PIL import Image

from ransacflow_tpu_torch.utils.image import to_array


def _resize_min8(img, min_size):
    w, h = img.size
    ratio = min(w / min_size, h / min_size)
    new_w = int(round(w / ratio)) // 8 * 8
    new_h = int(round(h / ratio)) // 8 * 8
    return img.resize((new_w, new_h), resample=Image.LANCZOS)


def _native_transform(i1, i2, crop, resize, rng):
    """`train_transform` with the resize on float arrays through the native
    resampler (`ransacflow_tpu_torch.native`, which raises when it cannot
    be built)."""
    from ransacflow_tpu_torch.native import lanczos_resize

    a1 = np.asarray(i1, np.float32) / 255.0
    a2 = np.asarray(i2, np.float32) / 255.0
    h, w = a1.shape[:2]
    ratio = min(w / resize, h / resize)
    new_w = int(round(w / ratio)) // 8 * 8
    new_h = int(round(h / ratio)) // 8 * 8
    a1 = lanczos_resize(a1, new_h, new_w)
    a2 = lanczos_resize(a2, new_h, new_w)
    idw = rng.randint(new_w - crop) if new_w > crop else 0
    idh = rng.randint(new_h - crop) if new_h > crop else 0
    a1 = a1[idh:idh + crop, idw:idw + crop]
    a2 = a2[idh:idh + crop, idw:idw + crop]
    if rng.rand() >= 0.5:
        a1, a2 = a1[:, ::-1], a2[:, ::-1]
    return np.ascontiguousarray(a1), np.ascontiguousarray(a2)


def train_transform(i1, i2, crop, rng, use_native=False):
    """Same-geometry augmentation for a pre-aligned PIL pair. Returns
    float32 (crop, crop, 3) arrays in [0, 1]. use_native: resize with the
    native Lanczos resampler instead of PIL."""
    resize = int(rng.choice([crop, crop + crop // 2, crop * 2]))
    if use_native:
        return _native_transform(i1, i2, crop, resize, rng)
    i1 = _resize_min8(i1, resize)
    i2 = _resize_min8(i2, resize)
    w, h = i1.size
    idw = rng.randint(w - crop) if w > crop else 0
    idh = rng.randint(h - crop) if h > crop else 0
    box = (idw, idh, idw + crop, idh + crop)
    i1, i2 = i1.crop(box), i2.crop(box)
    if rng.rand() >= 0.5:
        i1 = i1.transpose(Image.FLIP_LEFT_RIGHT)
        i2 = i2.transpose(Image.FLIP_LEFT_RIGHT)
    return to_array(i1), to_array(i2)


class PairFolder:
    """Image groups ``{index}_{1..cycle}.jpg``; samples 2 distinct views.

    shard_index, num_shards: this rank's share of the groups under data
    parallelism, rank-strided over the index list padded by wrapping to a
    multiple of num_shards, so that every shard has the same length (the
    reference's DistributedSampler): every rank then runs as many steps an
    epoch, and no rank waits in a collective that another never joins."""

    def __init__(self, img_dir, img_size=224, seed=0, shard_index=0, num_shards=1,
                 use_native=False):
        self.img_dir = img_dir
        self.cycle = 3 if os.path.exists(os.path.join(img_dir, "1_3.jpg")) else 2
        n_total = len(os.listdir(img_dir)) // self.cycle
        padded = list(range(n_total))
        padded += padded[:-(-n_total // num_shards) * num_shards - n_total]
        self.indices = padded[shard_index::num_shards]
        self.img_size = img_size
        self.rng = np.random.RandomState(seed)
        self.use_native = use_native

    def __len__(self):
        return len(self.indices)

    def sample(self, i):
        idx = self.indices[i]
        a, b = self.rng.choice(range(1, self.cycle + 1), 2, replace=False)
        i1 = Image.open(os.path.join(self.img_dir, f"{idx}_{a}.jpg")).convert("RGB")
        i2 = Image.open(os.path.join(self.img_dir, f"{idx}_{b}.jpg")).convert("RGB")
        return train_transform(i1, i2, self.img_size, self.rng, use_native=self.use_native)

    def epoch_batches(self, batch_size, drop_last=True, shuffle=True):
        """Yield dicts {'I1': (B,H,W,3), 'I2': (B,H,W,3)} float32."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        n = len(order) // batch_size * batch_size if drop_last else len(order)
        for start in range(0, n, batch_size):
            chunk = order[start:start + batch_size]
            if drop_last and len(chunk) < batch_size:
                break
            pairs = [self.sample(i) for i in chunk]
            yield {"I1": np.stack([p[0] for p in pairs]),
                   "I2": np.stack([p[1] for p in pairs])}


def prefetch(iterator, depth=2):
    """Run `iterator` in a background thread with a bounded queue."""
    q = queue.Queue(maxsize=depth)
    done = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(done)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is done:
            return
        yield item
