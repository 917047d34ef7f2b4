"""Training data on the host (a copy of `ransacflow_tpu/train/data.py`, the
PIL path, single process).

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


def train_transform(i1, i2, crop, rng, use_native=False):
    """Same-geometry augmentation for a pre-aligned PIL pair. Returns
    float32 (crop, crop, 3) arrays in [0, 1]."""
    if use_native:
        raise NotImplementedError("use_native: the port has no native Lanczos "
                                  "resampler yet (ROADMAP.md queue 1, item 11)")
    resize = int(rng.choice([crop, crop + crop // 2, crop * 2]))
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
    """Image groups ``{index}_{1..cycle}.jpg``; samples 2 distinct views."""

    def __init__(self, img_dir, img_size=224, seed=0, use_native=False):
        if use_native:
            raise NotImplementedError("use_native: the port has no native Lanczos "
                                      "resampler yet (ROADMAP.md queue 1, item 11)")
        self.img_dir = img_dir
        self.cycle = 3 if os.path.exists(os.path.join(img_dir, "1_3.jpg")) else 2
        self.indices = list(range(len(os.listdir(img_dir)) // self.cycle))
        self.img_size = img_size
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.indices)

    def sample(self, i):
        idx = self.indices[i]
        a, b = self.rng.choice(range(1, self.cycle + 1), 2, replace=False)
        i1 = Image.open(os.path.join(self.img_dir, f"{idx}_{a}.jpg")).convert("RGB")
        i2 = Image.open(os.path.join(self.img_dir, f"{idx}_{b}.jpg")).convert("RGB")
        return train_transform(i1, i2, self.img_size, self.rng)

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
