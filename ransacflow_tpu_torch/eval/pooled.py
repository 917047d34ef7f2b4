"""The eval pool: prediction pairs spread over slots, each slot a
`CoarseAligner` with its own copy of the networks on its own device (port of
`ransacflow_tpu/eval/pooled.py`).

Each pair's device-resident multi-homography loop
(`pipeline.multihomo._fused_multi_homo`) is dispatched on its slot and its
result drained through a bounded queue (`PendingDrain`); `--batchPairs`
groups pairs of one resized shape into `_fused_multi_homo_batch` calls
(`BatchedMultiHomoDispatcher`). A slot's device may repeat, so a pool of n
slots runs on one card (or on the CPU) as well as on n cards.

Artifacts are the same for any pool size and with or without batching: each
pair draws from a generator that depends on (seed, pair index) alone
(`CoarseAligner.reseed`). The batched loop is a Python loop over its pairs,
so batching gives the same launches as the per-pair path, not fewer.
"""

import copy
import itertools
from collections import deque

import numpy as np
import torch

from ransacflow_tpu_torch.device import as_device
from ransacflow_tpu_torch.pipeline.coarse import CoarseAligner
from ransacflow_tpu_torch.pipeline.fine import fine_features
from ransacflow_tpu_torch.pipeline.multihomo import (
    _fused_multi_homo,
    _fused_multi_homo_batch,
    multi_homography_dispatch,
    multi_homography_finalize,
)


def pool_devices(n_devices, device):
    """The pool's devices. `n_devices` is a list of devices (one may repeat),
    or an int k: the first k devices of `device`'s type (cuda:0 ...
    cuda:k-1; the CPU counts as one device). Raises, naming the count, when
    the machine has fewer."""
    if not isinstance(n_devices, int):
        return [as_device(d) for d in n_devices]
    kind = torch.device(device).type
    have = torch.cuda.device_count() if kind == "cuda" else 1
    if not 1 <= n_devices <= have:
        raise RuntimeError(f"a pool of {n_devices} {kind} devices: this machine has {have}")
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(n_devices)]
    return [torch.device(kind)]


def make_device_pool(resnet, align, devices, coarse_kwargs):
    """One (CoarseAligner, alignment networks) slot per entry of the list
    `devices` (`pool_devices`), each holding its own copy of the networks on
    its device. Shared by every pooled entry point (this module,
    `eval.yfcc`, `eval.kitti`)."""
    pool = []
    for d in map(as_device, devices):
        nets = {k: copy.deepcopy(v).to(d) for k, v in align.items()}
        pool.append((CoarseAligner(copy.deepcopy(resnet).to(d), d, **coarse_kwargs), nets))
    return pool


class PendingDrain:
    """Bounded queue of dispatched device-resident loops.

    `add` enqueues one pair's (idx, final, bg, *extras) and drains down to
    the bound (2 x the number of slots); `add_batch` enqueues a batched
    dispatch of several pairs; `flush` drains the rest. Draining reads a
    loop's result back and calls ``save_fn(idx, artifact, *extras)`` for
    each pair with a prediction.
    """

    def __init__(self, n_slots, save_fn):
        self._pending = deque()
        self._bound = 2 * n_slots
        self._save_fn = save_fn
        self._size = 0

    def _drain_one(self):
        kind, payload = self._pending.popleft()
        if kind == "one":
            idx, final, bg, extras = payload
            self._size -= 1
            art = multi_homography_finalize(final, bg)
            if art is not None:
                self._save_fn(idx, art, *extras)
            return
        idxs, final, bgs, extras_list = payload
        self._size -= len(idxs)
        counts = final["count"].cpu().numpy()
        hs = final["hs"].cpu().numpy().astype(np.float32)
        flows = final["flows"].cpu().numpy()
        matches = final["matches"].cpu().numpy()
        for i, idx in enumerate(idxs):
            n = int(counts[i])
            if n == 0:
                continue
            art = {"coarse_h": hs[i, :n], "fine_flow_down8": flows[i, :n],
                   "fine_match_down8": matches[i, :n], "bg_mask": bgs[i].astype(bool)}
            self._save_fn(idx, art, *extras_list[i])

    def _shrink(self):
        while self._size > self._bound:
            self._drain_one()

    def add(self, idx, final, bg, *extras):
        self._pending.append(("one", (idx, final, bg, extras)))
        self._size += 1
        self._shrink()

    def add_batch(self, idxs, final, bgs, extras_list):
        """Enqueue one `_fused_multi_homo_batch` result covering `idxs`."""
        self._pending.append(("batch", (idxs, final, bgs, extras_list)))
        self._size += len(idxs)
        self._shrink()

    def flush(self):
        while self._pending:
            self._drain_one()


class BatchedMultiHomoDispatcher:
    """Shape-bucketed batched dispatch of the multi-homography loop.

    Buckets are keyed by (slot, source shape, target shape). A bucket
    dispatches when `batch_pairs` entries have gathered; `flush` dispatches
    the rest (a single pair through the per-pair loop). Each proxy key (the
    caller's pre-resize shape signature, e.g. the PIL sizes) is given a slot
    round robin, and moves to the next slot each time one of its batches
    dispatches, so that a dataset of one shape still spreads over the pool.

    An entry keeps what its slot held when it was added: the bank, the
    target features, the cached matches, the fine features and the pair's
    generator (the slot's next `set_pair` replaces them).
    """

    def __init__(self, pool, drain, batch_pairs, max_coarse=10, mask_region_th=0.01,
                 cycle_match=True, kernel_size=7):
        self._pool = pool
        self._drain = drain
        self._batch_pairs = batch_pairs
        self._mask_region_th = mask_region_th
        self._loop_kw = dict(max_coarse=max_coarse, cycle_match=cycle_match,
                             kernel_size=kernel_size)
        self._buckets = {}
        self._slot_of_proxy = {}
        self._rr = itertools.count()

    def slot(self, proxy_key):
        """The pool slot of a pair with this pre-resize shape signature; the
        caller sets the pair on pool[slot] before `add`."""
        if proxy_key not in self._slot_of_proxy:
            self._slot_of_proxy[proxy_key] = next(self._rr) % len(self._pool)
        return self._slot_of_proxy[proxy_key]

    @torch.inference_mode()
    def add(self, proxy_key, idx, bg, generator, *extras):
        """Add the pair set on pool[slot(proxy_key)], drawing from
        `generator`, to its shape bucket; dispatch the bucket when full."""
        slot = self.slot(proxy_key)
        aligner, align = self._pool[slot]
        ht, wt = aligner.tgt_array.shape[:2]
        bg = np.ones((ht, wt), np.float32) if bg is None else np.asarray(bg, np.float32)
        entry = {
            "idx": idx, "bank": aligner._bank, "featt": aligner._featt,
            "cs": aligner._cached_src, "cv": aligner._cached_valid,
            "src": aligner.put(aligner.src_array)[None],
            "ffine": fine_features(align, aligner.put(aligner.tgt_array)[None]),
            "bg": bg, "generator": generator, "extras": extras,
        }
        bkey = (slot, aligner.src_array.shape, aligner.tgt_array.shape)
        bucket = self._buckets.get(bkey)
        if bucket is None:
            # the shape's shared state and the aligner's settings, kept now:
            # the slot may hold another shape when the bucket dispatches
            bucket = self._buckets[bkey] = {
                "slot": slot,
                "coords": (aligner._coordsA, aligner._coordsB),
                "static": dict(
                    feat_h=aligner.feat_h, feat_w=aligner.feat_w, n_iter=aligner.n_iter,
                    rematch=aligner.rematch, adaptive_chunk=aligner.adaptive_chunk,
                    relax_cells=aligner.relax_cells, n_points=aligner.n_points,
                    transform=aligner.transform),
                "tolerance": aligner.tolerance,
                "entries": [],
            }
        bucket["entries"].append(entry)
        if len(bucket["entries"]) >= self._batch_pairs:
            self._dispatch(bkey)
            # this proxy's next batch goes to the next slot
            self._slot_of_proxy[proxy_key] = next(self._rr) % len(self._pool)

    def _dispatch(self, bkey):
        bucket = self._buckets.pop(bkey)
        entries = bucket["entries"]
        aligner, align = self._pool[bucket["slot"]]
        coords_a, coords_b = bucket["coords"]
        kw = dict(bucket["static"], **self._loop_kw)
        args = (bucket["tolerance"], self._mask_region_th)
        if len(entries) == 1:
            e = entries[0]
            final = _fused_multi_homo(align, e["bank"], e["featt"], coords_a, coords_b,
                                      e["cs"], e["cv"], e["src"], e["ffine"],
                                      aligner.put(e["bg"]), e["generator"], *args, **kw)
            self._drain.add(e["idx"], final, e["bg"], *e["extras"])
            return
        final = _fused_multi_homo_batch(
            align, [e["bank"] for e in entries], [e["featt"] for e in entries],
            coords_a, coords_b, [e["cs"] for e in entries], [e["cv"] for e in entries],
            [e["src"] for e in entries], [e["ffine"] for e in entries],
            [aligner.put(e["bg"]) for e in entries], [e["generator"] for e in entries],
            *args, **kw)
        self._drain.add_batch([e["idx"] for e in entries], final,
                              [e["bg"] for e in entries], [e["extras"] for e in entries])

    def flush(self):
        for bkey in list(self._buckets):
            self._dispatch(bkey)
        self._drain.flush()


def pooled_multihomo_predict(pairs, resnet, align, devices, coarse_kwargs, save_fn,
                             max_coarse=10, mask_region_th=0.01, cycle_match=True,
                             kernel_size=7, batch_pairs=None):
    """Predict multi-homography artifacts for `pairs` over a pool.

    pairs: iterable of (idx, source PIL, target PIL, bg_mask or None).
    resnet, align: the coarse trunk and the alignment networks (copied to
      each slot's device).
    devices: the slots' devices, a list (`pool_devices`).
    coarse_kwargs: `CoarseAligner`'s keyword arguments (nb_scale, n_iter,
      tolerance, seed, ...); pair idx draws from `reseed(idx)`'s generator.
    save_fn: callable(idx, artifact dict) for each pair with a prediction.
    batch_pairs > 1: group same-resized-shape pairs into batched loop
      dispatches (`BatchedMultiHomoDispatcher`), with the same artifacts.
    """
    pool = make_device_pool(resnet, align, devices, coarse_kwargs)
    drain = PendingDrain(len(pool), save_fn)
    loop_kw = dict(max_coarse=max_coarse, mask_region_th=mask_region_th,
                   cycle_match=cycle_match, kernel_size=kernel_size)
    if batch_pairs and batch_pairs > 1:
        batcher = BatchedMultiHomoDispatcher(pool, drain, batch_pairs, **loop_kw)
        for idx, i_s, i_t, bg in pairs:
            proxy = (i_s.size, i_t.size)
            aligner, _ = pool[batcher.slot(proxy)]
            aligner.set_pair(i_s, i_t)
            aligner.reseed(idx)
            batcher.add(proxy, idx, bg, aligner.generator)
        batcher.flush()
        return
    for k, (idx, i_s, i_t, bg) in enumerate(pairs):
        aligner, nets = pool[k % len(pool)]
        aligner.set_pair(i_s, i_t)
        aligner.reseed(idx)
        final, bgf = multi_homography_dispatch(aligner, nets, bg_mask=bg, **loop_kw)
        drain.add(idx, final, bgf)
    drain.flush()
