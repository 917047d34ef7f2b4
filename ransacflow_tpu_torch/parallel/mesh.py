"""Devices, replicas and the sharded serving paths (port of
`ransacflow_tpu/parallel/mesh.py`).

A "mesh" here is an ordered list of devices, which may repeat (two slots on
one card, or CPU slots in tests). The serving paths are embarrassingly
parallel and need no process group: one host thread a device, each
launching the port's kernels on its own device, the results gathered to the
first device. Data-parallel training, which does need collectives, is
`parallel.group` and `train.trainer.train_grads`. (The pipeline and kernel
modules are imported inside the functions: the network layers import
`parallel.group`.)
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import torch

from ransacflow_tpu_torch.device import as_device


def make_mesh(n_devices=None, devices=None):
    """The first `n_devices` of `devices` (a list, repeats allowed), or of
    the machine's cards cuda:0 ... cuda:n-1 (all of them for None). Raises,
    naming the count, when there are fewer."""
    if devices is None:
        have = torch.cuda.device_count()
        n = have if n_devices is None else n_devices
        if not 1 <= n <= have:
            raise RuntimeError(f"a mesh of {n} cuda devices: this machine has {have}")
        return [torch.device("cuda", i) for i in range(n)]
    devices = [as_device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise RuntimeError(f"a mesh of {n_devices} devices from a list of {len(devices)}")
        devices = devices[:n_devices]
    return devices


def replicate(module_or_dict, devices):
    """One copy of a module (or a dict of modules) on each device of
    `devices`, in order."""
    def to(x, d):
        if isinstance(x, dict):
            return {k: copy.deepcopy(v).to(d) for k, v in x.items()}
        return copy.deepcopy(x).to(d)

    return [to(module_or_dict, d) for d in devices]


def shard_batch(x, devices):
    """The leading axis of `x` split into len(devices) equal shards, shard i
    on devices[i]. Raises unless the count divides the axis."""
    n = len(devices)
    if x.shape[0] % n:
        raise ValueError(f"the mesh size ({n}) must divide the batch ({x.shape[0]}): "
                         "pad or bucket the batch")
    return [s.to(d) for s, d in zip(torch.chunk(x, n), devices)]


def _replicas(nets, devices):
    """`nets` if it is already one replica a device (`replicate`), else its
    replicas."""
    if isinstance(nets, list):
        if len(nets) != len(devices):
            raise ValueError(f"{len(nets)} replicas for {len(devices)} devices")
        return nets
    return replicate(nets, devices)


def per_device(devices, work):
    """work(i, device) for each device in its own thread, under
    `torch.cuda.device` on a card; the results in device order (a worker's
    exception raises here). The fan-out of the sharded paths here and of
    `eval.kitti.pooled_kitti_predict`'s slots."""
    devices = [as_device(d) for d in devices]

    def run(i):
        d = devices[i]
        if d.type == "cuda":
            with torch.cuda.device(d):
                return work(i, d)
        return work(i, d)

    with ThreadPoolExecutor(max_workers=len(devices)) as ex:
        futures = [ex.submit(run, i) for i in range(len(devices))]
        return [f.result() for f in futures]


def draw_seeds(generator, n):
    """n int64 seeds in [0, 2**62) from `generator` (the default CPU
    generator for None), read to the host: one per pair or shard, drawn up
    front, so that what each one draws does not depend on the devices."""
    device = "cpu" if generator is None else generator.device
    return torch.randint(0, 2 ** 62, (n,), generator=generator, device=device).tolist()


def seeded_generators(seeds, device):
    """One `torch.Generator` on `device` a seed."""
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def sharded_align_pairs(devices, resnet, align, pyramids, targets, generator=None,
                        tolerance=0.05, n_iter=10000, kernel_size=7, cycle_match=True,
                        adaptive_chunk=0, anchor_stride=0, relax_cells=0,
                        injected_samples=None):
    """`pipeline.fused.fused_align_batch` over K same-shape pairs split
    across `devices` (K/n consecutive pairs a device, no collectives).

    resnet, align: the networks, or their replicas (`replicate`) one a
      device; pyramids: tuple of (K, 1, Hi, Wi, 3) scales; targets
      (K, 1, Ht, Wt, 3); on any device.
    generator: K seeds are drawn from it up front (`draw_seeds`), pair k
      drawing its RANSAC sets from a generator seeded with seed k on its
      device, so a pair's outputs do not depend on the device count.
    injected_samples: optional (K, rows, 4) RANSAC sets, pair k's used
      instead of drawing (`fused_align`'s `injected_samples`).

    Returns the dict of `fused_align_batch`, leading axis K in pair order,
    on devices[0]. Raises unless len(devices) divides K.
    """
    from ransacflow_tpu_torch.pipeline.fused import fused_align_batch

    n, k = len(devices), targets.shape[0]
    if k % n:
        raise ValueError(f"the mesh size ({n}) must divide the pair count ({k}): "
                         "pad or bucket the batch")
    resnets, aligns = _replicas(resnet, devices), _replicas(align, devices)
    seeds = draw_seeds(generator, k) if injected_samples is None else None
    per = k // n

    def work(i, d):
        share = slice(i * per, (i + 1) * per)
        kw = dict(tolerance=tolerance, n_iter=n_iter, kernel_size=kernel_size,
                  cycle_match=cycle_match, adaptive_chunk=adaptive_chunk,
                  anchor_stride=anchor_stride, relax_cells=relax_cells)
        if injected_samples is None:
            kw["generator"] = seeded_generators(seeds[share], d)
        else:
            kw["injected_samples"] = injected_samples[share]
        return fused_align_batch(resnets[i], aligns[i], tuple(p[share].to(d) for p in pyramids),
                                 targets[share].to(d), **kw)

    outs = per_device(devices, work)
    first = as_device(devices[0])
    return {key: torch.cat([o[key].to(first) for o in outs]) for key in outs[0]}


def sharded_ransac(devices, match1, match2, valid, tolerance, n_iter=10000,
                   generator=None, injected_samples=None, **kwargs):
    """RANSAC with the hypotheses split across `devices`: each fits
    ceil(n_iter / n) hypotheses (kernel 3, `ops.ransac.ransac_homography`)
    on the whole match set from its own seed (`draw_seeds`, one a device),
    and the winner is the device with the most inliers, the first device on
    ties (argmax). injected_samples: optional list of one (ceil(n_iter / n),
    n_points) set array a device, used instead of drawing. kwargs:
    `ransac_homography`'s (n_points, transform).

    Returns the winner's `RansacResult` on devices[0].
    """
    from ransacflow_tpu_torch.kernels.ransac import RansacResult
    from ransacflow_tpu_torch.ops.ransac import ransac_homography

    n = len(devices)
    per = -(-n_iter // n)
    seeds = draw_seeds(generator, n) if injected_samples is None else None

    def work(i, d):
        draws = ({"generator": seeded_generators(seeds[i:i + 1], d)[0]}
                 if injected_samples is None else {"injected_samples": injected_samples[i]})
        return ransac_homography(match1.to(d), match2.to(d), valid.to(d), tolerance,
                                 n_iter=per, **draws, **kwargs)

    results = per_device(devices, work)
    first = as_device(devices[0])
    fields = [torch.stack([getattr(r, f).to(first) for r in results])
              for f in RansacResult._fields]
    best = torch.argmax(fields[1]).view(1)  # num_inliers; the first maximum
    return RansacResult(*(x.index_select(0, best)[0] for x in fields))
