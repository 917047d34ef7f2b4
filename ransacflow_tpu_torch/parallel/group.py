"""The process group of data-parallel training and the cross-rank ops on it
(the collectives of `ransacflow_tpu/train/trainer.py:95-144`,
`ransacflow_tpu/train/losses.py:143-150`, `ransacflow_tpu/ops/ssim.py:92-95`
and `ransacflow_tpu/models/layers.py:76-110`, which take an `axis_name`).

One process a rank, each pinned to its device. The backend is named by the
caller: 'nccl' for one card a rank, 'gloo' on the CPU and for ranks that
share a card (NCCL refuses two ranks on one device). A `group` argument is a
`torch.distributed` process group, or None for one process: every op here is
then the identity, and the code that calls it runs as it did without data
parallelism.

The reduction convention (the JAX package's psum and its transpose):
- every cross-rank sum in the forward is `all_reduce_sum`, whose backward
  all-reduces the cotangents (the transpose of psum). Each rank's loss is
  the global loss of the global batch (its ratios' numerators and
  denominators summed over the ranks), and the backward of one rank gives
  the world size times that rank's share of the global gradient;
- `reduce_grads` then AVERAGES the trainable gradients over the ranks: the
  sum of the shares, the gradient of the one large batch.
Mixing this with the other consistent convention (sums whose backward
keeps the local cotangent, gradients summed) scales every gradient by the
world size, which Adam's first step (+-lr sign(g)) would hide.
"""

import multiprocessing.connection
import os
import tempfile
import time

import torch
import torch.distributed as dist

ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def world_size(group):
    """The ranks of `group`; 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """psum: the sum over the ranks, on every rank; its backward all-reduces
    the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def all_reduce_sum(x, group):
    """The sum of `x` over the ranks of `group`, differentiable (see the
    module docstring); `x` itself without a group or at one rank."""
    if world_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def broadcast_module(nets, group):
    """Every parameter and buffer of `nets` (a module or a dict of them) set
    to rank 0's: the replicas' common start."""
    if world_size(group) == 1:
        return
    modules = nets.values() if isinstance(nets, dict) else [nets]
    with torch.no_grad():
        for net in modules:
            for t in net.state_dict().values():
                dist.broadcast(t, 0, group=group)


def reduce_grads(params, group):
    """Average the gradients of `params` over the ranks of `group` in one
    flat all-reduce (the convention of the module docstring). Parameters
    without a gradient are left alone: every rank runs the same graph, so
    they are the same on every rank."""
    n = world_size(group)
    grads = [p.grad for p in params if p.grad is not None]
    if n == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= n
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _init(backend, init_method, rank, world, device):
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            device_id=device if backend == "nccl" else None)


def init_from_env(device_type="cuda"):
    """Join the group of a `torchrun` launch (`python -m
    torch.distributed.run`) from its environment: RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT. The rank is pinned to
    cuda:LOCAL_RANK (or the CPU); the backend is 'nccl' on cards, 'gloo' on
    the CPU. Returns (rank, world size, device)."""
    missing = [v for v in ENV_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(f"no torchrun environment: {', '.join(missing)} unset "
                           "(launch with python -m torch.distributed.run)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if local >= have:
            raise RuntimeError(f"local rank {local} needs cuda:{local}: this machine has "
                               f"{have} cards")
        device = torch.device("cuda", local)
    else:
        device = torch.device(device_type)
    address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    _init("nccl" if device.type == "cuda" else "gloo", address, rank, world, device)
    return rank, world, device


def _rank_main(fn, rank, world, backend, init_method, device, args, out):
    device = torch.device(device)
    _init(backend, init_method, rank, world, device)
    try:
        result = fn(rank, world, device, *args)
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


def spawn(fn, devices, backend, args=(), timeout=120.0):
    """Run ``fn(rank, world, device, *args)`` in one new process a device of
    `devices` (a list, repeats allowed), the processes joined into one
    group of `backend` (the default group: `torch.distributed.group.WORLD`)
    through a file store. `fn` and `args` are pickled: `fn` must be
    importable at module level.

    Waits at most `timeout` seconds (None: no limit) for all ranks: past
    it, or as soon as a rank fails, the other ranks are killed and this
    raises (TimeoutError or RuntimeError naming the rank and its exit
    code), so that a hung collective never hangs the caller. Returns the
    ranks' results in rank order."""
    ctx = torch.multiprocessing.get_context("spawn")
    world = len(devices)
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"result{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, f"file://{tmp}/store",
                                   str(devices[r]), args, outs[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        try:
            while True:
                failed = [(r, p.exitcode) for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0][0]} of {world} exited with code "
                                       f"{failed[0][1]}")
                alive = [p.sentinel for p in procs if p.exitcode is None]
                if not alive:
                    break
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
                multiprocessing.connection.wait(alive, timeout=left)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(o, weights_only=False) for o in outs]
