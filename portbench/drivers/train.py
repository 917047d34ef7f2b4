"""Driver of the training configurations: the program's training step
(`train/trainer.train_step`) back to back on batches of related pairs made
on the device from the seed, a pool of distinct batches cycled, the window
synchronized once at its end.

Set-up builds the networks and Adam once, and drives that same object
through the first `checked_steps` steps by the window's own call on the
pool's first batches (all distinct), reading their losses, Adam's first
moments after the first step and the weights after the last; the window
goes on from there. The mix's parameters
(`portbench/traffic/<mix>.json`): `pairs_per_step`, `pool_steps`,
`block_px`, `shifts_px`, `checked_steps`.
"""

import torch

from portbench import weights
from portbench.drivers.base import Session as Base
from portbench.judges import train as judge_train
from portbench.reference import nets
from portbench.reference.train import NETS


def related_batches(gen, n_batches, pairs, size, block, shifts_px):
    """n_batches batches of 2 * pairs images (I1 then I2): I1 a random
    binary scene of `block`-pixel squares, I2 the same rolled by a shift
    drawn per pair and axis from `shifts_px`."""
    dev = gen.device
    n = n_batches * pairs
    base = (torch.rand(n, size // block, size // block, 3, generator=gen, device=dev) > 0.5)
    base = base.float().repeat_interleave(block, 1).repeat_interleave(block, 2)
    choice = torch.tensor(shifts_px, device=dev)
    shifts = choice[torch.randint(0, len(shifts_px), (n, 2), generator=gen, device=dev)].tolist()
    rolled = torch.stack([torch.roll(base[i], tuple(shifts[i]), (0, 1)) for i in range(n)])
    return [torch.cat([base[b * pairs:(b + 1) * pairs], rolled[b * pairs:(b + 1) * pairs]])
            .contiguous() for b in range(n_batches)]


class Session(Base):
    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        self.units_per_call = int(mix["pairs_per_step"])
        self.steps_done = 0

    def make_weights(self):
        s = self.cfg["settings"]
        specs = nets.alignment_specs(s["kernel_size"])
        gen = self.generator("weights")
        return {n: weights.seeded(specs[n], gen,
                                  overrides={"conv4.weight": s["match_conv4_std"]}
                                  if n == "netMatch" else None)
                for n in NETS}

    def make_batches(self):
        s, mix = self.cfg["settings"], self.mix
        return related_batches(self.generator("batches"), int(mix["pool_steps"]),
                               self.units_per_call, s["img_size"], int(mix["block_px"]),
                               mix["shifts_px"])

    def setup(self):
        from ransacflow_tpu_torch.models.feature_extractor import FeatureExtractor
        from ransacflow_tpu_torch.models.heads import Head
        from ransacflow_tpu_torch.train.losses import margin_mask
        from ransacflow_tpu_torch.train.trainer import (
            local_index_roll,
            make_optimizer,
            split_trainable,
        )
        from ransacflow_tpu_torch.ops.grid import normalized_grid

        self.set_precision()
        s = self.cfg["settings"]
        k = s["kernel_size"]
        params = self.make_weights()
        mods = {"netFeatCoarse": FeatureExtractor(), "netFlowCoarse": Head(k, k * k),
                "netMatch": Head(k, 1)}
        self.nets = {n: weights.load_into(m.to(self.device), params[n])
                     for n, m in mods.items()}
        del params
        self.opt = make_optimizer(split_trainable(self.nets, s["mode"])[0], lr=s["lr"])
        b, size = self.units_per_call, s["img_size"]
        self.feed = (local_index_roll(b, self.device),
                     normalized_grid(size, size, self.device)[None],
                     margin_mask(2 * b, size, s["margin"], self.device))
        self.batches = self.make_batches()
        self.kwargs = {key: s[key] for key in ("mode", "mu_cycle", "lambda_match",
                                               "grad_weight", "kernel_size")}
        start = {key: p.detach().clone() for key, p in self.named_leaves()}
        self.checked = {"losses": []}
        for step in range(int(self.mix["checked_steps"])):
            metrics = self.call(step)
            self.checked["losses"].append(float(metrics["loss"]))
            if step == 0:
                beta1 = self.opt.param_groups[0]["betas"][0]
                # what the optimizer got: its first moment after one step
                # (none where it never stepped)
                self.checked["first_grads"] = {
                    key: (self.opt.state[p]["exp_avg"] / (1 - beta1)).clone()
                    if "exp_avg" in self.opt.state[p] else torch.zeros_like(p)
                    for key, p in self.named_leaves()}
        self.checked["changes"] = {key: p.detach() - start[key]
                                   for key, p in self.named_leaves()}
        self._sync()

    def named_leaves(self):
        for n in NETS:
            for key, p in self.nets[n].named_parameters():
                yield (n, key), p

    def call(self, i):
        from ransacflow_tpu_torch.train.trainer import train_step

        batch = self.batches[self.steps_done % len(self.batches)]
        self.steps_done += 1
        return train_step(self.nets, self.opt, batch, *self.feed, **self.kwargs)

    def end_to_end(self, rec):
        return {"train_pairs_per_s": rec["units"] / rec["window_s"], "setup_s": rec["setup_s"]}

    def context(self, rec):
        s = self.cfg["settings"]
        return {"kind": "train", "session": self, "pairs_per_step": self.units_per_call,
                "img_size": s["img_size"], "kernel_size": s["kernel_size"]}

    def free_program(self):
        del self.nets, self.opt
        super().free_program()

    def judge(self):
        n = int(self.mix["checked_steps"])
        return judge_train.judge(self.cfg, self.make_weights(), self.batches[:n], self.checked)
