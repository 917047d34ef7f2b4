"""Driver of the alignment configurations: pairs of a seeded blocky scene
through the program's serving path (`pipeline/fused.fused_align_batch`), a
call of `pairs_per_call` pairs at a time, back to back in a closed loop,
each source made into its pyramid inside the call (K1) and the call's
outputs read back to the host.

The mix's parameters (`portbench/traffic/<mix>.json`): `pairs_per_call`,
`batch_mode`, `pool_calls` (distinct calls' inputs made at set-up and
cycled), `shifts_px` (the planted shifts of the target, drawn per pair and
axis), `judge_pairs` (pairs of the window judged against the reference)
and `warm_calls`. The judged pairs are drawn from a seeded reservoir of
4 * `judge_pairs` of the window's pairs, one a call.
"""

import numpy as np
import torch

from portbench import weights
from portbench.drivers.base import Session as Base
from portbench.judges import align as judge_align
from portbench.reference import nets

OUTPUT_KEYS = ("H21", "found", "num_inliers", "flow", "match", "flow_down8", "match_down8")


def pyramid_shapes(min_size, aspect, nb_scale, scale_r, stride=16):
    """(h, w) of each pyramid scale (the reference's scale list: scale_r
    down to 1 and on to 1/scale_r), each side floored to the stride."""
    if nb_scale == 1:
        scales = [1.0]
    else:
        scales = (np.linspace(scale_r, 1, nb_scale // 2 + 1).tolist()
                  + np.linspace(1, 1 / scale_r, nb_scale // 2 + 1).tolist()[1:])
    h0, w0 = aspect
    out = []
    for s in scales:
        f = int(min_size * s) / min(h0, w0)
        out.append((int(round(h0 * f)) // stride * stride, int(round(w0 * f)) // stride * stride))
    return out


def blocky_pairs(gen, n, target_hw, block, shifts_px):
    """n pairs: a random binary scene of `block`-pixel squares at the
    target's size, the source its 2x nearest upsample (so that the middle
    scale of the source's pyramid is the scene), the target the scene
    rolled by a shift drawn per pair and axis from `shifts_px`. Returns
    (sources (n, 2Ht, 2Wt, 3), targets (n, Ht, Wt, 3))."""
    ht, wt = target_hw
    dev = gen.device
    base = (torch.rand(n, ht // block, wt // block, 3, generator=gen, device=dev) > 0.5).float()
    base = base.repeat_interleave(block, 1).repeat_interleave(block, 2)
    src = base.repeat_interleave(2, 1).repeat_interleave(2, 2).contiguous()
    choice = torch.tensor(shifts_px, device=dev)
    shifts = choice[torch.randint(0, len(shifts_px), (n, 2), generator=gen, device=dev)].tolist()
    tgt = torch.stack([torch.roll(base[i], tuple(shifts[i]), (0, 1)) for i in range(n)])
    return src, tgt.contiguous()


class Session(Base):
    def __init__(self, cfg, mix, seed, device):
        super().__init__(cfg, mix, seed, device)
        self.units_per_call = int(mix["pairs_per_call"])
        c = cfg["settings"]
        self.shapes = pyramid_shapes(c["min_size"], tuple(c["target_hw"]), c["nb_scale"],
                                     c["scale_r"])
        self.target_hw = tuple(c["target_hw"])
        self.kept, self.seen = [], 0
        self.reservoir = 4 * int(mix["judge_pairs"])

    # ---------------------------------------------------------- set-up

    def make_weights(self):
        """(trunk params, {net: params}) from the seed and the committed
        fine-network file."""
        c = self.cfg["settings"]
        trunk = weights.seeded(nets.resnet50_layer3_spec(), self.generator("trunk"))
        fine = weights.from_npz(self.cfg["fine_weights_file"], self.device)
        want = nets.alignment_specs(c["kernel_size"])
        for name, spec in want.items():
            if set(fine[name]) != {k for k, _, _ in spec}:
                raise KeyError(f"{self.cfg['fine_weights_file']}: {name} holds other keys")
        return trunk, fine

    def make_inputs(self):
        mix, k = self.mix, self.units_per_call
        return blocky_pairs(self.generator("pairs"), k * int(mix["pool_calls"]),
                            self.target_hw, int(mix["block_px"]), mix["shifts_px"])

    def setup(self):
        from ransacflow_tpu_torch.models.feature_extractor import FeatureExtractor
        from ransacflow_tpu_torch.models.heads import Head
        from ransacflow_tpu_torch.models.resnet50 import ResNet50Layer3

        self.set_precision()
        c = self.cfg["settings"]
        trunk, fine = self.make_weights()
        kk = c["kernel_size"]
        self.resnet = weights.load_into(ResNet50Layer3().to(self.device), trunk)
        self.align = {"netFeatCoarse": weights.load_into(FeatureExtractor().to(self.device),
                                                         fine["netFeatCoarse"]),
                      "netFlowCoarse": weights.load_into(Head(kk, kk * kk).to(self.device),
                                                         fine["netFlowCoarse"]),
                      "netMatch": weights.load_into(Head(kk, 1).to(self.device),
                                                    fine["netMatch"])}
        del trunk, fine
        self.src, self.tgt = self.make_inputs()
        self.ransac_gen = self.generator("ransac")
        self.keep_rng = np.random.default_rng([self.seed, 1])
        for i in range(int(self.mix["warm_calls"])):
            self.call(i, keep=False)

    # ---------------------------------------------------------- the window

    def call(self, i, keep=True):
        from ransacflow_tpu_torch.pipeline.fused import device_pyramid, fused_align_batch

        c, k = self.cfg["settings"], self.units_per_call
        b = i % int(self.mix["pool_calls"])
        rows = slice(b * k, (b + 1) * k)
        pyramids = tuple(p[:, None] for p in device_pyramid(self.src[rows], self.shapes))
        out = fused_align_batch(self.resnet, self.align, pyramids, self.tgt[rows, None],
                                self.ransac_gen, tolerance=c["tolerance"],
                                n_iter=c["n_hypotheses"], kernel_size=c["kernel_size"],
                                cycle_match=c["cycle_match"],
                                batch_mode=self.mix["batch_mode"])
        # the read-back a dataset writer makes; the host copies are dropped
        host = {key: out[key].cpu().numpy() for key in OUTPUT_KEYS}
        if keep:
            self._sample(b * k, out)
        return host

    def _sample(self, row0, out):
        """Reservoir sampling, seeded, of one pair a call: a uniform sample
        of `reservoir` pairs of the window, their outputs kept as device
        copies (no host memory grows with the window's length)."""
        self.seen += 1
        slot = (len(self.kept) if len(self.kept) < self.reservoir
                else int(self.keep_rng.integers(self.seen)))
        if slot >= self.reservoir:
            return
        p = int(self.keep_rng.integers(self.units_per_call))
        item = (row0 + p, {key: out[key][p].clone() for key in OUTPUT_KEYS})
        if slot == len(self.kept):
            self.kept.append(item)
        else:
            self.kept[slot] = item

    def end_to_end(self, rec):
        lat = np.array(rec["ends"]) - np.array(rec["starts"])
        return {"align_pairs_per_s": rec["units"] / (rec["ends"][-1] - rec["t_first"]),
                "align_ms_p95": float(np.percentile(lat, 95) * 1e3),
                "setup_s": rec["setup_s"]}

    def context(self, rec):
        c = self.cfg["settings"]
        return {"kind": "align", "session": self, "shapes": self.shapes,
                "target_hw": self.target_hw, "n_hypotheses": c["n_hypotheses"],
                "kernel_size": c["kernel_size"], "pairs_per_call": self.units_per_call,
                "latencies_s": list(np.array(rec["ends"]) - np.array(rec["starts"]))}

    def free_program(self):
        del self.resnet, self.align
        super().free_program()

    # ---------------------------------------------------------- correctness

    def judge(self):
        rng = np.random.default_rng([self.seed, 2])
        n = min(int(self.mix["judge_pairs"]), len(self.kept))
        picks = sorted(rng.choice(len(self.kept), size=n, replace=False).tolist())
        sample = [(r, {key: v.cpu().numpy() for key, v in self.kept[j][1].items()})
                  for j in picks for r in [self.kept[j][0]]]
        trunk, fine = self.make_weights()
        return judge_align.judge(self.cfg, self.shapes, trunk, fine,
                                 [(self.src[r:r + 1], self.tgt[r:r + 1], out)
                                  for r, out in sample], self, self.generator("judge"))
