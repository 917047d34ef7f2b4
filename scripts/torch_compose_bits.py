#!/usr/bin/env python3
"""K8 (`ransacflow_tpu_torch.kernels.compose.compose_tail`) on the card, bit
for bit across two checkouts.

    cd <checkout> && python3 <this script> save OUT.npz
    python3 <this script> compare A.npz B.npz

`save` runs the kernel of the checkout it is started from (its
`ransacflow_tpu_torch`, built at first use) on inputs made from a seed with
numpy: the fine stage's 480x640 from 60x80 maps, 40x56 and 375x1242 grids,
two images and one, identity and warped grids, a residual of 0.04 and of
0.25, both cycle_match values, at out_hw None; and across resolutions (a
368x1232 grid at 375x1242). `compare` prints one JSON line (the cases, how
many are equal bit for bit, the names of the others) and exits 1 when any
output differs.
"""

import json
import os
import sys

import numpy as np

# (name, images, grid's (h, w), out_hw, residual)
CASES = (("480x640", 2, (480, 640), None, 0.04), ("40x56", 2, (40, 56), None, 0.04),
         ("375x1242", 1, (375, 1242), None, 0.04), ("far", 1, (480, 640), None, 0.25),
         ("cross", 1, (368, 1232), (375, 1242), 0.04))


def _grid(rng, b, h, w, warped):
    """(b, h, w, 2) sampling grids: the identity's linspace axes, or those
    moved by a projective map that reaches past the source."""
    xs, ys = np.linspace(-1, 1, w, dtype=np.float32), np.linspace(-1, 1, h, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, ys), -1)[None].repeat(b, 0)
    if not warped:
        return pts
    H = np.eye(3) + 0.05 * rng.randn(b, 3, 3)
    hom = np.concatenate([pts, np.ones_like(pts[..., :1])], -1) @ H.transpose(0, 2, 1)[:, None]
    return (hom[..., :2] / hom[..., 2:]).astype(np.float32)


def save(path):
    sys.path.insert(0, os.getcwd())
    import torch

    from ransacflow_tpu_torch.kernels.compose import compose_tail

    rng = np.random.RandomState(0)
    outs = {}
    for name, b, (h, w), out_hw, residual in CASES:
        h8, w8 = h // 8, w // 8
        maps = [(residual * rng.randn(b, h8, w8, 2)).astype(np.float32),
                rng.rand(b, h8, w8, 1).astype(np.float32),
                rng.rand(b, h8, w8, 1).astype(np.float32)]
        for warped in (False, True):
            args = [torch.from_numpy(a).cuda() for a in (*maps, _grid(rng, b, h, w, warped))]
            for cycle in (False, True):
                flow, match = compose_tail(*args, cycle, out_hw)
                key = f"{name}_{'warped' if warped else 'identity'}_cycle{int(cycle)}"
                outs[key + "_flow"] = flow.cpu().numpy()
                outs[key + "_match"] = match.cpu().numpy()
    np.savez(path, **outs)
    print(json.dumps({"saved": path, "outputs": len(outs),
                      "device": torch.cuda.get_device_name(0)}))


def compare(path_a, path_b):
    a, b = np.load(path_a), np.load(path_b)
    keys = sorted(set(a.files) | set(b.files))
    differ = [k for k in keys if k not in a.files or k not in b.files
              or a[k].shape != b[k].shape or not np.array_equal(a[k].view(np.uint32),
                                                                  b[k].view(np.uint32))]
    print(json.dumps({"outputs": len(keys), "bit_equal": len(keys) - len(differ),
                      "differ": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "save":
        save(sys.argv[2])
    elif len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    else:
        sys.exit(__doc__)
