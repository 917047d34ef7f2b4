"""Prediction artifact schema (a copy of `ransacflow_tpu/eval/artifacts.py`:
importing the JAX package imports JAX).

Each pair gets one ``pair_{id}.npz`` with named fields, the JAX package's
schema, so that either package's results pass reads the other's predict
output. Harnesses add their own arrays (KITTI's ``fine_flow_d2_down8``).
"""

import os

import numpy as np

FIELDS = ("coarse_h", "fine_flow_down8", "fine_match_down8", "bg_mask")


def save_pair(out_dir, pair_id, prediction, **extra):
    """Save a multi-homography prediction dict (+ extra arrays)."""
    os.makedirs(out_dir, exist_ok=True)
    payload = {k: prediction[k] for k in FIELDS}
    payload.update(extra)
    np.savez_compressed(os.path.join(out_dir, f"pair_{pair_id}.npz"), **payload)


def load_pair(out_dir, pair_id):
    """Load a pair artifact; returns a dict of arrays or None if missing."""
    path = os.path.join(out_dir, f"pair_{pair_id}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def check_complete(out_dir, pair_ids):
    """The pair ids without an artifact (the reference's check_file.py,
    evaluation/evalYFCC/check_file.py:27-74)."""
    return [p for p in pair_ids
            if not os.path.exists(os.path.join(out_dir, f"pair_{p}.npz"))]
