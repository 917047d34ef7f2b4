"""The harnesses' CSV files, read with the standard library's `csv` module
in place of `pandas.read_csv` (the JAX harnesses' reader, which the port
does not need)."""

import csv

import numpy as np


def read_rows(path):
    """Every row of a CSV as a dict of strings, keyed by the header:
    `pandas.read_csv(path, dtype=str)` row by row (the corr harness)."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def read_hpatches(path):
    """The rows of an HPatches CSV (`hpatches_1_{scene}.csv`), each a dict:
    'obj', 'im1' and 'im2' as written, 'Him' and 'Wim' as ints, and 'H' the
    (3, 3) float64 homography from the nine columns after the fifth, in
    header order (`row.iloc[5:]` of the JAX harness)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        col = {name: i for i, name in enumerate(next(reader))}
        return [{"obj": rec[col["obj"]], "im1": rec[col["im1"]], "im2": rec[col["im2"]],
                 "Him": int(float(rec[col["Him"]])), "Wim": int(float(rec[col["Wim"]])),
                 "H": np.array([float(v) for v in rec[5:]]).reshape(3, 3)}
                for rec in reader if rec]
