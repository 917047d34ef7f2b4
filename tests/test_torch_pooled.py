"""The eval pool of the port (`ransacflow_tpu_torch/eval/pooled.py`, the
pooled YFCC and KITTI passes) on the CPU, mirroring tests/test_parallel.py's
pool tests and tests/test_eval.py::test_kitti_pooled_matches_sequential.

A pool of n slots on the one CPU device exercises the round robin, the
shape buckets and the bounded drain without a second device. Each pair
draws from `CoarseAligner.reseed(idx)`'s generator, so the artifacts of
every pool size, batched or not, must equal the sequential device loop's
bit for bit (tolerance 0). Also: `pool_devices` raising on a count the
machine lacks, the drain's bound, and `kernels/build`'s first build and
launch counts under threads (the KITTI pool's workers launch kernels).
"""

import ctypes
import os
import pickle
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from ransacflow_tpu_torch.eval import artifacts, corr, hpatches, kitti, pooled, yfcc
from ransacflow_tpu_torch.kernels import build
from ransacflow_tpu_torch.models import convert
from ransacflow_tpu_torch.pipeline import CoarseAligner
from ransacflow_tpu_torch.pipeline.multihomo import multi_homography_predict_fused
from test_torch_eval import (
    H_IMG,
    _fg_border_mask,
    _translation_pair,
    _write_corr_dataset,
    _write_hpatches_dataset,
)

COARSE_KW = dict(nb_scale=1, n_iter=512)
POOLS = (1, 2, 3)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def nets():
    return (convert.init_resnet50_layer3(torch.Generator().manual_seed(0), "cpu"),
            convert.init_alignment_params(torch.Generator().manual_seed(1), "cpu"))


def _blocky(rng, h, w):
    base = (rng.rand(h // 4, w // 4, 3) > 0.5).astype(np.float32)
    img = np.kron(base, np.ones((4, 4, 1), np.float32))[:h, :w]
    return Image.fromarray((img * 255).astype(np.uint8))


def _pool_run(nets, pil_pairs, devices, min_size, batch_pairs=None):
    arts = {}
    pooled.pooled_multihomo_predict(
        ((i, s, t, None) for i, (s, t) in enumerate(pil_pairs)), *nets, devices,
        dict(COARSE_KW, min_size=min_size),
        save_fn=lambda idx, art: arts.__setitem__(idx, art), max_coarse=2,
        batch_pairs=batch_pairs)
    return arts


def _sequential(nets, pil_pairs, min_size):
    """The device-resident loop, one pair after another on one aligner, each
    on its own draws: the `--nDevices 1` path before the pool."""
    coarse = CoarseAligner(nets[0], "cpu", min_size=min_size, **COARSE_KW)
    arts = {}
    for i, (s, t) in enumerate(pil_pairs):
        coarse.set_pair(s, t)
        coarse.reseed(i)
        art = multi_homography_predict_fused(coarse, nets[1], max_coarse=2)
        if art is not None:
            arts[i] = art
    return arts


def _equal(ref, got):
    assert set(ref) == set(got)
    for idx in ref:
        assert set(ref[idx]) == set(got[idx])
        for key in ref[idx]:
            np.testing.assert_array_equal(ref[idx][key], got[idx][key],
                                          err_msg=f"pair {idx} {key}")


def test_pooled_eval_identical_across_pool_sizes(rng, nets):
    """Pools of 1, 2 and 3 slots write the sequential device loop's
    artifacts bit for bit."""
    pil_pairs = [(_blocky(rng, 128, 128), _blocky(rng, 128, 128)) for _ in range(4)]
    seq = _sequential(nets, pil_pairs, 128)
    assert len(seq) == 4
    for n in POOLS:
        _equal(seq, _pool_run(nets, pil_pairs, ["cpu"] * n, 128))


def test_pooled_batched_dispatch_bit_identical(rng, nets):
    """Same-shape pairs in batches of 2 and 3 over pools of 1, 2 and 3
    slots: the per-pair artifacts bit for bit. With one slot, every entry of
    a batch was added while that slot already held the next pair: the
    entries keep what the slot held at `add`."""
    pil_pairs = [(_blocky(rng, 128, 128), _blocky(rng, 128, 128)) for _ in range(4)]
    per_pair = _pool_run(nets, pil_pairs, ["cpu"], 128)
    for n, batch in ((1, 2), (1, 3), (2, 2), (3, 2)):
        _equal(per_pair, _pool_run(nets, pil_pairs, ["cpu"] * n, 128, batch_pairs=batch))


def test_pooled_batched_dispatch_mixed_shapes(rng, nets):
    """Mixed resized shapes land in separate buckets; a leftover single pair
    takes the per-pair loop at flush. The artifacts stay bit for bit."""
    pil_pairs = [(_blocky(rng, 96, 96), _blocky(rng, 96, 96)),
                 (_blocky(rng, 96, 96), _blocky(rng, 96, 96)),
                 (_blocky(rng, 96, 128), _blocky(rng, 96, 128))]
    per_pair = _pool_run(nets, pil_pairs, ["cpu"], 96)
    for n in (1, 2):
        _equal(per_pair, _pool_run(nets, pil_pairs, ["cpu"] * n, 96, batch_pairs=2))


def test_pooled_hpatches_and_corr_identical_across_pools(tmp_path, rng, nets):
    """The HPatches and corr predict passes with n_devices=1 and with pools of
    2 and 3 slots, batched and not: the same artifacts bit for bit."""
    csv_dir, image_dir = _write_hpatches_dataset(tmp_path / "hp", rng)
    csv_path, corr_dir = _write_corr_dataset(tmp_path / "corr", rng, n_rows=2)
    kw = dict(min_size=H_IMG, nb_scale=1, n_iter=512, max_coarse=1)

    def run(tag, **pool):
        hpatches.predict_hpatches(csv_dir, image_dir, str(tmp_path / f"hp_{tag}"), *nets,
                                  "cpu", scenes=(2,), bg_mask_fn=lambda p, hw: None,
                                  **kw, **pool)
        corr.predict_corr(csv_path, corr_dir, str(tmp_path / f"corr_{tag}"), *nets, "cpu",
                          **kw, **pool)
        return ({0: artifacts.load_pair(str(tmp_path / f"hp_{tag}" / "2"), 0)},
                {i: artifacts.load_pair(str(tmp_path / f"corr_{tag}"), i) for i in (0, 1)})

    ref = run("one", n_devices=1)
    assert all(a is not None for arts in ref for a in arts.values())
    for n in (2, 3):
        for batch in (None, 2):
            for want, got in zip(ref, run(f"{n}_{batch}", n_devices=["cpu"] * n,
                                          batch_pairs=batch)):
                _equal(want, got)


def _yfcc_scene(tmp_path, rng, n_pairs=3, hw=96):
    img_dir = tmp_path / "scene"
    img_dir.mkdir()
    names = []
    for i in range(2 * n_pairs):
        name = f"im{i}.png"
        _blocky(rng, hw, hw).save(img_dir / name)
        names.append(name)
    (img_dir / "images.txt").write_text("\n".join(names) + "\n")
    pkl = tmp_path / "pairs.pkl"
    with open(pkl, "wb") as f:
        pickle.dump([[2 * i, 2 * i + 1] for i in range(n_pairs)], f)
    return str(pkl), str(img_dir)


def test_pooled_yfcc_identical_across_pool_sizes(tmp_path, rng, nets):
    """Full YFCC prediction (the four-rotation pre-test and the loop) over
    pools of 1, 2 and 3 slots, batched and not, against the n_devices=1
    pass: the same artifacts bit for bit, the stored rotation included."""
    pkl, img_dir = _yfcc_scene(tmp_path, rng)
    coarse_kw = dict(COARSE_KW, min_size=96, rematch_per_call=True)

    def run(tag, devices, batch_pairs=None):
        out = tmp_path / f"pred_{tag}"
        yfcc.pooled_yfcc_predict(pkl, img_dir, str(out), *nets, devices, coarse_kw,
                                 max_coarse=1, end_index=3, batch_pairs=batch_pairs)
        return {i: artifacts.load_pair(str(out), i) for i in range(3)}

    yfcc.predict_yfcc(pkl, img_dir, str(tmp_path / "seq"), *nets, "cpu", min_size=96,
                      max_coarse=1, end_index=3, n_devices=1, **COARSE_KW)
    seq = {i: artifacts.load_pair(str(tmp_path / "seq"), i) for i in range(3)}
    assert all(a is not None and "rotation" in a for a in seq.values())
    for n in POOLS:
        _equal(seq, run(f"p{n}", ["cpu"] * n))
        _equal(seq, run(f"b{n}", ["cpu"] * n, batch_pairs=2))


def test_kitti_pooled_matches_sequential(tmp_path, rng, nets):
    """`pooled_kitti_predict` (a worker thread a slot, the pairs striped)
    writes `predict_kitti`'s artifacts bit for bit with pools of 1, 2 and 3
    slots: each pair draws from its own index's generator."""
    img_dir = tmp_path / "image_2"
    os.makedirs(img_dir)
    for i in range(3):
        src, tgt = _translation_pair(rng)
        src.save(img_dir / f"{i:06}_11.png")
        tgt.save(img_dir / f"{i:06}_10.png")
    kw = dict(coarse_size=H_IMG, fine_size=128, nb_scale=1, n_iter=512, end_index=3,
              max_coarse=0, bg_mask_fn=lambda path, hw: _fg_border_mask(*hw))
    kitti.predict_kitti(str(img_dir), str(tmp_path / "seq"), *nets, "cpu", **kw)
    seq = {i: artifacts.load_pair(str(tmp_path / "seq"), i) for i in range(3)}
    assert all(a is not None for a in seq.values())
    for n in POOLS:
        out = str(tmp_path / f"pool{n}")
        kitti.pooled_kitti_predict(str(img_dir), out, *nets, ["cpu"] * n, **kw)
        _equal(seq, {i: artifacts.load_pair(out, i) for i in range(3)})


def test_pool_devices():
    """A count maps to the first devices of the type and raises, naming the
    count, where the machine has fewer (the CPU is one device); a list is
    the pool itself, repeats allowed."""
    assert pooled.pool_devices(1, "cpu") == [torch.device("cpu")]
    assert pooled.pool_devices(["cpu"] * 3, "cuda") == [torch.device("cpu")] * 3
    with pytest.raises(RuntimeError, match="a pool of 2 cpu devices: this machine has 1"):
        pooled.pool_devices(2, "cpu")
    with pytest.raises(RuntimeError, match="a pool of 0 cpu devices"):
        pooled.pool_devices(0, "cpu")
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"a pool of {have + 1} cuda devices: "
                                           f"this machine has {have}.*item 12b"):
        pooled.pool_devices(have + 1, "cuda")


def test_pending_drain_keeps_its_bound():
    """At most 2 x slots pairs wait; each drains in order, a pair without a
    homography (count 0) saves nothing, a batch counts its pairs."""
    saved = []
    drain = pooled.PendingDrain(1, lambda idx, art, *extra: saved.append((idx, extra)))

    def final(count, batch=None):
        shape = () if batch is None else (batch,)
        return {"count": torch.full(shape, count, dtype=torch.int32),
                "hs": torch.zeros(shape + (2, 3, 3)), "flows": torch.zeros(shape + (2, 1, 1, 2)),
                "matches": torch.zeros(shape + (2, 1, 1, 2))}

    bg = np.ones((2, 2), np.float32)
    drain.add(0, final(1), bg, "a")
    drain.add(1, final(0), bg, "b")
    assert saved == []
    drain.add(2, final(2), bg, "c")
    assert saved == [(0, ("a",))]
    drain.add_batch([3, 4], final(1, batch=2), [bg, bg], [("d",), ("e",)])
    assert [s[0] for s in saved] == [0, 2]  # pair 1 drained with nothing to save
    drain.flush()
    assert saved == [(0, ("a",)), (2, ("c",)), (3, ("d",)), (4, ("e",))]


class _FakeProc:
    def __init__(self, argv, **kwargs):
        self.argv, self.returncode = argv, 0

    def communicate(self):
        threading.Event().wait(0.01)  # a compile that takes a while
        return "", ""


class _FakeLib:
    def __init__(self, path):
        self.path = path
        self.rf_error_string = lambda err: b""
        self.rf_fake = _FakeFn()


class _FakeFn:
    argtypes = restype = None

    def __call__(self, *args):
        return 0


def test_build_and_launch_counts_under_threads(tmp_path, monkeypatch):
    """Eight threads ask for the library at once: nvcc runs once per source
    and the library loads once; then they launch one kernel 2,000 times each
    with a shortened switch interval, and the count is exact."""
    procs, links, loads = [], [], []

    def popen(argv, **kwargs):
        procs.append(argv[-1])
        return _FakeProc(argv)

    def run(argv, **kwargs):
        links.append(argv)
        open(argv[argv.index("-o") + 1], "wb").close()
        return _FakeProc(argv)

    def cdll(path):
        loads.append(path)
        return _FakeLib(path)

    monkeypatch.setattr(build, "_library", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", popen)
    monkeypatch.setattr(build.subprocess, "run", run)
    monkeypatch.setattr(build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    n_sources = len(list(build._CSRC.glob("*.cu")))

    barrier = threading.Barrier(8)
    libs = []

    def get():
        barrier.wait(timeout=30)
        libs.append(build.library())

    threads = [threading.Thread(target=get) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(procs) == n_sources and len(set(procs)) == n_sources
    assert len(links) == 1 and len(loads) == 1
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)

    kernel = build.Kernel("rf_fake", [ctypes.c_void_p])
    dev = torch.device("cuda", 0)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernel(dev, 0) for _ in range(2000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert kernel.launches == 8 * 2000
