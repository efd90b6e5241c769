"""The ScanNet layout without OpenCV: the port's writer, loader and trainer
run with ``cv2`` hidden (``sys.modules["cv2"] = None``), and agree with the
JAX package's, which reads and writes through ``cv2``:

  * the port's files (``generate_dataset --format ScanNet``) through the
    JAX loader and through the port's loader give equal samples, the
    invalid-pose frame skipped by both;
  * the JAX writer's files through both loaders, likewise;
  * colour at another size than the depth (ScanNet's 1296 x 968 against
    640 x 480, here at the same ratio) is resized alike;
  * ``python -m vmap_tpu_torch.train --device cpu`` trains on a tiny
    generated ScanNet layout;
  * the undistorter and the association's erosion run.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from vmap_tpu.config import Config as JConfig
from vmap_tpu.data.scannet import ScanNetDataset as JScanNet
from vmap_tpu_torch.config import Config as TConfig
from vmap_tpu_torch.data.scannet import ScanNetDataset as TScanNet
from vmap_tpu_torch.utils.image import resize_linear
from vmap_tpu_torch.utils.jpeg import read_jpeg, write_jpeg

import _torch_parity  # noqa: F401  (one torch thread: the generator's)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, F = 256, 192, 160.0
GEN = ["--format", "ScanNet", "--frames", "3", "--invalid_pose_frames", "1",
       "--width", str(W), "--height", str(H), "--fx", str(F), "--fy", str(F)]


def _jax_generate_main():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_dataset", os.path.join(REPO, "scripts",
                                             "generate_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """{"port": dir, "jax": dir, "wide": dir}: the two packages' generated
    layouts, and the port's with its colour rewritten at 2.025 x 2.0167
    the depth's size (ScanNet's colour / depth ratio)."""
    import shutil
    from vmap_tpu_torch.generate_dataset import main as t_main
    root = tmp_path_factory.mktemp("scannet")
    out = {k: str(root / k) for k in ("port", "jax", "wide")}
    t_main([out["port"], *GEN, "--device", "cpu"])
    _jax_generate_main()([out["jax"], *GEN])
    shutil.copytree(out["port"], out["wide"])
    for name in os.listdir(os.path.join(out["wide"], "color")):
        path = os.path.join(out["wide"], "color", name)
        write_jpeg(path, resize_linear(read_jpeg(path), 518, 387))
    return out


def _raw(path: str) -> dict:
    with open(os.path.join(REPO, "configs", "ScanNet",
                           "scene0000_vmap.json")) as f:
        raw = json.load(f)
    raw["dataset"]["path"] = path
    raw["camera"].update(w=W, h=H, mw=4, mh=4)
    return raw


def _no_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)


def _equal_samples(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for k in ("image", "depth", "obj", "T"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["frame_id"] == b["frame_id"]
    assert sorted(a["bbox_dict"]) == sorted(b["bbox_dict"])
    for oid in a["bbox_dict"]:
        np.testing.assert_array_equal(a["bbox_dict"][oid],
                                      b["bbox_dict"][oid])


@pytest.mark.parametrize("which", ["port", "jax", "wide"])
def test_port_loader_matches_the_jax_loader(layouts, which, monkeypatch):
    raw = _raw(layouts[which])
    j_ds = JScanNet(JConfig.from_dict(raw))
    want = [j_ds[i] for i in range(len(j_ds))]
    _no_cv2(monkeypatch)
    t_ds = TScanNet(TConfig.from_dict(raw))
    got = [t_ds[i] for i in range(len(t_ds))]
    assert len(got) == len(want) == 3
    assert got[1] is None                  # the invalid pose
    assert any(len(s["bbox_dict"]) > 1 for s in got if s is not None)
    for a, b in zip(got, want):
        _equal_samples(a, b)
    if which == "wide":
        assert read_jpeg(t_ds.color_paths[0]).shape == (387, 518, 3)


def test_writer_runs_without_cv2_and_cv2_reads_it(tmp_path, monkeypatch):
    import cv2
    from vmap_tpu_torch.data_generation import write_scannet_sequence
    rng = np.random.default_rng(0)
    frame = {"rgb": rng.integers(0, 256, (33, 21, 3)).astype(np.uint8),
             "depth": rng.uniform(0.5, 3.0, (33, 21)).astype(np.float32),
             "inst": rng.integers(0, 4, (33, 21)).astype(np.int32),
             "cls": rng.integers(0, 9, (33, 21)).astype(np.int32)}
    with monkeypatch.context() as m:
        _no_cv2(m)
        write_scannet_sequence(str(tmp_path), [frame], np.eye(4)[None],
                               intrinsics=(30.0, 30.0, 16.0, 10.0))
    rgb = cv2.imread(str(tmp_path / "color" / "0.jpg"), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(rgb[..., ::-1],
                                  read_jpeg(str(tmp_path / "color" / "0.jpg")))
    inst = cv2.imread(str(tmp_path / "instance-filt" / "0.png"),
                      cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(inst, frame["inst"].T.astype(np.uint16))


def test_undistorter_and_erosion_run_without_cv2(monkeypatch):
    from vmap_tpu_torch.data.association import _erode
    from vmap_tpu_torch.data.transforms import make_undistorter
    _no_cv2(monkeypatch)
    und = make_undistorter(40, 30, 35.0, 35.0, 19.5, 14.5,
                           [0.1, -0.2, 0.0, 0.0, 0.05])
    img = np.full((30, 40, 3), 200, np.uint8)
    out = und(img)
    assert out.shape == img.shape and out[15, 20].tolist() == [200] * 3
    mask = np.zeros((30, 40), bool)
    mask[5:25, 5:35] = True
    assert _erode(mask).sum() == (20 - 12) * (30 - 12)


def test_train_cli_runs_on_a_scannet_layout_without_cv2(layouts, tmp_path,
                                                        monkeypatch):
    from vmap_tpu_torch import train
    raw = _raw(layouts["port"])
    raw["model"].update(hidden_feature_size=8, hidden_feature_size_bg=16)
    raw["render"].update(iters_per_frame=2, n_per_optim=24,
                         n_per_optim_bg=48)
    raw["vis"].update(grid_dim=24, live_voxel_size=0.05)
    raw["tpu"]["frame_pool_size"] = 16
    cfg = tmp_path / "scannet.json"
    cfg.write_text(json.dumps(raw))
    _no_cv2(monkeypatch)
    mapper = train.main(["--config", str(cfg), "--logdir",
                         str(tmp_path / "logs"), "--device", "cpu"])
    lines = [json.loads(x) for x in
             (tmp_path / "logs" / "train_log.jsonl").read_text().split("\n")
             if x]
    assert [x["frame"] for x in lines] == [0, 2]   # frame 1 skipped
    assert all(np.isfinite(x["loss"]) for x in lines)
    assert mapper.n_objects >= 1 and mapper.frames_ingested == 2
