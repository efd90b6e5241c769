"""Dataset generation on the port against the JAX package and OpenCV, on
the CPU.

  * ``utils/png.py`` against ``cv2``: uint8 RGB, uint16 depth and uint16
    instance / class masks at odd widths, both ways (``cv2.imread`` of the
    port's file, the port's read of ``cv2.imwrite``'s file) bit for bit,
    with libpng made to write each of the five filter types; the numpy
    and the native reconstruction equal; refused inputs raise.
  * ``data_generation.renderer`` against JAX's ``MeshRenderer``: the
    analytic scene at 80 x 60 (``tri_chunk`` 256) and the room cut to 6
    objects at 96 x 54 (focal scaled from 600 at 1200 wide; ``ray_chunk``
    1024, so the ray tiling runs, ``tri_chunk`` 512, ``bary_eps`` 1e-5),
    three poses each. ``inst`` and ``cls`` equal except on at most
    TIE_SHARE of the pixels (ties on triangle edges); ``depth`` within
    rtol 1e-5 and ``rgb`` within 1 where ``inst`` agrees.
  * generation as a whole: ``scripts/generate_dataset.py``'s ``main`` and
    the port's into two directories, for the analytic scene and a 6-object
    room; both decoded with the port's codec agree by the renderer's tiers
    (depth within 1 mm, the mm rounding of depths within rtol 1e-5);
    ``traj_w_c.txt``, the GT submeshes and ``info_semantic.json`` equal.
    The port's Replica loader reads the JAX writer's files (libpng's
    filters) exactly as the JAX loader (through cv2) does, and reads back
    the port's own files equal to the rendered arrays.
  * the room pipeline end to end on the CPU (``--device cpu``, 11 frames
    so that frame 10 exports, 96 x 64, 6 objects, 2 iterations a frame,
    8 object slots): every metric finite, ``px_block_bg`` 1, and neither
    ``jax`` nor any ``vmap_tpu`` module imported (in a subprocess).
  * the entry points raise without CUDA unless asked for the CPU (the
    ScanNet layout without ``cv2`` is ``tests/test_torch_scannet.py``'s).
"""

import importlib.util
import json
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import torch

from vmap_tpu.data_generation import MeshRenderer as JRenderer
from vmap_tpu.data_generation import RenderSettings as JSettings
from vmap_tpu.data_generation.room import make_room_scene as j_room
from vmap_tpu.data_generation.room import room_trajectory
from vmap_tpu.data_generation.settings import orbit_trajectory
from vmap_tpu.data.replica import ReplicaDataset as JReplica
from vmap_tpu_torch import native
from vmap_tpu_torch.data.replica import ReplicaDataset as TReplica
from vmap_tpu_torch.data_generation import MeshRenderer as TRenderer
from vmap_tpu_torch.data_generation import RenderSettings as TSettings
from vmap_tpu_torch.data_generation.room import make_room_scene as t_room
from vmap_tpu_torch.generate_dataset import synthetic_scene_objects
from vmap_tpu_torch.utils import png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIE_SHARE = 2e-3     # pixels whose winner may differ: ties on triangle edges
DEPTH_RTOL = 1e-5
ROOM_W, ROOM_H = 96, 54
ROOM_F = 600.0 * ROOM_W / 1200


def _jax_generate_main():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_dataset", os.path.join(REPO, "scripts",
                                             "generate_dataset.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


# ------------------------------------------------------------------ PNG
def _images():
    rng = np.random.default_rng(7)
    H, W = 37, 53
    yy, xx = np.mgrid[0:H, 0:W]
    rgb = np.stack([(xx * 3 + yy * 2) % 256, (yy * 5 + xx) % 256,
                    (xx * yy // 4) % 256], -1).astype(np.uint8)
    rgb[9:12] = rng.integers(0, 256, (3, W, 3))
    depth = (800 + 37 * xx + 11 * yy + rng.integers(0, 3, (H, W))
             ).astype(np.uint16)
    inst = np.zeros((H, W), np.uint16)
    inst[5:20, 7:30], inst[22:35, 30:50], inst[:4] = 3, 41, 1000
    return {"rgb": rgb, "depth": depth, "inst": inst,
            "cls": (inst * 7 + 2).astype(np.uint16),
            "grey": rgb[..., 1].copy()}


def _cv2_bgr(img):
    return img[..., ::-1] if img.ndim == 3 else img


def _filtered_rows(buf: bytes) -> tuple:
    """A PNG's filtered rows [H, 1 + stride] and its bytes a pixel."""
    w, h, depth, color = struct.unpack(">IIBB", buf[16:26])
    bpp = png.CHANNELS[color] * depth // 8
    pos, idat = 8, []
    while pos < len(buf):
        (n,) = struct.unpack_from(">I", buf, pos)
        if buf[pos + 4:pos + 8] == b"IDAT":
            idat.append(buf[pos + 8:pos + 8 + n])
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return rows.reshape(h, 1 + w * bpp), bpp


def _filter_kinds(buf: bytes) -> set:
    return set(_filtered_rows(buf)[0][:, 0].tolist())


CV2_FILTERS = {"default": None, "none": cv2.IMWRITE_PNG_FILTER_NONE,
               "sub": cv2.IMWRITE_PNG_FILTER_SUB,
               "up": cv2.IMWRITE_PNG_FILTER_UP,
               "average": cv2.IMWRITE_PNG_FILTER_AVG,
               "paeth": cv2.IMWRITE_PNG_FILTER_PAETH}


@pytest.mark.parametrize("kind", ["rgb", "depth", "inst", "cls", "grey"])
def test_png_written_by_the_port_reads_in_cv2(kind, tmp_path):
    img = _images()[kind]
    path = str(tmp_path / f"{kind}.png")
    png.write_png(path, img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(_cv2_bgr(got), img)
    with open(path, "rb") as f:
        buf = f.read()
    assert _filter_kinds(buf) <= {png.NONE, png.SUB, png.UP}
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("kind", ["rgb", "depth", "inst", "cls", "grey"])
@pytest.mark.parametrize("filt", list(CV2_FILTERS))
def test_png_written_by_cv2_reads_in_the_port(kind, filt, tmp_path):
    """libpng made to write each filter type; ``default`` is what
    ``cv2.imwrite`` writes without parameters (the JAX writer's files)."""
    img = _images()[kind]
    path = str(tmp_path / f"{kind}_{filt}.png")
    params = [] if CV2_FILTERS[filt] is None else [
        cv2.IMWRITE_PNG_FILTER, CV2_FILTERS[filt]]
    assert cv2.imwrite(path, _cv2_bgr(img), params)
    with open(path, "rb") as f:
        kinds = _filter_kinds(f.read())
    if filt != "default":
        assert kinds == {list(CV2_FILTERS).index(filt) - 1}
    got = png.read_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


def _with_header(buf: bytes, **fields) -> bytes:
    w, h, depth, color, comp, filt, lace = struct.unpack(">IIBBBBB",
                                                          buf[16:29])
    vals = dict(depth=depth, color=color, lace=lace)
    vals.update(fields)
    body = struct.pack(">IIBBBBB", w, h, vals["depth"], vals["color"], comp,
                       filt, vals["lace"])
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    return buf[:16] + body + crc + buf[33:]


def test_png_refuses_what_it_cannot_read():
    buf = png.encode_png(_images()["grey"])
    for fields, msg in (({"lace": 1}, "interlaced"),
                        ({"color": 3}, "palette"),
                        ({"depth": 4}, "bit depth")):
        with pytest.raises(ValueError, match=msg):
            png.decode_png(_with_header(buf, **fields))
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(buf[:30] + bytes([buf[30] ^ 1]) + buf[31:])
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + buf[6:])
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((4, 5), np.float32))
    data = np.zeros((2, 1 + 6), np.uint8)
    data[1, 0] = 5
    with pytest.raises(ValueError, match="filter type 5"):
        native.png_unfilter(data, 3)


# ------------------------------------------------------------- renderer
def _tiers(got: dict, want: dict, what: str) -> float:
    """The renderer's tiers; returns the share of pixels whose winner
    differs."""
    agree = got["inst"] == want["inst"]
    share = 1.0 - float(agree.mean())
    assert share <= TIE_SHARE, (what, share)
    assert float((got["cls"] != want["cls"]).mean()) <= TIE_SHARE, what
    np.testing.assert_allclose(got["depth"][agree], want["depth"][agree],
                               rtol=DEPTH_RTOL, atol=0, err_msg=what)
    diff = np.abs(got["rgb"].astype(np.int32) - want["rgb"].astype(np.int32))
    assert int(diff[agree].max(initial=0)) <= 1, what
    for k in ("rgb", "depth", "inst", "cls"):
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
    return share


@pytest.fixture(scope="module")
def renders():
    """(name, port frames, JAX frames) for the analytic scene and the
    6-object room, three poses each."""
    out = []
    scene, objects = synthetic_scene_objects("Replica")
    kw = dict(width=80, height=60, fx=50.0, fy=50.0, tri_chunk=256)
    traj = orbit_trajectory(3, radius=scene.orbit_radius,
                            height=scene.orbit_height)
    t = TRenderer(objects, TSettings(**kw), device="cpu")
    j = JRenderer(objects, JSettings(**kw))
    out.append(("analytic", [t.render(p) for p in traj],
                [j.render(p) for p in traj]))
    kw = dict(width=ROOM_W, height=ROOM_H, fx=ROOM_F, fy=ROOM_F,
              tri_chunk=512, ray_chunk=1024, bary_eps=1e-5)
    t_objs, t_shell, meta = t_room(6, seed=0)
    j_objs, j_shell, _ = j_room(6, seed=0)
    traj = room_trajectory(3, size=meta["size"], seed=0)
    t = TRenderer(t_objs + t_shell, TSettings(**kw), device="cpu")
    j = JRenderer(j_objs + j_shell, JSettings(**kw))
    assert t.n_triangles > kw["tri_chunk"]      # more than one chunk
    out.append(("room", [t.render(p) for p in traj],
                [j.render(p) for p in traj]))
    return out


@pytest.mark.parametrize("case", [0, 1], ids=["analytic", "room"])
def test_renderer_matches_jax(renders, case):
    name, got, want = renders[case]
    for i, (g, w) in enumerate(zip(got, want)):
        _tiers(g, w, f"{name} pose {i}")
        assert (w["inst"] > 0).any()
    if name == "room":   # the shell is watertight: every ray hits
        assert all((g["depth"] > 0).all() for g in got)
        assert len({int(i) for g in got for i in np.unique(g["inst"])}) > 6


def test_renderer_streams_rays_in_tiles():
    """Ray tiles of 1024 (the last one shorter) and one tile of every ray
    give the same frame bit for bit; so do triangle chunks of 64 and 512
    (the earliest triangle wins a tie, whatever the chunking)."""
    objs, shell, meta = t_room(6, seed=1)
    pose = room_trajectory(2, size=meta["size"], seed=1)[1]
    frames = []
    for ray_chunk, tri_chunk in ((1024, 512), (0, 512), (1000, 64)):
        st = TSettings(width=70, height=40, fx=35.0, fy=35.0,
                       tri_chunk=tri_chunk, ray_chunk=ray_chunk,
                       bary_eps=1e-5)
        frames.append(TRenderer(objs + shell, st, device="cpu").render(pose))
    for f in frames[1:]:
        for k in f:
            np.testing.assert_array_equal(f[k], frames[0][k], err_msg=k)


# ----------------------------------------------------------- generation
GEN_CASES = {
    "analytic": ["--frames", "3"],
    "room": ["--scene", "room", "--objects", "6", "--frames", "3",
             "--width", str(ROOM_W), "--height", str(ROOM_H),
             "--fx", str(ROOM_F), "--fy", str(ROOM_F)],
}


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """{case: (port dir, JAX dir)}, each written by its package's main."""
    from vmap_tpu_torch.generate_dataset import main as t_main
    j_main = _jax_generate_main()
    out = {}
    for case, argv in GEN_CASES.items():
        root = tmp_path_factory.mktemp(f"gen_{case}")
        t_dir, j_dir = str(root / "port"), str(root / "jax")
        t_main([t_dir, *argv, "--device", "cpu"])
        j_main([j_dir, *argv])
        out[case] = (t_dir, j_dir)
    return out


def _files(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generation_matches_jax(generated, case):
    t_dir, j_dir = generated[case]
    assert _files(t_dir) == _files(j_dir)
    np.testing.assert_array_equal(
        np.loadtxt(os.path.join(t_dir, "traj_w_c.txt")),
        np.loadtxt(os.path.join(j_dir, "traj_w_c.txt")))
    for f in _files(os.path.join(t_dir, "habitat")):
        with open(os.path.join(t_dir, "habitat", f), "rb") as a, \
                open(os.path.join(j_dir, "habitat", f), "rb") as b:
            assert a.read() == b.read(), f
    n = len(np.loadtxt(os.path.join(t_dir, "traj_w_c.txt")))
    for i in range(n):
        frame = {}
        for root in (t_dir, j_dir):
            rd = lambda sub, name: png.read_png(    # noqa: E731
                os.path.join(root, sub, f"{name}_{i}.png"))
            frame[root] = {"rgb": rd("rgb", "rgb").transpose(1, 0, 2),
                           "depth": rd("depth", "depth").T,
                           "inst": rd("semantic_instance",
                                      "semantic_instance").T,
                           "cls": rd("semantic_class", "semantic_class").T}
        got, want = frame[t_dir], frame[j_dir]
        agree = got["inst"] == want["inst"]
        assert 1.0 - agree.mean() <= TIE_SHARE, (case, i)
        assert (got["cls"] != want["cls"]).mean() <= TIE_SHARE, (case, i)
        dd = np.abs(got["depth"].astype(np.int32)
                    - want["depth"].astype(np.int32))
        assert int(dd[agree].max()) <= 1, (case, i)     # mm rounding
        dc = np.abs(got["rgb"].astype(np.int32) - want["rgb"].astype(np.int32))
        assert int(dc[agree].max()) <= 1, (case, i)


def _replica_cfg(path: str):
    from vmap_tpu_torch.config import Config
    with open(os.path.join(REPO, "configs", "Replica",
                           "room0_vmap.json")) as f:
        raw = json.load(f)
    raw["dataset"]["path"] = path
    raw["camera"].update(w=ROOM_W, h=ROOM_H, fx=ROOM_F, fy=ROOM_F,
                         cx=(ROOM_W - 1) / 2, cy=(ROOM_H - 1) / 2)
    return raw, Config.from_dict(raw)


def test_port_loader_reads_the_jax_writers_files(generated):
    """The port's Replica loader (no cv2) on the files the JAX writer
    wrote through cv2 against the JAX loader (cv2) on the same files."""
    from vmap_tpu.config import Config as JConfig
    _, j_dir = generated["room"]
    raw, cfg = _replica_cfg(j_dir)
    t_ds, j_ds = TReplica(cfg), JReplica(JConfig.from_dict(raw))
    assert len(t_ds) == len(j_ds) == 3
    for i in range(3):
        a, b = t_ds[i], j_ds[i]
        for k in ("image", "depth", "obj", "T"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert sorted(a["bbox_dict"]) == sorted(b["bbox_dict"])
        for oid in a["bbox_dict"]:
            np.testing.assert_array_equal(a["bbox_dict"][oid],
                                          b["bbox_dict"][oid])


def test_port_loader_reads_back_the_rendered_frames(generated):
    """The port's own files through its loader: colour equal to the
    render, depth equal to the render's after the mm rounding."""
    t_dir, _ = generated["room"]
    raw, cfg = _replica_cfg(t_dir)
    objs, shell, meta = t_room(6, seed=0)
    from vmap_tpu_torch.generate_dataset import room_settings
    renderer = TRenderer(objs + shell,
                         room_settings(ROOM_W, ROOM_H, ROOM_F, ROOM_F),
                         device="cpu")
    pose = room_trajectory(3, size=meta["size"], seed=0)[2]
    want = renderer.render(pose)
    from vmap_tpu_torch.data.transforms import depth_filter, depth_scale
    got = TReplica(cfg)[2]
    np.testing.assert_array_equal(got["image"], want["rgb"])
    mm = np.clip(np.round(want["depth"] * 1000.0), 0, 65535).astype(np.uint16)
    np.testing.assert_array_equal(
        png.read_png(os.path.join(t_dir, "depth", "depth_2.png")), mm.T)
    np.testing.assert_array_equal(got["depth"], depth_filter(
        depth_scale(mm.astype(np.float32), cfg.depth_scale), cfg.max_depth))
    np.testing.assert_array_equal(got["T"], pose.astype(np.float32))


# ------------------------------------------------------- the pipeline
def test_room_pipeline_runs_on_the_cpu_without_jax(tmp_path):
    """Generate, train (frame 10 exports), evaluate, in a subprocess that
    imports neither jax nor vmap_tpu."""
    out = tmp_path / "summary.json"
    argv = ["--work", str(tmp_path / "work"), "--frames", "11",
            "--objects", "6", "--width", "96", "--height", "64",
            "--focal", "56", "--grid_dim", "24", "--device", "cpu",
            "--set", "render.iters_per_frame=2",
            "--set", "trainer.n_models=8", "--out", str(out)]
    code = (
        "import sys\n"
        "from vmap_tpu_torch import room_pipeline\n"
        f"room_pipeline.main({argv!r})\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'vmap_tpu')\n"
        "             or k.startswith(('jax.', 'jaxlib', 'flax',\n"
        "                              'vmap_tpu.')))\n"
        "assert not bad, bad\n"
        "print('JAXFREE')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "JAXFREE" in res.stdout
    summary = json.loads(out.read_text())
    assert summary["px_block_bg"] == 1 and summary["device"] == "cpu"
    assert summary["frames"] == 11 and summary["invalid_depth_share"] < 0.15
    assert set(summary["stage_s"]) == {"generate", "train", "export",
                                       "evaluate"}
    rows = [summary["object_mean"], summary["bg"], summary["scene"],
            *summary["per_object"].values()]
    assert len(summary["per_object"]) >= 2     # the background and objects
    for row in rows:
        assert set(row) == {"accuracy", "completion",
                            "completion_ratio_1cm", "completion_ratio_5cm"}
        assert all(np.isfinite(v) for v in row.values()), row
    meshes = os.listdir(tmp_path / "work" / "run_default" / "scene_mesh")
    assert "frame_10_obj0.obj" in meshes
    cfg = json.loads((tmp_path / "work" / "room_config_default.json")
                     .read_text())
    assert cfg["tpu"]["px_block_bg"] == 1


def test_room_config_keeps_an_explicit_px_block_bg(tmp_path):
    from vmap_tpu_torch import room_pipeline as rp
    for flag, want in (([], 1), (["--px_block_bg", "4"], 4)):
        args = rp.parse_args(["--work", str(tmp_path)] + flag)
        assert rp.room_config(args, str(tmp_path), 5)["tpu"][
            "px_block_bg"] == want


# ------------------------------------------------------- entry points
def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from vmap_tpu_torch import generate_dataset, room_pipeline
    _, objects = synthetic_scene_objects("Replica")
    with pytest.raises(RuntimeError, match="cuda"):
        TRenderer(objects)
    with pytest.raises(RuntimeError, match="cuda"):
        generate_dataset.main([str(tmp_path / "g"), "--frames", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        room_pipeline.main(["--work", str(tmp_path / "w"), "--frames", "1"])
    assert not os.path.exists(tmp_path / "g" / "rgb")
