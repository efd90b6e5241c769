"""``ops/rays.py`` and ``models/OccupancyField`` of the port against the
JAX package's on the CPU: ``tests/test_rays.py`` and
``tests/test_models.py`` mirrored, then the same parameters through both
(``interop.field_from_numpy``): forward, ``raw_alpha``, ``eval_points``
(the field query's plain version here, K2 on the card) and
``extract_mesh`` at ``tests/test_torch_meshing.py``'s tolerances
(occupancy atol 1e-5, colour 2e-5, vertices 1e-4, faces equal, vertex
colours within 1 level).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vmap_tpu.geometry.obb import OrientedBox as JBox
from vmap_tpu.models import OccupancyField as JField
from vmap_tpu.ops import rays as JR
from vmap_tpu_torch.geometry.obb import OrientedBox
from vmap_tpu_torch.interop import field_from_numpy
from vmap_tpu_torch.models import OccupancyField
from vmap_tpu_torch.ops import rays as R

from _torch_parity import both_native


# ----------------------------------------------------------------- rays
def test_ray_dirs_cache_center_pixel():
    dirs = R.ray_dirs_cache(8, 6, fx=2.0, fy=3.0, cx=4.0, cy=3.0).numpy()
    assert dirs.shape == (8, 6, 3)
    np.testing.assert_allclose(dirs[4, 3], [0, 0, 1])
    np.testing.assert_allclose(dirs[0, 0], [(0 - 4) / 2.0, (0 - 3) / 3.0, 1])
    np.testing.assert_allclose(dirs[7, 5], [(7 - 4) / 2.0, (5 - 3) / 3.0, 1])


def test_ray_dirs_cache_matches_jax():
    args = (37, 23, 30.5, 29.0, 18.2, 11.7)
    np.testing.assert_array_equal(R.ray_dirs_cache(*args).numpy(),
                                  np.asarray(JR.ray_dirs_cache(*args)))


def test_origin_dirs_w_identity():
    o, dw = R.origin_dirs_w(torch.eye(4)[None],
                            torch.tensor([[[0.1, 0.2, 1.0]]]))
    np.testing.assert_allclose(o.numpy(), [[0, 0, 0]])
    np.testing.assert_allclose(dw.numpy(), [[[0.1, 0.2, 1.0]]])


def test_origin_dirs_w_rotation_translation():
    th = np.pi / 2
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                 [0, 0, 1]]
    T[:3, 3] = [1, 2, 3]
    d = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]])
    o, dw = R.origin_dirs_w(torch.tensor(T)[None], d)
    np.testing.assert_allclose(o.numpy(), [[1, 2, 3]], atol=1e-6)
    np.testing.assert_allclose(dw[0, 0].numpy(), [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(dw[0, 1].numpy(), [0, 0, 1], atol=1e-6)


def test_origin_dirs_w_batched_matches_jax():
    rng = np.random.default_rng(0)
    T = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    T[:, :3, :] = rng.normal(size=(3, 3, 4))
    d = rng.normal(size=(3, 5, 3)).astype(np.float32)
    o, dw = R.origin_dirs_w(torch.tensor(T), torch.tensor(d))
    jo, jdw = JR.origin_dirs_w(jnp.asarray(T), jnp.asarray(d))
    assert o.shape == (3, 3) and dw.shape == (3, 5, 3)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-6,
                               atol=1e-6)


# -------------------------------------------------------- OccupancyField
def test_create_and_forward():
    f = OccupancyField.create(torch.Generator().manual_seed(0), hidden=16,
                              scale=2.0, device="cpu")
    occ, color = f(torch.zeros((5, 3)))
    assert occ.shape == (5,) and color.shape == (5, 3)
    assert ((occ >= 0) & (occ <= 1)).all()


def test_field_is_a_module_with_parameters():
    f = OccupancyField.create(hidden=16, device="cpu")
    names = {n for n, _ in f.named_parameters()}
    assert {"pe.dirs", "mlp.w_in", "mlp.b_alpha"} <= names
    f(torch.ones((4, 3)))[0].sum().backward()
    assert f.mlp["w_in"].grad.abs().sum() > 0
    opt = torch.optim.Adam(f.parameters(), lr=1e-3)
    before = f.mlp["w_in"].detach().clone()
    opt.step()
    assert not torch.equal(before, f.mlp["w_in"].detach())


def test_create_runs_on_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="refusing"):
        OccupancyField.create(hidden=16)


@pytest.fixture(scope="module")
def pair():
    """A JAX field with a dense alpha head and the port's with the same
    parameters, at h=32 (the object width)."""
    jf = JField.create(jax.random.PRNGKey(1), hidden=32, scale=2.0)
    mlp = dict(jf.mlp)
    mlp["b_alpha"] = jnp.ones_like(mlp["b_alpha"]) * 0.0
    jf = jf.replace(mlp=mlp)
    tf = field_from_numpy({k: np.asarray(v) for k, v in jf.pe.items()},
                          {k: np.asarray(v) for k, v in jf.mlp.items()},
                          float(jf.scale), jf.hidden, jf.max_deg)
    return jf, tf


def test_forward_and_raw_alpha_match_jax(pair):
    jf, tf = pair
    pts = np.random.default_rng(2).normal(size=(200, 3)).astype(np.float32)
    occ, col = tf(torch.tensor(pts))
    jocc, jcol = jf(jnp.asarray(pts))
    np.testing.assert_allclose(occ.detach().numpy(), np.asarray(jocc),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(col.detach().numpy(), np.asarray(jcol),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(tf.raw_alpha(torch.tensor(pts)).detach()
                               .numpy(), np.asarray(jf.raw_alpha(
                                   jnp.asarray(pts))), rtol=1e-5, atol=1e-4)


def test_eval_points_matches_jax(pair):
    jf, tf = pair
    pts = np.random.default_rng(3).normal(size=(300, 3)).astype(np.float32)
    occ, col = tf.eval_points(pts, chunk=128)
    jocc, jcol = jf.eval_points(pts, chunk=128)
    assert occ.shape == (300,) and col.shape == (300, 3)
    np.testing.assert_allclose(occ, jocc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(col, jcol, rtol=0, atol=2e-5)


def test_extract_mesh_matches_jax(pair):
    jf, tf = pair
    assert both_native()
    args = ([0.1, -0.2, 0.05], np.eye(3), [1.0, 1.2, 0.8])
    want = jf.extract_mesh(JBox(*args), grid_dim=24)
    got = tf.extract_mesh(OrientedBox(*args), grid_dim=24)
    assert want is not None and len(want.faces) > 0
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(got.faces, want.faces)
    np.testing.assert_allclose(got.vertex_colors.astype(np.int32),
                               want.vertex_colors.astype(np.int32), atol=1)
