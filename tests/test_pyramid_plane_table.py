"""Plane-table parity: ops.pyramid.build_pyramid against the NumPy oracle
(tests/reference_impl.build_pyramid_np) at the image sizes the tracker
meets: small test frames with holes, heights with no power-of-two factor,
and the 640x480 sensor mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from realsensetracker_tpu.data import synthetic
from realsensetracker_tpu.geometry import camera
from realsensetracker_tpu.ops import plane_kernel, pyramid
from tests import reference_impl as ref

# (name, intrinsics, scene seed, punch holes)
CASES = {
    "128x64_holes": (camera.Intrinsics(fx=100.0, fy=100.0, cx=63.5, cy=31.5,
                                       width=128, height=64), 3, True),
    "128x36": (camera.Intrinsics(fx=50.0, fy=50.0, cx=63.5, cy=17.5,
                                 width=128, height=36), 4, False),
    "64x482": (camera.Intrinsics(fx=60.0, fy=60.0, cx=31.5, cy=240.5,
                                 width=64, height=482), 5, False),
    "640x480": (camera.TUM_FR1, 3, True),
}
LEVELS = 3


def _depth(name):
    intr, seed, holes = CASES[name]
    d = synthetic.render_depth(intr, jnp.eye(4, dtype=jnp.float32),
                               synthetic.default_scene(seed=seed))
    if holes:
        d = d.at[10:14, 20:30].set(0.0)
    return intr, np.asarray(d, np.float32)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    intr, d = _depth(request.param)
    levels, intrs = pyramid.build_pyramid(jnp.asarray(d), intr, LEVELS)
    oracle = ref.build_pyramid_np(d, intr.fx, intr.fy, intr.cx, intr.cy,
                                  LEVELS)
    return levels, intrs, oracle


def test_oracle_parity(case):
    """Each stage against the oracle on the device's own input to it:
    pooling against the oracle's pyramid, the vertex map against the
    oracle's unprojection of the level's depth, the plane table against
    the oracle run on the level's vertex map. A one-ulp difference in a
    vertex moves a central difference by ulp / pixel spacing (3e-5 at
    2 m, 640x480), so the 2e-5 plane-table bound is checked on identical
    vertices."""
    levels, intrs, oracle = case
    for k, (got, want, li) in enumerate(zip(levels, oracle, intrs)):
        vvalid = np.asarray(got.vertex_valid)
        np.testing.assert_array_equal(
            vvalid, want["vertex_valid"], err_msg=f"level {k} vertex validity")
        vmap = np.asarray(got.vertex_map)
        np.testing.assert_allclose(vmap[..., 2], want["vertex_map"][..., 2],
                                   rtol=1e-6, err_msg=f"level {k} pooling")
        np.testing.assert_allclose(
            vmap, ref.unproject_np(vmap[..., 2], li.fx, li.fy, li.cx, li.cy),
            atol=1e-5, err_msg=f"level {k} vertex map")
        packed, normal_ok = ref.plane_table_np(vmap, vvalid)
        np.testing.assert_array_equal(
            np.asarray(got.valid), normal_ok & vvalid,
            err_msg=f"level {k} plane validity")
        np.testing.assert_allclose(np.asarray(got.packed), packed, atol=2e-5,
                                   err_msg=f"level {k} plane table")


def test_normals_unit_or_zero(case):
    levels, _, _ = case
    for lv in levels:
        packed = np.asarray(lv.packed)
        norm2 = (packed[0:3] ** 2).sum(0)
        assert np.all((np.abs(norm2 - 1.0) < 1e-4) | (norm2 == 0.0))
        # Zero normal <=> invalid plane, and invalid planes carry d = 0.
        np.testing.assert_array_equal(norm2 > 0.5, np.asarray(lv.valid))
        assert np.all(packed[3][norm2 == 0.0] == 0.0)
    assert np.asarray(levels[0].valid).mean() > 0.3


def test_borders_invalid(case):
    levels, _, _ = case
    for lv in levels:
        norm2 = (np.asarray(lv.packed)[0:3] ** 2).sum(0)
        assert norm2[0].max() == 0.0 and norm2[-1].max() == 0.0
        assert norm2[:, 0].max() == 0.0 and norm2[:, -1].max() == 0.0


def test_vmapped_batch_matches_per_image():
    intr = CASES["128x64_holes"][0]
    depths = []
    for s in range(3):
        d = synthetic.render_depth(intr, jnp.eye(4, dtype=jnp.float32),
                                   synthetic.default_scene(seed=s))
        depths.append(d.at[8 + s:12 + s, 20:30].set(0.0))
    depths = jnp.stack(depths)
    batched = jax.vmap(
        lambda d: pyramid.build_pyramid(d, intr, LEVELS)[0])(depths)
    for i in range(depths.shape[0]):
        single, _ = pyramid.build_pyramid(depths[i], intr, LEVELS)
        for k in range(LEVELS):
            np.testing.assert_allclose(
                np.asarray(batched[k].packed[i]), np.asarray(single[k].packed),
                atol=1e-6)
            np.testing.assert_array_equal(
                np.asarray(batched[k].valid[i]), np.asarray(single[k].valid))


def test_source_role_pyramid_skips_plane_table():
    intr, d = _depth("128x64_holes")
    src, intrs = pyramid.build_pyramid(jnp.asarray(d), intr, LEVELS,
                                       with_normals=False)
    oracle = ref.build_pyramid_np(d, intr.fx, intr.fy, intr.cx, intr.cy,
                                  LEVELS)
    assert [i.height for i in intrs] == [64, 32, 16]
    for lv, want in zip(src, oracle):
        assert not np.asarray(lv.packed).any()
        np.testing.assert_array_equal(np.asarray(lv.valid),
                                      want["vertex_valid"])
        np.testing.assert_allclose(np.asarray(lv.vertex_map),
                                   want["vertex_map"], atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_xla_in_interpret_mode(name):
    """ops/plane_kernel (the GPU path) against the XLA composition it
    replaces, run through the Pallas interpreter."""
    intr, d = _depth(name)
    got = np.asarray(plane_kernel.plane_table(jnp.asarray(d), intr,
                                              interpret=True))
    want = np.asarray(pyramid._plane_table_xla(jnp.asarray(d), intr))
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_array_equal((got[:3] ** 2).sum(0) > 0.5,
                                  (want[:3] ** 2).sum(0) > 0.5)


@pytest.mark.parametrize("platform,kernel", [("cpu", False), ("cuda", True)])
def test_kernel_chosen_by_lowering_platform(platform, kernel):
    """build_pyramid lowers to the Triton kernel for CUDA and to plain XLA
    for the CPU, whatever backend the process runs on."""
    from jax import export

    intr = CASES["128x64_holes"][0]
    f = jax.jit(lambda d: pyramid.build_pyramid(d, intr, 2)[0][1].packed)
    exp = export.export(
        f, platforms=[platform],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(jax.ShapeDtypeStruct((64, 128), jnp.float32))
    text = exp.mlir_module()
    assert ("xla.gpu.triton" in text) == kernel
