"""The port's ``io`` (surface extraction, mesh export, plotting) on the CPU:
JAX's ``tests/test_io.py`` on ``lsm_tpu_torch``, then parity with
``lsm_tpu.io`` on the same numpy values (the triangle soups, segments and
welded meshes bit for bit, the ``.mesh``/``.sol``/``.obj`` files byte for
byte), float32 and grad-requiring fields through every reader, MMG missing
from the PATH, and two processes building the native helper at once."""

import ctypes
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lsm_tpu as J
import lsm_tpu.io as jio
import lsm_tpu_torch as T
import lsm_tpu_torch.io as tio
from lsm_tpu.io import marching as jmarching
from lsm_tpu.models import shapes as jshapes
from lsm_tpu_torch.io import marching as tmarching
from lsm_tpu_torch.models import shapes as tshapes
from lsm_tpu_torch.utils.checkpoint import field_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUBE = ((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0))
SQUARE = ((-1.0, -1.0), (1.0, 1.0))


def _sphere(n=33, r=0.5):
    grid = T.Grid(*CUBE, (n, n, n))
    return T.sample(tshapes.sphere((0.0, 0.0, 0.0), r), grid, dtype=torch.float64, device="cpu")


def _pair(jphi, lo_hi, bcs=None):
    """JAX's field and the port's on the same numpy values (CPU, f64)."""
    vals = np.array(jphi.values)
    return jphi, field_from_numpy(vals, T.Grid(*lo_hi, vals.shape), bcs, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _jax_native(tmp_path_factory):
    """JAX's helper, built by its own Makefile into a directory of this
    module's: ``lsm_tpu.io`` builds into ``native/`` when the library is not
    there, and a test file in another worker may be doing so at the same
    moment."""
    out = tmp_path_factory.mktemp("jax_native") / "liblsm_native.so"
    subprocess.run(["make", "-C", os.path.join(ROOT, "native"), f"TARGET={out}"], check=True,
                   capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmarching, "_LIB_PATH", out)
        mp.setattr(jmarching, "_lib", None)
        yield


@pytest.fixture(scope="module")
def sphere25():
    return _pair(J.sample(jshapes.sphere((0.0, 0.0, 0.0), 0.5), J.Grid(*CUBE, (25,) * 3)), CUBE)


@pytest.fixture(scope="module")
def sphere17():
    return _pair(J.sample(jshapes.sphere((0.0, 0.0, 0.0), 0.5), J.Grid(*CUBE, (17,) * 3)), CUBE)


@pytest.fixture(scope="module")
def circle101():
    return _pair(J.sample(jshapes.circle((0.0, 0.0), 0.6), J.Grid(*SQUARE, (101, 101))), SQUARE)


# -- JAX's tests/test_io.py on the port --------------------------------------------


def test_marching_tets_sphere_area_and_radius():
    phi = _sphere(41)
    tris = tio.marching_tetrahedra(phi)
    assert tris.shape[0] > 100
    radii = np.linalg.norm(tris.reshape(-1, 3), axis=1)
    assert np.abs(radii - 0.5).max() < 0.01
    a = tris[:, 1] - tris[:, 0]
    b = tris[:, 2] - tris[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(a, b), axis=1).sum()
    assert abs(area - 4 * np.pi * 0.25) < 0.05, area


def test_marching_tets_watertight(sphere25):
    # welded mesh of a closed surface: every edge shared by exactly 2 triangles
    verts, faces = tio.weld_triangles(tio.marching_tetrahedra(sphere25[1]))
    edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert len(faces) > 100 and (counts == 2).all()


def test_marching_squares_circle(circle101):
    segs = tio.marching_squares(circle101[1])
    assert segs.shape[0] > 50
    radii = np.linalg.norm(segs.reshape(-1, 2), axis=1)
    assert np.abs(radii - 0.6).max() < 0.005
    lengths = np.linalg.norm(segs[:, 1] - segs[:, 0], axis=1).sum()
    assert abs(lengths - 2 * np.pi * 0.6) < 0.05


def test_mesh_export(tmp_path, sphere17):
    phi = sphere17[1]
    surf = tio.export_surface_mesh(phi, tmp_path / "sphere")
    text = surf.read_text()
    assert "Triangles" in text and "Vertices" in text

    vol = tio.export_volume_mesh(phi, tmp_path / "ball")
    assert "Tetrahedra" in vol.read_text()
    assert "SolAtVertices" in (tmp_path / "ball.sol").read_text()

    verts, faces = tio.weld_triangles(tio.marching_tetrahedra(phi))
    obj = tio.write_obj(tmp_path / "sphere.obj", verts, faces)
    assert obj.read_text().startswith("v ")


def test_no_interface(tmp_path):
    grid = T.Grid(*CUBE, (9, 9, 9))
    phi = T.sample(lambda X, Y, Z: 1.0 + 0 * (X + Y + Z), grid, dtype=torch.float64,
                   device="cpu")
    assert tio.marching_tetrahedra(phi).shape == (0, 3, 3)
    with pytest.raises(ValueError):
        tio.export_surface_mesh(phi, tmp_path / "nothing")
    assert not list(tmp_path.iterdir())
    flat = T.sample(lambda X, Y: 1.0 + 0 * (X + Y), T.Grid(*SQUARE, (9, 9)),
                    dtype=torch.float64, device="cpu")
    assert tio.marching_squares(flat).shape == (0, 2, 2)


def test_plotting(tmp_path):
    grid = T.Grid(*SQUARE, (64, 64))
    phi = T.sample(tshapes.star(), grid, T.Extrapolation(2), dtype=torch.float64, device="cpu")
    p = tio.save_plot(phi, tmp_path / "star.png")
    assert p.stat().st_size > 1000
    nb = T.NarrowBandField.from_field(phi)
    p2 = tio.save_plot(nb, tmp_path / "band.png")
    assert p2.stat().st_size > 1000
    p3 = tio.save_plot(_sphere(17), tmp_path / "sphere3d.png")
    assert p3.stat().st_size > 1000


@pytest.mark.parametrize("fn, ndim", [(tio.marching_tetrahedra, 2), (tio.marching_squares, 3),
                                      (tio.export_volume_mesh, 2), (tio.export_surface_mesh, 2),
                                      (tio.plot_levelset, 3)])
def test_wrong_ndim_raises(tmp_path, fn, ndim):
    grid = T.Grid(*(CUBE if ndim == 3 else SQUARE), (5,) * ndim)
    phi = T.sample(lambda *xs: sum(xs), grid, dtype=torch.float64, device="cpu")
    args = (tmp_path / "x",) if fn in (tio.export_volume_mesh, tio.export_surface_mesh) else ()
    with pytest.raises(ValueError, match=f"{3 if ndim == 2 else 2}D"):
        fn(phi, *args)


# -- parity with lsm_tpu.io on the same values ------------------------------------


def test_marching_tetrahedra_bit_equal_jax(sphere25):
    jphi, tphi = sphere25
    want, got = jio.marching_tetrahedra(jphi), tio.marching_tetrahedra(tphi)
    assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
    assert np.array_equal(got, want)
    for iso in (0.1, -0.2):
        assert np.array_equal(tio.marching_tetrahedra(tphi, iso), jio.marching_tetrahedra(jphi, iso))


def test_marching_squares_bit_equal_jax(circle101):
    jphi, tphi = circle101
    for iso in (0.0, 0.25):
        want, got = jio.marching_squares(jphi, iso), tio.marching_squares(tphi, iso)
        assert want.shape[0] > 50 and got.shape == want.shape and np.array_equal(got, want)


def test_weld_triangles_bit_equal_jax(sphere25):
    tris = jio.marching_tetrahedra(sphere25[0])
    for decimals in (9, 3):
        (jv, jf), (tv, tf) = jio.weld_triangles(tris, decimals), tio.weld_triangles(tris, decimals)
        assert np.array_equal(tv, jv) and np.array_equal(tf, jf) and tf.dtype == jf.dtype


def test_export_files_byte_equal_jax(tmp_path, sphere17):
    jphi, tphi = sphere17
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    outs = {}
    for tag, io, phi in (("j", jio, jphi), ("t", tio, tphi)):
        d = tmp_path / tag
        io.export_surface_mesh(phi, d / "sphere")
        io.export_volume_mesh(phi, d / "ball")
        io.write_obj(d / "sphere.obj", *io.weld_triangles(io.marching_tetrahedra(phi)))
        outs[tag] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert sorted(outs["t"]) == ["ball.mesh", "ball.sol", "sphere.mesh", "sphere.obj"]
    for name, data in outs["j"].items():
        assert len(data) > 1000 and outs["t"][name] == data, name


@pytest.mark.parametrize("kind", ["float32", "requires_grad"])
def test_every_reader_takes_f32_and_grad_fields(tmp_path, kind):
    """A float32 field and one that requires grad give what the float64
    field of the same values gives, through every reader."""
    rng = np.random.default_rng(7)
    v3 = np.array(J.sample(jshapes.sphere((0.0, 0.0, 0.0), 0.5), J.Grid(*CUBE, (17,) * 3)).values)
    v3 += 1e-3 * rng.standard_normal(v3.shape)
    v2 = np.array(J.sample(jshapes.star(), J.Grid(*SQUARE, (40, 40))).values)
    if kind == "float32":
        v3, v2 = v3.astype(np.float32), v2.astype(np.float32)
    phi3 = field_from_numpy(v3, T.Grid(*CUBE, v3.shape), device="cpu")
    phi2 = field_from_numpy(v2, T.Grid(*SQUARE, v2.shape), device="cpu")
    if kind == "requires_grad":
        phi3, phi2 = (p.with_values(p.values.clone().requires_grad_()) for p in (phi3, phi2))
        assert phi3.values.requires_grad
    else:
        assert phi3.dtype == torch.float32
    ref3 = field_from_numpy(v3.astype(np.float64), T.Grid(*CUBE, v3.shape), device="cpu")
    ref2 = field_from_numpy(v2.astype(np.float64), T.Grid(*SQUARE, v2.shape), device="cpu")
    # JAX on the same (widened) values
    jref3 = J.MeshField(jnp.asarray(v3.astype(np.float64)), J.Grid(*CUBE, v3.shape))
    assert np.array_equal(tio.marching_tetrahedra(phi3), jio.marching_tetrahedra(jref3))
    assert np.array_equal(tio.marching_squares(phi2), tio.marching_squares(ref2))
    for tag, phi in (("a", phi3), ("b", ref3)):
        tio.export_volume_mesh(phi, tmp_path / f"{tag}vol")
        tio.export_surface_mesh(phi, tmp_path / f"{tag}surf")
    for name in ("vol.mesh", "vol.sol", "surf.mesh"):
        assert (tmp_path / f"a{name}").read_bytes() == (tmp_path / f"b{name}").read_bytes(), name
    assert tio.save_plot(phi2, tmp_path / "p2.png").stat().st_size > 1000
    assert tio.save_plot(T.NarrowBandField.from_field(phi2), tmp_path / "b2.png").stat().st_size > 1000
    assert tio.save_plot(phi3, tmp_path / "p3.png").stat().st_size > 1000


@pytest.mark.parametrize("which", ["volume", "surface"])
def test_run_mmg_without_mmg_raises(tmp_path, monkeypatch, sphere17, which):
    tmarching.native_lib()  # built (or loaded) while the PATH still holds the compiler
    monkeypatch.setenv("PATH", "")
    export = tio.export_volume_mesh if which == "volume" else tio.export_surface_mesh
    with pytest.raises(FileNotFoundError, match="MMG not found"):
        export(sphere17[1], tmp_path / "m", run_mmg=True)
    assert (tmp_path / "m.mesh").exists()  # the input was still written
    assert (tmp_path / "m.sol").exists() == (which == "volume")


def test_concurrent_builds_leave_one_library(tmp_path):
    """Two processes building the helper into one empty directory at the
    same moment leave one loadable library and no temporary file, and
    ``native/`` is not written."""
    native = sorted(os.listdir(os.path.join(ROOT, "native")))
    code = ("import sys; from lsm_tpu_torch.io.marching import build_native; "
            "print(build_native(sys.argv[1]))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    paths = {o[0].strip().splitlines()[-1] for o in outs}
    files = sorted(os.listdir(tmp_path))
    assert len(paths) == 1 and len(files) == 1 and files[0].startswith("liblsm_native-")
    assert files[0].endswith(".so") and os.path.basename(paths.pop()) == files[0]
    lib = tmarching._declare(ctypes.CDLL(str(tmp_path / files[0])))
    assert lib.lsm_marching_tets.restype is ctypes.c_int64
    assert sorted(os.listdir(os.path.join(ROOT, "native"))) == native
    assert tmarching.build_native(tmp_path) == tmp_path / files[0]  # found, not rebuilt


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tmarching, "NATIVE_SRC", bad)
    with pytest.raises(RuntimeError, match="exit code") as err:
        tmarching.build_native(tmp_path / "build")
    assert "broken.cpp" in str(err.value)
    assert os.listdir(tmp_path / "build") == []
