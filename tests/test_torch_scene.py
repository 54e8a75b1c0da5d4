"""tracer_torch host side against tracer: config parser, scene building,
carrying a scene across, savers, and the kernel's packed tables.

Both packages get the same inputs; JAX runs on the CPU (tests/conftest.py).
"""

import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tracer.io import image as jax_image
from tracer.scene import builders as jax_builders
from tracer.scene import config as jax_config
from tracer_torch.io import image as torch_image
from tracer_torch.kernels import pack
from tracer_torch.scene import builders, config
from tracer_torch.scene import types as T

CSRC = Path(__file__).resolve().parent.parent / "tracer_torch" / "csrc" / "common.cuh"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process: the suite runs several worker
    processes, and torch's thread pools in each would oversubscribe the
    cores (small eager ops then spin-wait, many times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_scene_fields(scene) -> dict:
    """A tracer Scene's leaves as numpy arrays keyed by dotted field path
    (the input of tracer_torch.scene.types.scene_from_numpy)."""
    fields = {f"{group}.{name}": np.asarray(leaf)
              for group in ("spheres", "planes", "materials")
              for name, leaf in getattr(scene, group)._asdict().items()}
    if scene.textures is not None:
        fields["textures"] = np.asarray(scene.textures)
    return fields


def jax_cam_fields(cam) -> dict:
    return {name: np.asarray(leaf) for name, leaf in cam._asdict().items()}


def torch_scene_fields(scene) -> dict:
    fields = {f"{group}.{name}": leaf.cpu().numpy()
              for group in ("spheres", "planes", "materials")
              for name, leaf in getattr(scene, group)._asdict().items()}
    if scene.textures is not None:
        fields["textures"] = scene.textures.cpu().numpy()
    return fields


def tex8(_path):
    return np.random.default_rng(3).uniform(0.1, 1.0, size=(8, 8, 3)).astype(np.float32)


# n / sqrt(n.n) rounds differently under XLA:CPU in the last place on a few
# components (11 of the canonical scene's 315), and d = normal . base follows
ROUNDED = ("planes.normal", "planes.d")
CONFIGS = {"smoke": config.smoke_config_text, "default": config.default_config_text}
LOADERS = {"no_texture": lambda _path: None, "tex8": tex8}


@pytest.mark.parametrize("loader", sorted(LOADERS))
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_create_scene_matches_tracer(cfg, loader):
    text = CONFIGS[cfg]()
    assert text == getattr(jax_config, CONFIGS[cfg].__name__)()
    want = jax_scene_fields(jax_builders.create_scene(
        jax_config.read_scene_params(io.StringIO(text)), texture_loader=LOADERS[loader]))
    got = torch_scene_fields(builders.create_scene(
        config.read_scene_params(io.StringIO(text)), texture_loader=LOADERS[loader],
        device="cpu"))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        if key in ROUNDED:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if cfg == "default":  # the canonical scene: 94 spheres, 105 planes, 12 materials
        assert (got["spheres.radius"].size, got["planes.d"].size,
                got["materials.fuzz"].size) == (94, 105, 12)


def test_create_scene_bvh_not_ported():
    params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
    with pytest.raises(NotImplementedError):
        builders.create_scene(params, with_bvh=True, texture_loader=lambda _p: None,
                              device="cpu")


@pytest.mark.parametrize("loader", sorted(LOADERS))
def test_scene_from_numpy_round_trips(loader):
    jscene = jax_builders.create_scene(
        jax_config.read_scene_params(io.StringIO(jax_config.smoke_config_text())),
        texture_loader=LOADERS[loader])
    fields = jax_scene_fields(jscene)
    scene = T.scene_from_numpy(fields, "cpu")
    assert (scene.num_spheres, scene.num_planes) == (jscene.num_spheres, jscene.num_planes)
    back = torch_scene_fields(scene)
    assert sorted(back) == sorted(fields)
    for key in fields:
        assert back[key].dtype == fields[key].dtype, key
        np.testing.assert_array_equal(back[key], fields[key], err_msg=key)


def test_config_parser_same_fields():
    for text in (config.smoke_config_text(), config.default_config_text()):
        a = config.read_scene_params(io.StringIO(text))
        b = jax_config.read_scene_params(io.StringIO(text))
        assert repr(a) == repr(b)


@pytest.mark.parametrize("cut", [1, 5, 40])
def test_config_parser_rejects_truncated_with_same_message(cut):
    text = " ".join(config.default_config_text().split()[:-cut])
    with pytest.raises(ValueError) as got:
        config.read_scene_params(io.StringIO(text))
    with pytest.raises(ValueError) as want:
        jax_config.read_scene_params(io.StringIO(text))
    assert str(got.value) == str(want.value)


def _framebuffer():
    return np.random.default_rng(5).uniform(0.0, 9.0, size=(7, 11, 3)).astype(np.float32)


@pytest.mark.parametrize("fmt", ["bin", "ppm", "png"])
def test_savers_byte_equal(fmt, tmp_path):
    if fmt == "png":
        pytest.importorskip("PIL")
    fb = _framebuffer()
    ours, theirs = tmp_path / f"a.{fmt}", tmp_path / f"b.{fmt}"
    torch_image.SAVERS[fmt](str(ours), fb, 4)
    jax_image.SAVERS[fmt](str(theirs), fb, 4)
    assert ours.read_bytes() == theirs.read_bytes()


def test_threaded_writer_and_read_binary(tmp_path):
    fb = _framebuffer()
    w = torch_image.ThreadedWriter()
    w.submit(str(tmp_path / "f.bin"), fb, 2, fmt="bin")
    w.close()
    np.testing.assert_array_equal(torch_image.read_binary(str(tmp_path / "f.bin")),
                                  jax_image.quantize(fb, 2))


def _cu_enum(name):
    body = re.search(r"enum %s \{([^}]*)\}" % name, CSRC.read_text()).group(1)
    items = [x.strip() for x in body.split(",") if x.strip()]
    assert items[-1].endswith("_ROWS")
    return tuple(x.split("_", 1)[1].lower() for x in items[:-1])


@pytest.mark.parametrize("enum, rows", [
    ("SphereRow", pack.SPHERE_ROWS), ("PlaneRow", pack.PLANE_ROWS),
    ("JoinRow", pack.JOIN_ROWS), ("CameraRow", pack.CAMERA_ROWS),
])
def test_pack_rows_match_kernel_source(enum, rows):
    assert _cu_enum(enum) == rows


def test_pack_scene_tables():
    params = config.read_scene_params(io.StringIO(config.default_config_text()))
    scene = builders.create_scene(params, texture_loader=tex8, device="cpu")
    p = pack.pack_scene(scene)
    s, n = scene.num_spheres, scene.num_spheres + scene.num_planes
    assert (p.num_s, p.num_p) == (s, scene.num_planes)
    assert p.sph.shape == (s, len(pack.SPHERE_ROWS)) and p.sph.is_contiguous()
    assert p.pla.shape == (scene.num_planes, len(pack.PLANE_ROWS)) and p.pla.is_contiguous()
    assert p.join.shape == (len(pack.JOIN_ROWS), n) and p.join.is_contiguous()
    assert all(t.dtype == torch.float32 for t in (p.sph, p.pla, p.join))
    row = {name: i for i, name in enumerate(pack.PLANE_ROWS)}
    torch.testing.assert_close(p.sph[:, 3], scene.spheres.radius, rtol=0, atol=0)
    torch.testing.assert_close(p.pla[:, row["wx"]:row["wx"] + 3], scene.planes.w, rtol=0, atol=0)
    assert torch.equal(p.pla[:, row["ptype"]], scene.planes.ptype.float())
    midx = torch.cat([scene.spheres.material_idx, scene.planes.material_idx]).long()
    jrow = {name: i for i, name in enumerate(pack.JOIN_ROWS)}
    assert torch.equal(p.join[jrow["tex_id"]], scene.materials.tex_id[midx].float())
    assert torch.equal(p.join[jrow["emi0"]:jrow["emi0"] + 3].T, scene.materials.emit[midx])
    assert (p.join[jrow["tex_id"]] >= 0).sum() == 1  # the textured floor only


def test_pack_records_are_whole_float4s_holding_the_fields():
    """The kernel reads a sphere as one float4 and a plane as five: every
    field at the offset common.cuh declares, the padding zero."""
    body = CSRC.read_text()
    assert "SPHERE_F4 = S_ROWS / 4" in body and "PLANE_F4 = P_ROWS / 4" in body
    assert len(_cu_enum("SphereRow")) == 4 and len(_cu_enum("PlaneRow")) == 20
    params = config.read_scene_params(io.StringIO(config.default_config_text()))
    scene = builders.create_scene(params, texture_loader=lambda _p: None, device="cpu")
    p = pack.pack_scene(scene)
    assert p.sph.data_ptr() % 16 == 0 and p.pla.data_ptr() % 16 == 0
    sph = p.sph.reshape(-1, 4)  # float4 records
    assert sph.shape[0] == scene.num_spheres
    torch.testing.assert_close(sph[:, :3], scene.spheres.center, rtol=0, atol=0)
    torch.testing.assert_close(sph[:, 3], scene.spheres.radius, rtol=0, atol=0)
    pla = p.pla.reshape(scene.num_planes, 5, 4)
    off = {name: divmod(i, 4) for i, name in enumerate(_cu_enum("PlaneRow"))}
    planes = scene.planes
    for field, value in (("n", planes.normal), ("b", planes.base), ("u", planes.u),
                         ("v", planes.v), ("w", planes.w)):
        q, c = off[field + "x"]
        assert off[field + "z"] == (q, c + 2)
        torch.testing.assert_close(pla[:, q, c:c + 3], value, rtol=0, atol=0)
    torch.testing.assert_close(pla[:, off["d"][0], off["d"][1]], planes.d, rtol=0, atol=0)
    assert torch.equal(pla[:, off["ptype"][0], off["ptype"][1]], planes.ptype.float())
    for pad in ("pad0", "pad1", "pad2"):
        assert not pla[:, off[pad][0], off[pad][1]].any()
