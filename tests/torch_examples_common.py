"""What the port's demos (softwarerenderer_tpu_torch.examples) must write,
and how the tests run them: each demo's main with device="cpu", its
outputs redirected into a test's directory (same basenames), frames=2
where main takes frames.  Imported by tests/test_torch_examples_*.py."""

import importlib
import importlib.util
import os

import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frames(fmt, idx):
    return tuple(fmt.format(i) for i in idx)


# The files each JAX demo (examples/<name>.py) writes, relative to the
# directory its outputs go to, and each image's (H, W, 3) shape; the AVI's
# frame count is main's `frames`.
OUTPUTS = {
    "spinning_cube": (_frames("spinning_cube/frame_{:02d}.png", range(8)),
                      (480, 640, 3)),
    "custom_shader": (("custom_shader.png",), (480, 640, 3)),
    "translucency_kbuffer": (("kbuffer_example.png",), (480, 640, 3)),
    "raytraced": (("raytraced.png",), (320, 960, 3)),
    "shadowed_scene": (("shadow_demo.png",), (480, 640, 3)),
    "point_light_shadows": (("point_shadows_example.png",), (480, 640, 3)),
    "pbr_materials": (("pbr_materials.png",), (400, 640, 3)),
    "sky_environment": (("sky_environment.png",), (400, 640, 3)),
    "normal_mapping": (("normal_mapping/plain.png",
                        "normal_mapping/normal_mapped.png"), (360, 480, 3)),
    "mesh_lod": (("mesh_lod.png",), (360, 640, 3)),
    "morph_targets": (_frames("morph/frame_{:03d}.png", range(12)),
                      (360, 480, 3)),
    "skeletal_animation": (_frames("skeletal/frame_{:03d}.png", range(12)),
                           (360, 480, 3)),
    "skinned_crowd": (("skinned_crowd.png",), (360, 640, 3)),
    "particle_fountain": (("particle_fountain.png",), (360, 640, 3)),
    "ai_agents": (("ai_agents.png",), (360, 640, 3)),
    "render_to_texture": (_frames("render_to_texture/frame_{:02d}.png",
                                  (0, 6, 12)), (360, 480, 3)),
    "split_screen": (_frames("split/frame_{:03d}.png", range(8)),
                     (240, 640, 3)),
    "multichip_render": (("multichip.png",), (384, 512, 3)),
    "showcase": (("showcase.avi",), (400, 640, 3)),
}
FRAMES = 2          # main's `frames`, where it takes one


def redirect(mod, out_dir: str) -> dict:
    """main's keyword arguments that send `mod`'s outputs into out_dir
    (chip_smoke's, phase 27b: the default paths' basenames kept, a
    module-level OUT pointed there too), and frames=FRAMES."""
    import inspect

    import chip_smoke
    kw = chip_smoke._demo_kwargs(mod, out_dir)
    if "frames" in inspect.signature(mod.main).parameters:
        kw["frames"] = FRAMES
    return kw


def run_port_demo(name: str, out_dir: str, monkeypatch):
    """Run the port's demo `name` on the CPU into out_dir (also the
    working directory, for the demos that write relative paths); returns
    main's result."""
    mod = importlib.import_module(
        f"softwarerenderer_tpu_torch.examples.{name}")
    monkeypatch.chdir(out_dir)
    if hasattr(mod, "OUT"):         # restored after the test
        monkeypatch.setattr(mod, "OUT", mod.OUT)
    return mod.main(device="cpu", **redirect(mod, out_dir))


def run_jax_demo(name: str, out_dir: str, monkeypatch):
    """Run the JAX package's demo examples/<name>.py into out_dir, as
    tests/test_examples.py does."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.chdir(out_dir)
    return mod.main(**redirect(mod, out_dir))


def read_image(path: str) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


def check_outputs(name: str, out_dir: str, result=None) -> list:
    """The JAX demo's files exist in out_dir, non-empty, each image of its
    shape (the AVI with FRAMES frames of it), and, given the port's main's
    result, equal to what it returned; returns the images in the order
    written."""
    from softwarerenderer_tpu_torch.utils.video import read_avi
    files, shape = OUTPUTS[name]
    images = []
    for f in files:
        path = os.path.join(out_dir, f)
        assert os.path.getsize(path) > 0, (name, f)
        if f.endswith(".avi"):
            frames, _fps = read_avi(path)
            assert len(frames) == FRAMES, (name, len(frames))
            images += [np.asarray(x) for x in frames]
        else:
            images.append(read_image(path))
        assert all(im.shape == shape for im in images), (name, f)
    if result is None:
        pass
    elif name == "showcase":
        assert result == os.path.join(out_dir, files[0])
    else:
        got = result if isinstance(result, list) else [result]
        assert len(got) == len(images), name
        for a, b in zip(got, images):
            np.testing.assert_array_equal(a, b, err_msg=name)
    return images


def share_off(got: np.ndarray, want: np.ndarray, by: int = 2) -> float:
    """The share of pixels whose RGB8 values differ by more than `by`
    (tests/test_goldens.py's measure)."""
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return float(np.mean(np.any(d > by, axis=-1)))
