"""3DIdent rendering: latents → scene parameters → Cycles renders.

A copy of cl_ica_tpu/tools/render_3dident.py (numpy; ``bpy`` is imported
where Blender is needed), so that the port keeps the dataset tools of the
JAX package without importing it.

Reference parity: tools/3dident/generate_clevr_dataset_images.py +
render_utils.py (offline step 2 of dataset creation; runs INSIDE Blender
— `blender --background --python <this file> -- [args]`). Rendering is
inherently external to the training framework (SURVEY.md §2.4: keep the
offline dataset format); what this module contributes:

1. `latents_to_scene(...)`: the pure-numpy mapping from the 10 renderer
   latents to scene parameters — object xyz (z lifted by half object
   height), euler rotations, HSV→RGB object/spotlight/background colors,
   and the spotlight orbiting at radius 4 around the object
   (generate_clevr_dataset_images.py:235-299). This defines the
   ground-truth generative process and is testable without Blender.
2. The sharded, resumable render driver (skip-existing semantics,
   `--n-batches/--batch-index` embarrassing parallelism,
   generate_clevr_dataset_images.py:29-49), gated on `import bpy`.
3. Full scene CONSTRUCTION from the published assets via
   tools/blender_scene.py (`build_scene`: base blendfile + Cycles config
   + teapot + tracked spotlight + ground plane — the initialize_renderer
   / add_objects_and_lights path, generate_clevr_dataset_images.py:
   61-232). Pass --assets to build from scratch; without it the loop
   assumes a pre-built scene (objects named Object_0 / Spotlight_Object_0).

Scene assets (base_scene_equal_xyz.blend, materials, the teapot shape)
are the published CLEVR-derived data accompanying the reference; point
--assets at a checkout of them.
"""

from __future__ import annotations

import argparse
import colorsys
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np

SPOTLIGHT_ORBIT_RADIUS = 4.0
SPOTLIGHT_HEIGHT_OFFSET = 6.0
SPOTLIGHT_ENERGY = 3000.0
SPOT_SIZE_DEG = 35.0
RENDER_SIZE = 224
RENDER_SAMPLES = 512


@dataclass
class SceneParams:
    """Scene parameters for one object + scene-level background."""

    object_location: Tuple[float, float, float]
    object_rotation_euler: Tuple[float, float, float]
    object_rgba: Tuple[float, float, float, float]
    spotlight_location: Tuple[float, float, float]
    spotlight_rgb: Tuple[float, float, float]
    background_rgba: Tuple[float, float, float, float]


def latents_to_scene(latents: np.ndarray, max_object_size: float = 1.5) -> SceneParams:
    """Map one row of renderer latents (layout per
    generate_clevr_dataset_latents.py:33-49: [x, y, z, α, β, γ, θ_spot,
    hue_obj, hue_spot, hue_bg]) to scene parameters."""
    latents = np.asarray(latents, dtype=np.float64)
    assert latents.shape[-1] == 10
    x, y, z = latents[0], latents[1], latents[2]
    obj_loc = (float(x), float(y), float(z + max_object_size / 2))
    obj_rot = tuple(float(v) for v in latents[3:6])
    obj_rgba = colorsys.hsv_to_rgb(latents[7] / (2 * np.pi), 1.0, 1.0) + (1.0,)
    spot_rgb = colorsys.hsv_to_rgb(latents[8] / (2 * np.pi), 0.8, 1.0)
    theta = latents[6]
    spot_loc = (
        float(SPOTLIGHT_ORBIT_RADIUS * np.sin(theta)),
        float(SPOTLIGHT_ORBIT_RADIUS * np.cos(theta)),
        float(SPOTLIGHT_HEIGHT_OFFSET + max_object_size),
    )
    bg_rgba = colorsys.hsv_to_rgb(latents[9] / (2 * np.pi), 0.60, 1.0) + (1.0,)
    return SceneParams(
        object_location=obj_loc,
        object_rotation_euler=obj_rot,
        object_rgba=tuple(float(v) for v in obj_rgba),
        spotlight_location=spot_loc,
        spotlight_rgb=tuple(float(v) for v in spot_rgb),
        background_rgba=tuple(float(v) for v in bg_rgba),
    )


def shard_indices(n_samples: int, n_batches: int, batch_index: int) -> np.ndarray:
    """Embarrassingly-parallel render sharding
    (generate_clevr_dataset_images.py:29-30)."""
    return np.array_split(np.arange(n_samples), n_batches)[batch_index]


def bpy_available() -> bool:
    try:
        import bpy  # noqa: F401

        return True
    except ImportError:
        return False


def resolve_object_name(names, index: int) -> str:
    """First scene-object name ending in ``Object_{index}`` — the
    reference's lookup (generate_clevr_dataset_images.py:249-253), which
    must find both a pre-built scene's literal ``Object_0`` and the
    appended-asset name ``ShapeTeapot_0_Object_0`` produced by
    blender_scene.append_shape. Spotlights (``Spotlight_Object_i``) also
    end in the suffix; the reference dodges them only because bpy
    iterates alphabetically and every shape name starts with "Shape" —
    here they are excluded explicitly so the contract is robust to any
    shape name."""
    suffix = f"Object_{index}"
    for name in names:
        if name.endswith(suffix) and "Spotlight" not in name:
            return name
    raise KeyError(f"no scene object matches *{suffix}")


def frame_resume_state(out: str, want_segm: bool):
    """Resumability decision (generate_clevr_dataset_images.py:47-49),
    extended for the segmentation pass: a frame counts as DONE only when
    every requested output exists, so re-running with --segmentation
    backfills ``*_segm.png`` next to already-rendered RGB frames instead
    of skipping them. Returns ``(have_rgb, done)``; the render loop
    skips the RGB render when ``have_rgb`` and the whole frame when
    ``done``."""
    from .blender_scene import segm_output_path

    have_rgb = os.path.exists(out)
    done = have_rgb and (
        not want_segm or os.path.exists(segm_output_path(out))
    )
    return have_rgb, done


def _apply_scene(bpy, params: SceneParams, object_name: str, spot_name: str,
                 update_lights: bool):
    obj = bpy.data.objects[object_name]
    obj.location = params.object_location
    obj.rotation_euler = params.object_rotation_euler
    mat = obj.data.materials[-1]
    _set_material_color(mat, params.object_rgba)
    if update_lights:
        spot = bpy.data.objects[spot_name]
        spot.data.color = params.spotlight_rgb
        spot.location = params.spotlight_location
    ground = bpy.data.objects["Ground"].data.materials[-1]
    _set_material_color(ground, params.background_rgba)


def _set_material_color(material, rgba):
    """Set the Color input of the material's group node (render_utils
    change_material semantics)."""
    for node in material.node_tree.nodes:
        for inp in getattr(node, "inputs", []):
            if inp.name == "Color":
                inp.default_value = rgba
                return


def render_shard(args):
    """Blender-side render loop (resumable: skips existing files)."""
    import bpy  # requires running inside Blender

    latents = np.load(os.path.join(args.output_folder, "latents.npy"))
    n_samples = len(latents)
    indices = shard_indices(n_samples, args.n_batches, args.batch_index)
    out_dir = os.path.join(args.output_folder, "images")
    os.makedirs(out_dir, exist_ok=True)
    zfill = int(np.ceil(np.log10(n_samples)))

    n_objects = (latents.shape[1] - 1) // 8
    segm_materials = None
    if args.assets:
        # build the whole scene from the published assets
        from .blender_scene import (
            build_scene,
            build_segmentation_materials,
            cycles_settings,
        )

        build_scene(
            args.assets,
            shape_names=(args.shape_names or ["Teapot"] * n_objects),
            material_names=(args.material_names or ["Rubber"] * n_objects),
            include_lights=not args.no_spotlights,
            settings=cycles_settings(
                width=RENDER_SIZE, height=RENDER_SIZE,
                render_num_samples=RENDER_SAMPLES,
                render_tile_size=256 if args.use_gpu else 64,
                use_gpu=args.use_gpu,
            ),
        )
        if args.segmentation:
            segm_materials, _ = build_segmentation_materials(
                args.assets, n_objects
            )
    elif args.segmentation:
        raise SystemExit(
            "--segmentation needs --assets (the segmentation materials "
            "come from data/node_groups/NodeGroup.blend)"
        )

    scene = bpy.context.scene
    scene.render.engine = "CYCLES"
    scene.render.resolution_x = RENDER_SIZE
    scene.render.resolution_y = RENDER_SIZE
    scene.cycles.samples = RENDER_SAMPLES

    # objects may carry appended-asset names (ShapeTeapot_0_Object_0) or
    # the pre-built scene's literal names — match by suffix either way
    all_names = [o.name for o in bpy.data.objects]
    object_name = resolve_object_name(all_names, 0)

    for idx in indices:
        out = os.path.join(out_dir, f"{str(idx).zfill(zfill)}.png")
        have_rgb, done = frame_resume_state(out, segm_materials is not None)
        if done:
            print("Skipped file", out)
            continue
        params = latents_to_scene(latents[idx])
        _apply_scene(bpy, params, object_name, "Spotlight_Object_0",
                     not args.no_spotlights)
        if not have_rgb:
            scene.render.filepath = out
            bpy.ops.render.render(write_still=True)
        if segm_materials is not None:
            from .blender_scene import render_segmentation_pass

            render_segmentation_pass([object_name], segm_materials, out)
        if args.save_scene:
            # debugging aid (generate_clevr_dataset_images.py:303-308)
            bpy.ops.wm.save_as_mainfile(
                filepath=f"scene_{os.path.basename(out)}.blend"
            )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output-folder", required=True, type=str)
    parser.add_argument("--n-batches", default=1, type=int)
    parser.add_argument("--batch-index", default=0, type=int)
    parser.add_argument("--no-spotlights", action="store_true")
    parser.add_argument("--assets", default=None, type=str,
                        help="path to the CLEVR-derived scene assets; when "
                             "given, the scene is built from scratch "
                             "(base blendfile + object + spotlight + ground)")
    parser.add_argument("--use-gpu", action="store_true")
    parser.add_argument("--shape-names", nargs="*", default=None)
    parser.add_argument("--material-names", nargs="*", default=None)
    parser.add_argument("--save-scene", action="store_true",
                        help="save a debug .blend next to each render "
                             "(generate_clevr_dataset_images.py:303-308)")
    parser.add_argument("--segmentation", action="store_true",
                        help="also render a *_segm.png per sample using "
                             "the NodeGroup segmentation materials "
                             "(requires --assets)")
    args = parser.parse_args(argv)
    if not bpy_available():
        raise SystemExit(
            "Rendering requires Blender: run as\n"
            "  blender --background <base_scene.blend> --python "
            "cl_ica_tpu_torch/tools/render_3dident.py -- [args]"
        )
    render_shard(args)


if __name__ == "__main__":
    import sys

    argv = sys.argv[sys.argv.index("--") + 1:] if "--" in sys.argv else None
    main(argv)
