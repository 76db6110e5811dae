"""3DIdent Blender scene construction: declarative plan + bpy executor.

A copy of cl_ica_tpu/tools/blender_scene.py (numpy; ``bpy`` is imported
where Blender is needed).

Reference parity: tools/3dident/generate_clevr_dataset_images.py:61-232
(`initialize_renderer`, `add_objects_and_lights`) and the used subset of
tools/3dident/render_utils.py:80-250 (`add_object`, `load_materials`,
`add_material`, `change_material`, `add_texture`, `render_segmentation`).

Design difference from the reference: scene construction is split into a
PURE declarative plan (`scene_plan`, `cycles_settings` — plain dicts,
unit-testable without Blender) and a thin bpy executor (`build_scene`)
that walks the plan inside Blender. Run as:

  blender --background --python cl_ica_tpu_torch/tools/render_3dident.py -- \
      --assets <clevr-assets-dir> --output-folder DIR [--n-batches N ...]

where the assets dir is the published CLEVR-derived data shipped with
the reference (data/scenes/base_scene_equal_xyz.blend, data/materials/,
data/shapes/ShapeTeapot.blend, data/node_groups/NodeGroup.blend).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

OBJECT_SCALE = 1.5
SPOTLIGHT_ENERGY = 3000.0
SPOT_SIZE_RAD = 35.0 / 180.0 * np.pi
SPOT_BLEND = 0.1
SPOT_SHADOW_SOFT_SIZE = 0.5
SPOT_CONTACT_SHADOW_DISTANCE = float(np.sqrt(3) * 3)
SPOT_INITIAL_LOCATION = (7.0, 7.0, 7.0)
GROUND_PLANE_SIZE = 1500.0
GROUND_COLOR = (0.5, 0.5, 0.5, 1.0)


def cycles_settings(
    width: int = 224,
    height: int = 224,
    render_num_samples: int = 512,
    render_min_bounces: int = 8,
    render_max_bounces: int = 8,
    render_tile_size: int = 64,
    use_gpu: bool = False,
) -> Dict:
    """Renderer configuration (generate_clevr_dataset_images.py:98-150):
    Cycles at 224², 512 samples, denoising on (for the spotlights),
    reflections disabled (max_bounces=0)."""
    return {
        "engine": "CYCLES",
        "resolution_x": width,
        "resolution_y": height,
        "resolution_percentage": 100,
        "tile_x": render_tile_size,
        "tile_y": render_tile_size,
        "device": "GPU" if use_gpu else "CPU",
        "samples": render_num_samples,
        "transparent_min_bounces": render_min_bounces,
        "transparent_max_bounces": render_max_bounces,
        "blur_glossy": 2.0,
        "sample_as_light": True,
        "use_denoising": True,
        "max_bounces": 0,  # disable reflections
    }


def scene_plan(
    shape_names: List[str],
    material_names: List[str],
    include_lights: bool = True,
    ground_texture: Optional[str] = None,
) -> Dict:
    """Declarative scene: one entry per object (teapot by default), its
    tracked spotlight, and the ground plane. Pure data — no bpy."""
    assert len(shape_names) == len(material_names)
    objects = []
    for i, (shape, material) in enumerate(zip(shape_names, material_names)):
        entry = {
            "name": f"Object_{i}",
            "shape": f"Shape{shape}",
            "material": material,
            "scale": OBJECT_SCALE,
            "location": (0.0, 0.0, 0.0),
            "color": (0.0, 0.0, 0.0, 1.0),
        }
        if include_lights:
            entry["spotlight"] = {
                "name": f"Spotlight_Object_{i}",
                "energy": SPOTLIGHT_ENERGY,
                "spot_size": SPOT_SIZE_RAD,
                "spot_blend": SPOT_BLEND,
                "shadow_soft_size": SPOT_SHADOW_SOFT_SIZE,
                "falloff_type": "CONSTANT",
                "contact_shadow_distance": SPOT_CONTACT_SHADOW_DISTANCE,
                "location": SPOT_INITIAL_LOCATION,
                "track_to": f"Object_{i}",  # TRACK_NEGATIVE_Z, up X
            }
        objects.append(entry)
    return {
        "objects": objects,
        "ground": (
            {"texture": ground_texture}
            if ground_texture
            else {
                "plane_size": GROUND_PLANE_SIZE,
                "material": "Rubber",
                "color": GROUND_COLOR,
                # plane sits at z = -max object height so objects rest on it
                "z_from_max_object_height": True,
            }
        ),
        "segmentation_objects": len(objects),
    }


# --------------------------------------------------------------------------
# bpy executor (everything below requires running inside Blender)
# --------------------------------------------------------------------------


def load_material_nodegroups(material_dir: str) -> None:
    """Append every material NodeTree from the assets' materials dir
    (render_utils.load_materials semantics: X.blend holds NodeTree X
    with a Color input)."""
    import bpy

    for fn in sorted(os.listdir(material_dir)):
        if fn.endswith(".blend"):
            name = os.path.splitext(fn)[0]
            bpy.ops.wm.append(
                filename=os.path.join(material_dir, fn, "NodeTree", name)
            )


def append_shape(shapes_dir: str, shape_name: str, new_name: str,
                 scale: float, location) -> str:
    """Append $shape_name from $shapes_dir/$shape_name.blend, rename, and
    place it (render_utils.add_object semantics: the .blend holds one
    unit-size origin-centered object of the same name)."""
    import bpy

    count = sum(1 for o in bpy.data.objects if o.name.startswith(shape_name))
    bpy.ops.wm.append(
        filename=os.path.join(shapes_dir, f"{shape_name}.blend", "Object",
                              shape_name)
    )
    unique = f"{shape_name}_{count}_{new_name}"
    bpy.data.objects[shape_name].name = unique
    obj = bpy.data.objects[unique]
    bpy.context.view_layer.objects.active = obj
    obj.select_set(True)
    bpy.ops.transform.resize(value=(scale, scale, scale))
    x, y, z = location
    bpy.ops.transform.translate(value=(x, y, scale + z))
    return unique


def attach_group_material(obj, group_name: str, **inputs) -> None:
    """New material on obj whose surface is the named preloaded node
    group; sets any named group inputs (render_utils.add_material)."""
    import bpy

    mat = bpy.data.materials.new(name=f"Material_{len(bpy.data.materials)}")
    mat.use_nodes = True
    obj.data.materials.append(mat)
    output_node = next(
        n for n in mat.node_tree.nodes if n.name == "Material Output"
    )
    group_node = mat.node_tree.nodes.new("ShaderNodeGroup")
    group_node.node_tree = bpy.data.node_groups[group_name]
    for inp in group_node.inputs:
        if inp.name in inputs:
            inp.default_value = inputs[inp.name]
    mat.node_tree.links.new(
        group_node.outputs["Shader"], output_node.inputs["Surface"]
    )


def set_material_inputs(material, **inputs) -> None:
    """Update named inputs on the material's shader group node
    (render_utils.change_material)."""
    group_node = material.node_tree.nodes[-1]
    for inp in group_node.inputs:
        if inp.name in inputs:
            inp.default_value = inputs[inp.name]


def attach_image_texture(obj_name: str, image_path: str) -> None:
    """Diffuse image-texture material on the named object
    (render_utils.add_texture)."""
    import bpy

    obj = bpy.data.objects[obj_name]
    mat = bpy.data.materials.new("TextureMat")
    mat.use_nodes = True
    nodes, links = mat.node_tree.nodes, mat.node_tree.links
    nodes.clear()
    out = nodes.new("ShaderNodeOutputMaterial")
    diff = nodes.new("ShaderNodeBsdfDiffuse")
    tex = nodes.new("ShaderNodeTexImage")
    coords = nodes.new("ShaderNodeTexCoord")
    tex.image = bpy.data.images.load(image_path)
    links.new(out.inputs["Surface"], diff.outputs["BSDF"])
    links.new(diff.inputs["Color"], tex.outputs["Color"])
    links.new(tex.inputs["Vector"], coords.outputs["Generated"])
    obj.data.materials.append(mat)


def _apply_cycles_settings(settings: Dict) -> None:
    import bpy

    scene = bpy.context.scene
    render = scene.render
    render.engine = settings["engine"]
    render.resolution_x = settings["resolution_x"]
    render.resolution_y = settings["resolution_y"]
    render.resolution_percentage = settings["resolution_percentage"]
    # tile_x/tile_y were removed in Blender 3.0 (adaptive tiling)
    if hasattr(render, "tile_x"):
        render.tile_x = settings["tile_x"]
        render.tile_y = settings["tile_y"]
    cycles = scene.cycles
    cycles.samples = settings["samples"]
    cycles.transparent_min_bounces = settings["transparent_min_bounces"]
    cycles.transparent_max_bounces = settings["transparent_max_bounces"]
    cycles.blur_glossy = settings["blur_glossy"]
    cycles.max_bounces = settings["max_bounces"]
    bpy.data.worlds["World"].cycles.sample_as_light = settings["sample_as_light"]
    for layer in scene.view_layers:
        layer.cycles.use_denoising = settings["use_denoising"]
    if settings["device"] == "GPU":
        cycles.device = "GPU"
        prefs = bpy.context.preferences.addons["cycles"].preferences
        prefs.compute_device_type = "CUDA"
        for devices in prefs.get_devices():
            for d in devices:
                d.use = d.type != "CPU"


def build_scene(
    assets_dir: str,
    shape_names: List[str],
    material_names: List[str],
    include_lights: bool = True,
    ground_texture: Optional[str] = None,
    settings: Optional[Dict] = None,
) -> Dict:
    """Build the full 3DIdent scene from the published assets: open the
    base blendfile, configure Cycles, add the object(s) + tracked
    spotlight(s), and replace the ground. Returns the executed plan.

    Mirrors initialize_renderer + add_objects_and_lights
    (generate_clevr_dataset_images.py:61-232)."""
    import bpy

    plan = scene_plan(shape_names, material_names, include_lights,
                      ground_texture)
    settings = settings or cycles_settings()

    base_scene = os.path.join(
        assets_dir, "data", "scenes", "base_scene_equal_xyz.blend"
    )
    bpy.ops.wm.open_mainfile(filepath=base_scene)
    load_material_nodegroups(os.path.join(assets_dir, "data", "materials"))
    _apply_cycles_settings(settings)

    shapes_dir = os.path.join(assets_dir, "data", "shapes")
    for entry in plan["objects"]:
        scene_name = append_shape(
            shapes_dir, entry["shape"], entry["name"], entry["scale"],
            entry["location"],
        )
        obj = bpy.data.objects[scene_name]
        obj.data.materials.clear()
        attach_group_material(obj, entry["material"], Color=entry["color"])

        spot = entry.get("spotlight")
        if spot:
            light = bpy.data.lights.new(name=spot["name"], type="SPOT")
            light.energy = spot["energy"]
            light.shadow_soft_size = spot["shadow_soft_size"]
            light.spot_size = spot["spot_size"]
            light.spot_blend = spot["spot_blend"]
            light.falloff_type = spot["falloff_type"]
            if hasattr(light, "contact_shadow_distance"):
                light.contact_shadow_distance = spot["contact_shadow_distance"]
            light_obj = bpy.data.objects.new(name=spot["name"],
                                             object_data=light)
            bpy.context.collection.objects.link(light_obj)
            light_obj.location = spot["location"]
            ttc = light_obj.constraints.new(type="TRACK_TO")
            ttc.target = bpy.data.objects[scene_name]
            ttc.track_axis = "TRACK_NEGATIVE_Z"
            ttc.up_axis = "UP_X"
            bpy.context.evaluated_depsgraph_get().update()

    # ground: texture, or a fresh grey Rubber plane under the objects
    ground = plan["ground"]
    if ground.get("texture"):
        attach_image_texture("Ground", ground["texture"])
    else:
        max_h = max(
            max(o.dimensions)
            for o in bpy.data.objects
            if "Object_" in o.name
        )
        bpy.data.objects.remove(bpy.data.objects["Ground"], do_unlink=True)
        bpy.ops.mesh.primitive_plane_add(
            size=ground["plane_size"], location=(0, 0, -max_h)
        )
        bpy.context.object.name = "Ground"
        plane = bpy.data.objects["Ground"]
        plane.select_set(True)
        bpy.context.view_layer.objects.active = plane
        attach_group_material(plane, ground["material"],
                              Color=ground["color"])
    return plan


def segmentation_plan(n_objects: int) -> Dict:
    """Pure description of the segmentation-material assignment
    (generate_clevr_dataset_images.py:176-186 + render_utils.py:221-242):
    one material per segmentation index, ground takes index 0, object i
    takes index i+1; the per-index colors come from the NodeGroup's
    ColorRamp elements."""
    return {
        "n_materials": n_objects + 1,
        "ground_index": 0,
        "object_indices": {f"Object_{i}": i + 1 for i in range(n_objects)},
        "group_inputs": [
            # (input slot 0 = segmentation index, slot 1 = n_objects)
            {"index": i, "n_objects": n_objects}
            for i in range(n_objects + 1)
        ],
    }


def build_segmentation_materials(assets_dir: str, n_objects: int):
    """Load data/node_groups/NodeGroup.blend and build the per-index
    segmentation materials + colors
    (generate_clevr_dataset_images.py:86-95,176-186): the blendfile
    holds a material whose "Group" node has inputs (segmentation index,
    object count) and a ColorRamp node whose elements define the flat
    per-index colors. Returns (materials, colors) with materials[0] for
    the ground and materials[i+1] for Object_i."""
    import bpy

    segm_node_path = os.path.join(
        assets_dir, "data", "node_groups", "NodeGroup.blend"
    )
    with bpy.data.libraries.load(segm_node_path) as (data_from, data_to):
        data_to.objects = data_from.objects
        data_to.materials = data_from.materials
        data_to.node_groups = data_from.node_groups
    segm_node_mat = data_to.materials[0]
    ramp_elems = data_to.node_groups[0].nodes["ColorRamp"].color_ramp.elements

    plan = segmentation_plan(n_objects)
    group = segm_node_mat.node_tree.nodes["Group"]
    materials, colors = [], []
    for entry in plan["group_inputs"]:
        group.inputs[1].default_value = entry["n_objects"]
        group.inputs[0].default_value = entry["index"]
        materials.append(segm_node_mat.copy())
        colors.append(list(ramp_elems[entry["index"]].color))
    return materials, colors


def segm_output_path(render_filepath: str) -> str:
    """``*_segm.png`` path next to an RGB render (the segmentation
    pass's output naming contract — kept as a pure function so the
    resumable render loop can test frame completeness bpy-free)."""
    base, ext = os.path.splitext(render_filepath)
    return base + "_segm" + ext


def render_segmentation_pass(object_names: List[str], segm_materials,
                             render_filepath: str) -> str:
    """Swap every object's material for its segmentation material, render
    a *_segm.png next to render_filepath, then restore
    (render_utils.render_segmentation, simplified to the used path)."""
    import bpy

    segm_path = segm_output_path(render_filepath)
    scene = bpy.context.scene
    prev_path = scene.render.filepath
    scene.render.filepath = segm_path

    saved = {}
    all_names = ["Ground"] + list(object_names)
    for i, name in enumerate(all_names):
        obj = bpy.data.objects[name]
        saved[name] = list(obj.data.materials)
        obj.data.materials.clear()
        obj.data.materials.append(segm_materials[i])
    try:
        bpy.ops.render.render(write_still=True)
    finally:
        for name, mats in saved.items():
            obj = bpy.data.objects[name]
            obj.data.materials.clear()
            for m in mats:
                obj.data.materials.append(m)
        scene.render.filepath = prev_path
    return segm_path
