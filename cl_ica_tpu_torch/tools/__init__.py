"""Tools of the port.

make_synthetic_3dident   ← cl_ica_tpu/tools/make_synthetic_3dident.py (numpy)
make_synthetic_kitti     ← cl_ica_tpu/tools/make_synthetic_kitti.py (numpy)
get_mean_std             ← cl_ica_tpu/tools/get_mean_std.py (numpy, PIL)
generate_3dident_latents ← cl_ica_tpu/tools/generate_3dident_latents.py
                           (the port's spaces, on the card by default)
render_3dident, blender_scene ← the same names there (numpy; ``bpy``
                           imported where Blender is needed)
"""
