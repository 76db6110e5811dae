"""Fixture tools of the port (numpy only).

make_synthetic_3dident ← cl_ica_tpu/tools/make_synthetic_3dident.py
make_synthetic_kitti   ← cl_ica_tpu/tools/make_synthetic_kitti.py
"""
