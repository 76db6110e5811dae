"""Experiment CLIs mirroring cl_ica_tpu/cli flag for flag.

main_mlp     ← cl_ica_tpu/cli/main_mlp.py
main_3dident ← cl_ica_tpu/cli/main_3dident.py
main_kitti   ← cl_ica_tpu/cli/main_kitti.py (with kitti_solver, kitti_evaluate)
"""


def fused_arg(args):
    """Map --fused-loss/--no-fused-loss to a use_fused value (None = the
    loss routes by itself: fused on CUDA). --no-fused-loss wins when both
    are passed."""
    if getattr(args, "no_fused_loss", False):
        return False
    if getattr(args, "fused_loss", False):
        return True
    return None
