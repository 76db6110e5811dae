"""Crash-consistent resume checkpoints.

Port of cl_ica_tpu/train/checkpoint.py:77-119 (``save_resume_state``,
``load_resume_meta``). One artifact per checkpoint holds the whole state
a CLI needs to continue a run step for step: model, optimizer and
scheduler ``state_dict``s, the states of its ``torch.Generator``s, the
phase and step markers and the loss/score histories. It is written with
``torch.save`` under a temporary name and ``os.replace``d into place;
then a small ``LATEST`` pointer is replaced the same way; then older
artifacts are pruned. A crash at any point leaves ``LATEST`` naming a
complete artifact: during the save the previous pair is intact; between
save and pointer update the pointer still names the previous artifact,
which is not pruned yet; during the prune the pointer already names the
new one.

A restore copies into the tensors a captured step reads
(train/capture.py): ``Module.load_state_dict`` copies parameters and
buffers in place, ``CosineLR.load_state_dict`` its count and learning
rate; ``Optimizer.load_state_dict`` replaces the optimizer's state
tensors, so the drivers restore before a step is captured, or reset it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

_PREFIX = "state_"
_SUFFIX = ".pt"


def save_resume_state(base_dir: str, seq: int, state: dict) -> None:
    """Write ``state`` as base_dir/state_<seq>.pt and point LATEST at it."""
    os.makedirs(base_dir, exist_ok=True)
    name = f"{_PREFIX}{int(seq):012d}{_SUFFIX}"
    path = os.path.join(base_dir, name)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)
    pointer_tmp = os.path.join(base_dir, f"LATEST.tmp{os.getpid()}")
    with open(pointer_tmp, "w") as fh:
        fh.write(name)
    os.replace(pointer_tmp, os.path.join(base_dir, "LATEST"))
    for entry in os.listdir(base_dir):
        # older artifacts, and temporary files a crashed save left behind
        if entry.startswith(_PREFIX) and entry != name:
            os.remove(os.path.join(base_dir, entry))


def load_resume_state(base_dir: str) -> Optional[Tuple[str, dict]]:
    """(artifact path, state) of the LATEST complete checkpoint, or None
    when there is none. Tensors load onto the CPU: ``load_state_dict``
    copies them to wherever the module or optimizer lives, and a
    generator's state is a CPU ByteTensor for every device."""
    latest = os.path.join(base_dir, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as fh:
        name = fh.read().strip()
    path = os.path.join(base_dir, name)
    if not os.path.isfile(path):
        return None
    return path, torch.load(path, map_location="cpu", weights_only=True)
