"""cl_ica_tpu_torch.train.checkpoint: the artifact, the LATEST pointer and
what a checkpoint restores. main_mlp's own resume tests are in
test_torch_main_mlp.py."""

import os

import numpy as np
import pytest
import torch

from cl_ica_tpu_torch.models import get_mlp
from cl_ica_tpu_torch.train import (
    load_resume_state,
    make_optimizer,
    save_resume_state,
)

torch.set_num_threads(1)


def test_no_checkpoint_is_none(tmp_path):
    assert load_resume_state(str(tmp_path)) is None
    assert load_resume_state(str(tmp_path / "missing")) is None


def test_round_trip_and_pruning(tmp_path):
    base = str(tmp_path / "resume")
    save_resume_state(base, 21, {"step": 21, "losses": [1.5, 1.25]})
    path, state = load_resume_state(base)
    assert os.path.basename(path) == "state_000000000021.pt"
    assert state == {"step": 21, "losses": [1.5, 1.25]}

    save_resume_state(base, 10**9, {"step": 0, "losses": [1.5, 1.25, 1.0]})
    assert sorted(os.listdir(base)) == ["LATEST", "state_001000000000.pt"]
    assert load_resume_state(base)[1]["losses"] == [1.5, 1.25, 1.0]


def test_pointer_to_a_missing_artifact_is_none(tmp_path):
    base = str(tmp_path)
    save_resume_state(base, 1, {"step": 1})
    os.remove(os.path.join(base, "state_000000000001.pt"))
    assert load_resume_state(base) is None


def test_stray_temporary_files_do_not_move_latest_and_are_cleared(tmp_path):
    base = str(tmp_path)
    save_resume_state(base, 1, {"step": 1})
    stray = os.path.join(base, "state_000000000002.pt.tmp123")
    with open(stray, "wb") as fh:
        fh.write(b"half a checkpoint")
    assert load_resume_state(base)[1] == {"step": 1}
    save_resume_state(base, 3, {"step": 3})
    assert sorted(os.listdir(base)) == ["LATEST", "state_000000000003.pt"]


def test_a_failed_save_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    base = str(tmp_path)
    save_resume_state(base, 1, {"step": 1})

    def failing(obj, path, *a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", failing)
    with pytest.raises(OSError):
        save_resume_state(base, 2, {"step": 2})
    monkeypatch.undo()
    assert load_resume_state(base)[1] == {"step": 1}


@pytest.mark.parametrize("cosine", [False, True])
def test_restored_training_state_continues_bit_for_bit(cosine, tmp_path):
    """Encoder, optimizer, scheduler and generator state through a
    checkpoint: three more updates from the restored state equal the
    three the original takes, exactly."""
    def build():
        f = get_mlp(3, 3, [8, 8], generator=torch.Generator().manual_seed(0))
        opt, sched = make_optimizer(f.parameters(), 1e-2, 0.01,
                                    cosine_steps=10 if cosine else None)
        return f, opt, sched, torch.Generator().manual_seed(1)

    def updates(f, opt, sched, gen, n):
        out = []
        for _ in range(n):
            x = torch.randn(16, 3, generator=gen)
            loss = (f(x) - x).pow(2).mean()
            opt.zero_grad()
            loss.backward()
            opt.step()
            if sched is not None:
                sched.step()
            out.append(float(loss.detach()))
        return out

    f, opt, sched, gen = build()
    updates(f, opt, sched, gen, 4)
    save_resume_state(str(tmp_path), 4, {
        "encoder": f.state_dict(), "optimizer": opt.state_dict(),
        "scheduler": sched.state_dict() if sched else None,
        "generator": gen.get_state()})
    want = updates(f, opt, sched, gen, 3)

    f2, opt2, sched2, gen2 = build()
    _, state = load_resume_state(str(tmp_path))
    f2.load_state_dict(state["encoder"])
    opt2.load_state_dict(state["optimizer"])
    if sched2 is not None:
        sched2.load_state_dict(state["scheduler"])
    gen2.set_state(state["generator"])
    assert updates(f2, opt2, sched2, gen2, 3) == want
    for a, b in zip(f.parameters(), f2.parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
