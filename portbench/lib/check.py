"""The comparison that decides ``correct`` in a training cell.

Set-up drives the program's own step object until it is captured, puts
the program back where it started (the benchmark's weights copied into
the parameters in place, the optimizer's state zeroed in place, the
generators' states restored: the graph keeps its tensors' addresses), and
takes the three compared steps as replays of that graph, the window's own
call and feed (``compared_steps``). It keeps, on the host: each step's
loss, the first gradient as Adam holds it after step 1 (exp_avg /
(1 - beta1)), and the parameters after step 3, before step 4 moves them.
The plain reference follows the same three steps from the same weights and
batches. Numbers:

- ``loss``: the largest relative gap of a step's loss over the three;
- ``grad1``: over the leaves, the largest gap between the program's and the
  reference's norm of the first gradient, against the reference's norm of
  that leaf or of the median leaf, whichever is larger;
- ``change3``: the same as ``grad1`` for the parameters' change over the
  three steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (Adam moves a leaf whose gradient is
  round-off by round-off alone: a key-bias-like leaf);
- ``grad1_turn_median``: the median over the leaves of 1 − cos of the angle
  between the program's and the reference's first gradient (where rounding
  of cancelling sums sets the gaps of norms, as in bfloat16, or leaves
  them blind to a lower precision, as in the float32 box cell).

Exact checks (limit 0) cover what the reference takes from the program's
own state: ``start`` counts the program's leaves that differ from the
benchmark's weights before step 1; the drivers add ``samples`` (drawn
latents outside their space) and, for 3DIdent, ``matches`` (rows that are
not a nearest rendered latent). ``sample_z`` holds the drawn latents to
their distribution (``reference/latents.py``): the largest |z-score| of
their marginal and conditional statistics against the closed forms.
"""

from __future__ import annotations

import statistics

import torch

from cl_ica_tpu_torch.train.capture import WARMUP_STEPS
from portbench.lib import weights as bench_weights
from portbench.reference.precision import Precision
from portbench.reference.train import follow

GRAD_FLOOR = 1e-3  # of the median leaf's first-gradient norm
SAMPLER_FAULT = 1.5  # the conditional's scale off by half: the planted fault


def _norms(leaves: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gaps(prog: dict, ref: dict, keys=None) -> dict:
    """{leaf: |‖prog_k‖ − ‖ref_k‖| / max(‖ref_k‖, median ‖ref‖)} over ``keys``."""
    if set(prog) != set(ref):
        raise ValueError(f"leaves differ: {sorted(set(prog) ^ set(ref))}")
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    keys = list(ref) if keys is None else keys
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med) if max(rn[k], med) > 0
            else (0.0 if pn[k] == 0 else float("inf")) for k in keys}


def leaf_cosines(prog: dict, ref: dict) -> dict:
    """{leaf: 1 − cos(prog_k, ref_k)}: how far a leaf's direction turned."""
    out = {}
    for k, r in ref.items():
        a, b = prog[k].double().flatten(), r.double().flatten()
        den = float(a.norm() * b.norm())
        if den > 0:
            out[k] = 1.0 - float(a @ b) / den
        else:  # a zero gradient turns fully from a nonzero one
            out[k] = 0.0 if float(a.norm()) == float(b.norm()) == 0 else 1.0
    return out


def worst_leaves(gaps: dict, top: int = 3) -> list:
    """[(leaf, gap)] of the ``top`` largest gaps."""
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:top]


def moved_leaves(grad1_ref: dict) -> list:
    """Leaves whose reference first gradient is at least GRAD_FLOOR of the
    median leaf's."""
    rn = _norms(grad1_ref)
    med = statistics.median(rn.values())
    return [k for k, v in rn.items() if v >= GRAD_FLOOR * med]


def numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of a run: ``prog`` and ``ref`` each hold
    ``losses`` (three floats), ``grad1`` and ``change3`` (leaf dicts)."""
    gaps = [abs(a - b) / abs(b) if a == a else float("inf")  # a NaN loss
            for a, b in zip(prog["losses"], ref["losses"])]
    change = leaf_gaps(prog["change3"], ref["change3"], moved_leaves(ref["grad1"]))
    return {
        "loss": max(gaps),
        "grad1": max(leaf_gaps(prog["grad1"], ref["grad1"]).values()),
        "grad1_turn_median": statistics.median(
            leaf_cosines(prog["grad1"], ref["grad1"]).values()),
        "change3": max(change.values()),
    }


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit], ...]) over the numbers the cell
    gives a limit (a NaN fails its limit)."""
    rows = [[k, float(values[k]), float(limits[k])] for k in limits]
    return all(v <= lim for _, v, lim in rows), rows


class Snapshots:
    """What set-up keeps of the program's first three steps, on the host."""

    def __init__(self):
        self.losses, self.gen_states = [], []
        self.grad1 = self.params3 = None

    @torch.no_grad()
    def take_grad1(self, named_params, optimizer, beta1: float) -> None:
        state = optimizer.state
        self.grad1 = {k: (state[p]["exp_avg"] / (1 - beta1)).cpu()
                      if p in state else torch.zeros(p.shape)
                      for k, p in named_params}

    @torch.no_grad()
    def take_params3(self, named_params) -> None:
        self.params3 = {k: p.detach().to("cpu", torch.float32, copy=True)
                        for k, p in named_params}

    def program(self, params0: dict) -> dict:
        return {"losses": list(self.losses), "grad1": self.grad1,
                "change3": {k: self.params3[k] - params0[k].float().cpu()
                            for k in self.params3}}


def compared_steps(step, named_params, weights: dict, optimizer, generator,
                   beta1: float, device) -> tuple:
    """Warm ``step`` (a ``CapturedStep``) up and capture it, put the program
    back at its start in place, and take the three compared steps as
    replays: (Snapshots, ``start``). ``generator`` is the stream the step
    draws its batches from; its state before each compared step is kept,
    so that the check can draw the batches again."""
    named_params = list(named_params)
    start_state = generator.get_state()
    for _ in range(WARMUP_STEPS + 1):
        step()
    if torch.device(device).type == "cuda" and not step.captured:
        raise RuntimeError("the program's step was not captured in set-up")
    with torch.no_grad():
        bench_weights.load_into(named_params, weights)
        for state in optimizer.state.values():
            for v in state.values():
                if torch.is_tensor(v):
                    v.zero_()
    generator.set_state(start_state)
    start = start_mismatches(named_params, weights)
    snaps = Snapshots()
    for i in range(3):
        snaps.gen_states.append(generator.get_state())
        snaps.losses.append(float(step()[0]))
        if i == 0:
            snaps.take_grad1(named_params, optimizer, beta1)
    snaps.take_params3(named_params)
    return snaps, start


@torch.no_grad()
def start_mismatches(named_params, weights: dict) -> int:
    """Leaves of the program that are not bit-equal to the benchmark's
    weights (or that the weights do not name)."""
    named = dict(named_params)
    bad = set(named) ^ set(weights)
    bad |= {k for k in set(named) & set(weights)
            if named[k].shape != weights[k].shape
            or not torch.equal(named[k].detach(), weights[k].to(named[k].device))}
    return len(bad)


def readings(session, variants=("program",)) -> dict:
    """The numbers of the program's first three steps (``program``), and
    for the limits' readings those of the reference put in the program's
    place at the control's precision (``control``) or on the first half of
    each batch (``half``: half of the batch left out, the mean taken over
    the rest), each against the reference. ``session`` gives
    ``reference_inputs()`` -> (weights, batches, loss_fn, exact numbers),
    ``halve(batch)``, ``snaps``, ``ref_precision``, ``control_precision``
    and ``adam`` (lr, betas, eps). ``frozen``: the reference with a zero
    learning rate in the program's place (a step that leaves its state
    unchanged); ``bf16``: the bfloat16-operand witness; ``sampler``: the
    same draws with the conditional's scale off by SAMPLER_FAULT
    (``session.sampler_fault``); ``detail`` adds the worst leaves of the
    program's gradient and change, and every leaf's turn."""
    params0, batches, loss_fn, exact = session.reference_inputs()
    lr, betas, eps = session.adam
    ref = follow(params0, loss_fn, batches, Precision(session.ref_precision),
                 lr, betas, eps)
    out = {}
    if "program" in variants:
        prog = session.snaps.program(params0)
        out["program"] = {**numbers(prog, ref), **exact}
        if "detail" in variants:
            out["worst"] = {"grad1": worst_leaves(leaf_gaps(prog["grad1"], ref["grad1"])),
                            "change3": worst_leaves(leaf_gaps(prog["change3"],
                                                              ref["change3"])),
                            "turns": worst_leaves(leaf_cosines(prog["grad1"], ref["grad1"]),
                                                  len(ref["grad1"]))}
    if "control" in variants:
        low = follow(params0, loss_fn, batches,
                     Precision(session.control_precision), lr, betas, eps)
        out["control"] = numbers(low, ref)
    if "frozen" in variants:
        frozen = follow(params0, loss_fn, batches, Precision(session.ref_precision),
                        0.0, betas, eps)
        out["frozen"] = numbers(frozen, ref)
    if "bf16" in variants:
        wit = follow(params0, loss_fn, batches, Precision("bf16"), lr, betas, eps)
        out["bf16"] = numbers(wit, ref)
    if "sampler" in variants:
        out["sampler"] = {"sample_z": session.sampler_fault(SAMPLER_FAULT)}
    if "half" in variants:
        half = follow(params0, loss_fn, [session.halve(b) for b in batches],
                      Precision(session.ref_precision), lr, betas, eps)
        out["half"] = numbers(half, ref)
    return out
