"""Traffic family: main_mlp's unsupervised phase, one ``Lane`` on one card.

The program's own objects: ``main_mlp.parse_args`` on the traffic's
flags, ``build_latent_space``, ``make_loss``, a ``Lane`` and its
``start_phase(supervised=False)`` (the ``CapturedStep`` over
``make_synthetic_train_step``), ``train_steps`` and ``Lane.evaluate``.
The window runs main_mlp's cadence: ``n_log_steps`` captured steps, the
host's read of their losses, one evaluation (4096 fresh samples, linear
R² and MCC on the host), and again. The benchmark's weights replace the
mixing's and the encoder's before the first step.
"""

from __future__ import annotations

import copy
import math
import time

import torch

from cl_ica_tpu_torch.cli import main_mlp
from portbench.counts import infonce as infonce_counts
from portbench.counts import mlp as mlp_counts
from portbench.counts import peaks
from portbench.lib import weights
from portbench.lib.check import compared_steps
from portbench.lib.guard import program_prints
from portbench.lib.timing import Spans, StepEvents, mark, sync
from portbench.lib.trace import traced
from portbench.reference import latents as ref_latents
from portbench.reference import mlp as ref_mlp
from portbench.reference import threedident as ref_data

# The Lane draws its frozen mixing by a condition-number search whose length
# depends on its seed (1.2 to 18 s of one CPU core over seeds 1-5). The
# benchmark's weights replace that mixing, so the Lane is built from one
# fixed seed, a search of about 1.2 s (seed 1 above) in every run, and
# its generators are then seeded from --seed.
LANE_SEED = 1


class Session:
    def __init__(self, cell: dict, seed: int, device):
        self.cell, self.seed = cell, int(seed)
        self.cfg, self.tr = cell["config_data"], cell["traffic_data"]
        self.device = torch.device(device)
        with program_prints:
            self.args = main_mlp.parse_args(list(self.tr["argv"]) + ["--seed", str(seed)])
        a, cfg = self.args, self.cfg
        if (a.n, a.n_mixing_layer, a.tau, a.lr) != (cfg["n"], cfg["mixing_layers"],
                                                    cfg["tau"], cfg["lr"]):
            raise ValueError("the traffic's flags disagree with the configuration")
        self.batch, self.p = a.batch_size, float(a.p)
        self.head = self.tr["head"]
        if main_mlp.output_normalization_of(a) != self.head:
            raise ValueError("the traffic's head disagrees with its flags")
        self.ref_precision, self.control_precision = "float64", "tf32"
        self.adam = (cfg["lr"], tuple(cfg["betas"]), cfg["eps"])
        self.mix_spec = ref_mlp.mixing_spec(cfg)
        self.enc_spec = ref_mlp.encoder_spec(cfg, self.head)

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        """The lane, the benchmark's weights, the captured step and its
        first three replays from those weights (kept for the check), and
        one evaluation (its first call warms the host's solvers)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        a = self.args
        mark("imports")
        with program_prints:
            self.latent = main_mlp.build_latent_space(a, self.device)
            self.lane = main_mlp.Lane(a, LANE_SEED, self.device, self.latent,
                                      main_mlp.make_loss(a))
            self.lane.seed = self.seed
            self.lane.train_gen.manual_seed(self.seed)
            self.lane.eval_gen.manual_seed(self.seed + 1)
            self.lane.init_gen.manual_seed(self.seed)
            self.lane.start_phase(False, a.n_steps * a.more_unsupervised)
        if self.lane.scheduler is not None:
            raise ValueError("a learning-rate schedule would not be restarted")
        mark("lane")
        w = weights.make(self.mix_spec + self.enc_spec, self.seed, self.device)
        weights.load_into(self.lane.g.named_buffers(),
                          {k: w[k] for k, *_ in self.mix_spec})
        enc = {k: w[k] for k, *_ in self.enc_spec}
        named = list(self.lane.f.named_parameters())
        weights.load_into(named, enc)
        self.snaps, self.start = compared_steps(
            self.lane.step, named, enc, self.lane.optimizer, self.lane.train_gen,
            self.adam[1][0], self.device)
        mark("capture and three steps")
        with program_prints:
            self.lane.evaluate()
        sync(self.device)
        mark("evaluation")

    # -- the measured window ----------------------------------------------
    def _chunk(self, n: int, events=None) -> None:
        lane = self.lane
        step = lane.step
        if events is not None:
            def marked():
                out = step()
                events.mark()
                return out
            lane.step = marked
        try:
            main_mlp.train_steps([lane], n)
        finally:
            lane.step = step

    def window(self, seconds: float) -> dict:
        n = self.args.n_log_steps
        events = StepEvents(self.device)
        sync(self.device)
        t0 = time.perf_counter()
        events.mark()
        steps = 0
        while True:
            self._chunk(n, events)
            with program_prints:
                self.lane.evaluate()
            steps += n
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        failed = sum(not math.isfinite(v) for v in self.lane.losses[-steps:])
        return {"seconds": elapsed, "steps": steps, "pairs": steps * self.batch,
                "failed": failed, "step_ms": events.step_ms()}

    # -- the traced run's extras ------------------------------------------
    def traced(self) -> dict:
        """One cadence's captured steps and their read-back, traced."""
        steps = int(self.tr["trace_steps"])
        out = traced(lambda: (self._chunk(steps), sync(self.device)), self.device)
        out["steps"] = steps
        out["launches_per_step"] = dict(self.lane.step.per_replay)
        return out

    def spans(self) -> dict:
        """Synchronised spans of eager steps on the lane's own objects
        (tools/profile_torch_step.py's phases), then of evaluations."""
        lane, sp = self.lane, Spans(self.device)
        for _ in range(int(self.tr["span_steps"])):
            sp.start()
            z1, z2 = self.latent.sample_pair(lane.train_gen, self.batch)
            sp.mark("sample")
            with torch.no_grad():
                x1, x2 = lane.g(z1), lane.g(z2)
            h1, h2 = lane.f(x1), lane.f(x2)
            sp.mark("encoder_fwd")
            total, _, _ = lane.loss(z1, z2, None, h1, h2, torch.roll(h1, 1, dims=0))
            sp.mark("loss_fwd")
            lane.optimizer.zero_grad(set_to_none=True)
            total.backward()
            sp.mark("backward")
            lane.optimizer.step()
            sp.mark("optimizer")
        with program_prints:
            for _ in range(int(self.tr["span_evals"])):
                sp.start()
                lane.evaluate()
                sp.mark("eval")
        return sp.ms

    def counts(self) -> dict:
        n = self.cfg["n"]
        shapes = [(self.batch, self.batch, n)]
        return {"flops_per_step": mlp_counts.step_flops(self.cfg, self.batch, self.p),
                "peak_flops": peaks.FLOPS[self.tr["precision"]],
                "loss_bound_s": infonce_counts.step_seconds(shapes)}

    # -- the check ----------------------------------------------------------
    def free(self) -> None:
        """The program's model, optimizer and captured graph go; the latent
        space stays (the batches are drawn again from it)."""
        self.lane = None

    def reference_inputs(self):
        w = weights.make(self.mix_spec + self.enc_spec, self.seed, self.device)
        mix = {k: w[k] for k, *_ in self.mix_spec}
        enc = {k: w[k] for k, *_ in self.enc_spec}
        pairs = self._pairs(self.latent)
        outside = sum(self._outside(z1) + self._outside(z2) for z1, z2 in pairs)
        batches = [{"z1": z1, "z2": z2, "mixing": mix} for z1, z2 in pairs]
        cfg, head, p = self.cfg, self.head, self.p

        def loss_fn(params, batch, prec):
            return ref_mlp.step_loss(params, batch, prec, cfg, head, p)

        return enc, batches, loss_fn, {"start": self.start, "samples": outside,
                                       "sample_z": ref_latents.sample_z(
                                           pairs, [self.tr["space"]])}

    def _pairs(self, latent) -> list:
        """The three compared steps' (z1, z2), drawn again by ``latent``
        from the generator's saved states."""
        gen = torch.Generator(device=self.device)
        out = []
        for state in self.snaps.gen_states:
            gen.set_state(state)
            out.append(latent.sample_pair(gen, self.batch))
        return out

    def sampler_fault(self, factor: float) -> float:
        """``sample_z`` of the same draws with the conditional's scale
        (``--c-param``) off by ``factor``: a fault planted in the sampler."""
        args = copy.copy(self.args)
        args.c_param = args.c_param * factor
        with program_prints:
            latent = main_mlp.build_latent_space(args, self.device)
        return ref_latents.sample_z(self._pairs(latent), [self.tr["space"]])

    def _outside(self, z) -> int:
        space = self.tr["space"]
        if space["kind"] == "box":
            return ref_data.outside_box(z, space["min"], space["max"])
        return ref_data.off_sphere(z, space["r"])

    @staticmethod
    def halve(batch: dict) -> dict:
        b = batch["z1"].shape[0] // 2
        return {"z1": batch["z1"][:b], "z2": batch["z2"][:b], "mixing": batch["mixing"]}
