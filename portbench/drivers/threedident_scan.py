"""Traffic family: main_3dident's unsupervised step under ``--scan``, on one
card, the image store on the device.

The program's own objects, as ``main_3dident._experiment`` builds them for
``--mode unsupervised --scan``: ``parse_args``, ``setup_latent_space``,
``ThreeDIdentBatchSampler``, ``build_encoder``, ``build_split_loss``,
``make_optimizer`` and a ``CapturedStep`` over ``train_step``. The window
runs main_3dident's cadence: ``n_log_steps`` replays, then the host's read
of their losses (its ``flush``). Its evaluation is a
closure inside ``_experiment`` that no caller can reach, so no window
holds it. The benchmark's weights replace the encoder's before the first
step; the data set is the configuration's synthetic one
(``portbench/data/threedident.py``).
"""

from __future__ import annotations

import copy
import math
import time

import torch

from cl_ica_tpu_torch.cli import fused_arg, main_3dident
from cl_ica_tpu_torch.data import ThreeDIdentBatchSampler
from cl_ica_tpu_torch.train import CapturedStep, make_optimizer
from portbench.counts import bn_minres as bn_counts
from portbench.counts import infonce as infonce_counts
from portbench.counts import peaks
from portbench.counts import resnet18 as rn_counts
from portbench.data import threedident as data
from portbench.lib import weights
from portbench.lib.check import compared_steps
from portbench.lib.guard import program_prints
from portbench.lib.timing import Spans, StepEvents, mark, sync
from portbench.lib.trace import traced
from portbench.reference import latents as ref_latents
from portbench.reference import resnet18 as ref_rn
from portbench.reference import threedident as ref_data


class Session:
    def __init__(self, cell: dict, seed: int, device):
        self.cell, self.seed = cell, int(seed)
        self.cfg, self.tr = cell["config_data"], cell["traffic_data"]
        self.device = torch.device(device)
        self.root = data.ensure(self.cfg["data"])
        with program_prints:
            self.args = main_3dident.parse_args(
                ["--offline-dataset", self.root] + list(self.tr["argv"])
                + ["--seed", str(seed)])
        a = self.args
        if (a.lr, a.encoder, a.optimizer) != (self.cfg["lr"], self.cfg["encoder"], "adam"):
            raise ValueError("the traffic's flags disagree with the configuration")
        self.batch = a.batch_size
        self.bf16 = self.tr["precision"] == "bfloat16"
        if a.bf16 != self.bf16:
            raise ValueError("the traffic's precision disagrees with its flags")
        self.ref_precision = "float32"
        self.control_precision = "fp8" if self.bf16 else "tf32"
        self.adam = (self.cfg["lr"], tuple(self.cfg["betas"]), self.cfg["eps"])
        self.n_pos = self.cfg["n_position"]
        self.n_latents = self.n_pos + self.cfg["n_sphere"]
        self.spec = ref_rn.spec(self.n_latents)

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        """The sampler with the store on the device, the model, loss,
        optimizer and captured step, the benchmark's weights, and the
        captured step's first three replays from those weights (kept for
        the check)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False  # as main_3dident.main sets it
        a, dev = self.args, self.device
        mark("imports and data set")
        with program_prints:
            self.latent, n_np, n_ang = main_3dident.setup_latent_space(a)
            if (n_np, n_ang) != (self.n_pos, self.cfg["n_sphere"]):
                raise ValueError("the latent space disagrees with the configuration")
            self.sampler = ThreeDIdentBatchSampler(
                self.root, self.latent, self.batch,
                latent_dimensions_to_use=main_3dident.latent_dims_to_use(a),
                device=dev)
            if self.sampler.device_store is None and dev.type == "cuda":
                raise RuntimeError("the image store is not on the device")
            mark("sampler and store")
            self.model = main_3dident.build_encoder(
                a, self.n_latents, self.n_pos, torch.Generator().manual_seed(self.seed),
                stem_pool=self.cfg["stem_pool"]).to(dev).train()
            self.loss = main_3dident.build_split_loss(a, self.n_pos, use_fused=fused_arg(a))
            params = [p for p in self.model.parameters() if p.requires_grad]
            self.optimizer, scheduler = make_optimizer(params, a.lr, a.weight_decay,
                                                       kind=a.optimizer)
        mark("model")
        if scheduler is not None:
            raise ValueError("a learning-rate schedule would not be restarted")
        w = weights.make(self.spec, self.seed, dev)
        named = list(self.model.named_parameters())
        weights.load_into(named, w)
        self.gen = torch.Generator(device=dev).manual_seed(self.seed)
        model, loss, opt, sampler, gen = (self.model, self.loss, self.optimizer,
                                          self.sampler, self.gen)
        self.step = CapturedStep(
            lambda: main_3dident.train_step(model, loss, opt, scheduler, sampler, gen, None),
            [gen], dev)
        self.snaps, self.start = compared_steps(self.step, named, w, self.optimizer,
                                                self.gen, self.adam[1][0], dev)
        sync(dev)
        mark("capture and three steps")

    # -- the measured window ----------------------------------------------
    def _chunk(self, n: int, events=None) -> int:
        """n replays and main_3dident's flush: the steps whose loss is not
        finite."""
        pending = []
        for _ in range(n):
            pending.append(self.step())
            if events is not None:
                events.mark()
        values = torch.stack(pending).tolist()
        return sum(not math.isfinite(v[0]) for v in values)

    def window(self, seconds: float) -> dict:
        n = self.args.n_log_steps
        events = StepEvents(self.device)
        sync(self.device)
        t0 = time.perf_counter()
        events.mark()
        steps = failed = 0
        while True:
            failed += self._chunk(n, events)
            steps += n
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        elapsed = time.perf_counter() - t0
        return {"seconds": elapsed, "steps": steps, "pairs": steps * self.batch,
                "failed": failed, "step_ms": events.step_ms()}

    # -- the traced run's extras ------------------------------------------
    def traced(self) -> dict:
        steps = int(self.tr["trace_steps"])
        out = traced(lambda: (self._chunk(steps), sync(self.device)), self.device)
        out["steps"] = steps
        out["launches_per_step"] = dict(self.step.per_replay)
        return out

    def spans(self) -> dict:
        """Synchronised spans of eager steps on the run's own objects
        (tools/profile_torch_step.py --3dident's phases)."""
        sp = Spans(self.device)
        b = self.batch
        for _ in range(int(self.tr["span_steps"])):
            sp.start()
            (_, _), (x1, x2) = self.sampler.sample_with_images(self.gen)
            sp.mark("data")
            z = self.model(torch.cat([x1, x2], dim=0))
            sp.mark("backbone_fwd")
            total, _, _ = self.loss(z[:b], z[b:], torch.roll(z[:b], 1, dims=0))
            sp.mark("loss_fwd")
            self.optimizer.zero_grad(set_to_none=True)
            total.backward()
            sp.mark("backward")
            self.optimizer.step()
            sp.mark("optimizer")
        return sp.ms

    def counts(self) -> dict:
        image, b = self.cfg["data"]["image_size"], self.batch
        size = 2 if self.bf16 else 4
        norms = [(2 * b,) + s for s in self.norm_shapes(image)]
        losses = [(b, b, self.n_pos), (b, b, self.cfg["n_sphere"])]
        return {"flops_per_step": rn_counts.step_flops(image, self.n_latents, b),
                "peak_flops": peaks.FLOPS[self.tr["precision"]],
                "loss_bound_s": infonce_counts.step_seconds(losses),
                "bn_bound_s": bn_counts.step_seconds(norms, size)}

    @staticmethod
    def norm_shapes(image: int) -> list:
        """(H, W, C) of each of ResNet18's twenty norms."""
        s = -(-image // 2)
        out = [(s, s, ref_rn.WIDTH)]
        s = -(-s // 2)
        for c_in, f, stride, proj in ref_rn.blocks():
            s = -(-s // stride)
            out += [(s, s, f)] * (3 if proj else 2)
        return out

    # -- the check ----------------------------------------------------------
    def free(self) -> None:
        """The model, optimizer and captured graph go; the sampler stays
        (the batches' rows are drawn again from it)."""
        self.step = self.model = self.optimizer = self.loss = None

    def reference_inputs(self):
        w = weights.make(self.spec, self.seed, self.device)
        tab = torch.as_tensor(ref_data.table(self.root), device=self.device)
        packed = ref_data.store(self.root)
        gen = torch.Generator(device=self.device)
        batches, misses, outside, pairs = [], 0, 0, []
        for state in self.snaps.gen_states:
            gen.set_state(state)
            z, zt = self.latent.sample_pair(gen, self.batch)
            pairs.append((z, zt))
            gen.set_state(state)
            idx_z, idx_zt, _, _ = self.sampler.sample_latent_batch(gen)
            misses += ref_data.nn_misses(tab, z, idx_z)
            misses += ref_data.nn_misses(tab, zt, idx_zt, exclude=idx_z)
            for q in (z, zt):
                outside += ref_data.outside_box(q[:, :self.n_pos], -1.0, 1.0)
                outside += ref_data.off_sphere(q[:, self.n_pos:])
            batches.append({"x1": ref_data.images(packed, idx_z.cpu().numpy(), self.device),
                            "x2": ref_data.images(packed, idx_zt.cpu().numpy(), self.device)})
        n_pos = self.n_pos

        def loss_fn(params, batch, prec):
            return ref_rn.step_loss(params, batch, prec, n_pos, 2.0)

        return w, batches, loss_fn, {"start": self.start, "samples": outside,
                                     "matches": misses,
                                     "sample_z": ref_latents.sample_z(
                                         pairs, self.cfg["latents"])}

    def sampler_fault(self, factor: float) -> float:
        """``sample_z`` of the same draws with the conditionals' scale
        (``--sigma``; the spheres' concentration is its inverse) off by
        ``factor``: a fault planted in the sampler."""
        args = copy.copy(self.args)
        args.sigma = args.sigma * factor
        with program_prints:
            latent = main_3dident.setup_latent_space(args)[0]
        gen = torch.Generator(device=self.device)
        pairs = []
        for state in self.snaps.gen_states:
            gen.set_state(state)
            pairs.append(latent.sample_pair(gen, self.batch))
        return ref_latents.sample_z(pairs, self.cfg["latents"])

    @staticmethod
    def halve(batch: dict) -> dict:
        b = batch["x1"].shape[0] // 2
        return {"x1": batch["x1"][:b], "x2": batch["x2"][:b]}
