"""Traffic family: main_3dident's unsupervised step under ``--scan`` with
``--encoder rn50``, on one card, the image store on the device.

``threedident_scan``'s session with the names of ResNet18 replaced by
ResNet-50's: the weights' layout and the plain reference
(``reference/resnet50.py``), the operations (``counts/resnet50.py``) and
the norms' shapes of the roofline. The program's objects, the window, the
traced window and the check are that session's.

No eager spans: their steps would run while the captured graph's memory
pool still holds a step's activations, and two step-sized pools of
ResNet-50 at 1024 images do not fit on the card.
"""

from __future__ import annotations

from portbench.counts import bn_minres as bn_counts
from portbench.counts import resnet50 as rn_counts
from portbench.drivers import threedident_scan
from portbench.reference import resnet50 as ref_rn


class Session(threedident_scan.Session):
    def __init__(self, cell: dict, seed: int, device):
        super().__init__(cell, seed, device)
        self.spec = ref_rn.spec(self.n_latents)

    def spans(self) -> dict:
        return {}

    def counts(self) -> dict:
        image, b = self.cfg["data"]["image_size"], self.batch
        size = 2 if self.bf16 else 4
        stem, *norms = [(2 * b,) + s for s in self.norm_shapes(image)]
        # the stem's norm runs bn_stats, bn_bwd and bn_dx; its relu and pool
        # are the argmax-code kernels, not bn_apply
        stem_s = sum(t for k, (t, _) in bn_counts.bounds(stem, size).items()
                     if k != "bn_apply")
        return {**super().counts(),
                "flops_per_step": rn_counts.step_flops(image, self.n_latents, b),
                "bn_bound_s": stem_s + bn_counts.step_seconds(norms, size)}

    @staticmethod
    def norm_shapes(image: int) -> list:
        """(H, W, C) of each of ResNet-50's 53 norms, the stem's first."""
        s = -(-image // 2)
        out = [(s, s, ref_rn.WIDTH)]
        s = -(-s // 2)
        for c_in, f, stride, proj in ref_rn.blocks():
            so = -(-s // stride)
            out += [(s, s, f), (so, so, f), (so, so, ref_rn.EXPANSION * f)]
            if proj:
                out.append((so, so, ref_rn.EXPANSION * f))
            s = so
        return out

    def reference_inputs(self):
        w, batches, _, exact = super().reference_inputs()
        n_pos = self.n_pos

        def loss_fn(params, batch, prec):
            return ref_rn.step_loss(params, batch, prec, n_pos, 2.0)

        return w, batches, loss_fn, exact
