"""An inverse-rendering trainer's loop: ``make_train_step``'s ``step``
(two renders, the backward of the second, Adam and ``constrain_params``)
once per iteration, on the groups the traffic names.

Inputs from the seed: the trained leaves start at a perturbation of the
true scene's (albedo and emission scaled by [0.5, 1.5]; each distinct
vertex moved by a normal draw of ``vertex_sigma``), and the target is the
true scene's frame, rendered by the program in set-up and worked out
again by the reference.  Set-up runs the first ``check_steps`` steps
through the window's own call; the reference follows them from the same
start and the check compares, per the rules for a training step: each
step's loss, the first gradient (Adam's first moment after one step over
1 - beta1) and the parameters' change after the checked steps, each by
the worst leaf.
"""

from __future__ import annotations

import torch

from .. import program
from ..reference import kajiya as ref
from ..reference import train as ref_train

TARGET_FRAME = 0


class Loop:
    unit = "step"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, scene_fn):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.true = self.scene = scene_fn(cfg["scene"], device)
        g = torch.Generator(device=device).manual_seed(seed % 2**63)
        self.init = ref_train.perturb(self.true, traffic["groups"], g,
                                      float(traffic.get("vertex_sigma", 0.0)))
        self.width, self.height = cfg["film"]
        self.steps = 0
        self.losses = []
        self.log = lambda what: None

    def setup(self) -> None:
        from rvpt_tpu_torch.render import render_sample_fast_chw
        from rvpt_tpu_torch.train.inverse import make_train_step, trainable_params

        w, h = self.width, self.height
        cam = program.port_camera(self.true, w, h)
        st = program.settings(self.cfg["bounces"], self.cfg["style"])
        film = program.film(w, h)
        target = render_sample_fast_chw(program.port_scene(self.true), cam, st, film,
                                        TARGET_FRAME)
        scene = program.port_scene(self.init)
        self.log("target rendered")
        self.step_fn, self.opt = make_train_step(
            scene, cam, st, film, None, target,
            learning_rate=float(self.traffic["learning_rate"]), fast="auto",
            groups=tuple(self.traffic["groups"]))
        self.params = trainable_params(scene, tuple(self.traffic["groups"]))
        self.names = list(self.params)
        beta1 = self.opt.param_groups[0]["betas"][0]
        for i in range(int(self.traffic["check_steps"])):
            self.iterate()
            self.losses.append(float(self.loss))
            self.log(f"step {i}")
            if i == 0:
                # A step that left no first moment gave the optimizer nothing.
                tensors = self.opt.param_groups[0]["params"]
                self.grad1 = {n: self.opt.state[p].get("exp_avg", torch.zeros_like(p))
                              / (1.0 - beta1) for n, p in zip(self.names, tensors)}
        self.after = {n: p.detach().clone() for n, p in
                      zip(self.names, self.opt.param_groups[0]["params"])}
        self.before = {n: v.detach().clone() for n, v in
                       trainable_params(scene, tuple(self.traffic["groups"])).items()}

    def iterate(self) -> None:
        self.params, self.opt, self.loss = self.step_fn(self.params, self.opt,
                                                        self.steps)
        self.steps += 1

    def drain(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def intervals_ms(self) -> list:
        return []

    def frames(self, iterations: int) -> list:
        """The frames of the differentiated render of the last steps."""
        return [2 * i + 4097 for i in range(self.steps - iterations, self.steps)]

    def close(self) -> None:
        del self.step_fn, self.opt, self.params, self.loss

    def check(self, dtype=torch.float32) -> dict:
        """The gaps of ``reference.train.compare``: ``loss_gap``,
        ``grad_gap``, ``delta_gap``."""
        want = ref_train.follow(self.true, self.init, self.cfg, self.traffic,
                                (self.width, self.height), TARGET_FRAME, dtype)
        got = {"losses": self.losses,
               "grad1": ref_train.by_leaf(self.grad1),
               "delta": ref_train.by_leaf({n: self.after[n] - self.before[n]
                                           for n in self.names})}
        return ref_train.compare(got, want)

    def control(self) -> dict:
        """``check``'s readings with the reference in bfloat16 in the
        program's place."""
        film = (self.width, self.height)
        want = ref_train.follow(self.true, self.init, self.cfg, self.traffic, film,
                                TARGET_FRAME)
        got = ref_train.follow(self.true, self.init, self.cfg, self.traffic, film,
                               TARGET_FRAME, torch.bfloat16)
        return ref_train.compare(got, want)

    def census(self, frames) -> list:
        """Per frame, the reference's count of the differentiated trace's
        record slots, on the start's geometry (materials do not change
        which paths are traced; where the vertices train, the count is of
        the start's)."""
        s = self.init
        tab = ref.Tables(s)
        pix = torch.arange(self.width * self.height, device=self.device)
        out = []
        for f in frames:
            c = {}
            with torch.no_grad():
                for i in range(0, pix.shape[0], ref.RAY_CHUNK):
                    p = pix[i:i + ref.RAY_CHUNK]
                    ref.trace(s, tab, ref.torch_rays(s, self.width, self.height, p, f,
                                                     divide=True),
                              p, f, ref.INTEGRATOR_SITE, self.cfg["bounces"],
                              self.cfg["style"], tris_last=s.bvh, census=c)
            out.append({k: sum(v) for k, v in c.items()}
                       | {"rays": int(pix.shape[0]), "bounces": int(self.cfg["bounces"])})
        return out
