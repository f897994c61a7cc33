"""Training steps back to back: a closed loop of ``Trainer.train_step``.

Set-up builds one ``Trainer`` on the mix's synthetic site, loads the
benchmark's weights into it and runs its first ``CHECKED`` steps through
the same call and the same draws as the window, recording each step's
loss, the first gradient (from Adam's first moment after one step) and
the parameters after the last; the window then goes on with that same
object.  After the window the plain reference follows the same steps
from the same weights and draws, and ``correct`` compares the two.

Parameters of the mix: ``site`` (views, px, grid, held_out of the
synthetic site) and ``max_train_steps`` (which fixes the phases: the
window stays in phase 1, the DSM prior on).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import bench, inputs, program
from portbench.counts import train_step as step_counts

CHECKED = 3
GHOST_TILE = 2048          # the fused trunk's BatchNorm tile
# a leaf whose reference gradient is below this share of the median
# leaf's moves by Adam's round-off alone (a bias under BatchNorm)
QUIET = 1e-3
# the mix at a CPU test's size, and the window of a control run on the card
SMALL = {"site": {"views": 3, "px": 16, "grid": 16, "held_out": 1}}
CONTROL_SECONDS = 2.0


def _optimizer_grads(tr) -> dict:
    """The first step's gradient of every leaf, from Adam's first moment
    ``(1 - beta1) g`` after one step (zero where Adam holds none)."""
    out = {}
    leaves = dict(tr.model.named_parameters())
    for group, lat in tr.ada_params.items():
        leaves.update({f"{group}.{k}": v for k, v in lat.items()})
    for opt in (tr.optimizers.net, tr.optimizers.ada):
        for p, st in opt.state.items():
            name = next(k for k, v in leaves.items() if v is p)
            out[name] = (st["exp_avg"] / (1 - opt.defaults["betas"][0])
                         ).detach().clone()
    for k, v in leaves.items():
        out.setdefault(k, torch.zeros_like(v))
    return out


def _stats(tr) -> dict:
    """The trunk BatchNorms' running statistics."""
    return {k: v.detach().clone() for k, v in tr.model.named_buffers()
            if k.endswith(("running_mean", "running_var"))}


def _leaves(tr) -> dict:
    out = {k: v.detach().clone() for k, v in tr.model.named_parameters()}
    for group, lat in tr.ada_params.items():
        out.update({f"{group}.{k}": v.detach().clone()
                    for k, v in lat.items()})
    return out


def setup(run):
    from season_nerf_torch.data.rays import RayTable
    from season_nerf_torch.train.engine import Trainer
    c, t = run.config, run.traffic
    rows, prior = inputs.make_site(run.seed, **t["site"])
    cfg = program.port_config(c, max_train_steps=t["max_train_steps"],
                              n_saves=0, logs_dir="", jump_start=True,
                              seed=0)
    table = RayTable(rows, np.zeros(len(rows), np.int32), ["site"],
                     np.zeros((1, 2), np.int32),
                     rows[:1, 11:14].astype(np.float64),
                     rows[:1, 14:18].astype(np.float64))
    draws = inputs.StepDraws(run.seed, len(rows), c["batch_size"],
                             c["n_samples"], run.device)
    run.mark("site drawn")
    tr = Trainer(cfg, table, prior_hm=prior, device=run.device, draws=draws)
    run.mark("trainer built")
    weights = inputs.make_weights(program.state_shapes(cfg), run.seed,
                                  run.device)
    tr.model.load_state_dict(weights)
    run.mark("weights loaded")
    run.faults.get("train", lambda tr: None)(tr)
    losses = []
    for step in range(CHECKED):
        with run.spans("train_step"):
            losses.append({k: float(v) for k, v in tr.train_step().items()})
        if step == 0:
            grads = _optimizer_grads(tr)
    after = _leaves(tr)
    before = {k: weights[k] for k in after if k in weights}
    before.update({k: torch.zeros_like(v) for k, v in after.items()
                   if k not in weights})
    run.program = tr
    run.inputs = {"rows": rows, "prior": prior, "weights": weights,
                  "draws": draws}
    run.readings = {"loss": losses, "grad": grads,
                    "delta": {k: after[k] - before[k] for k in after},
                    "stats": {k: v - weights[k]
                              for k, v in _stats(tr).items()}}


def window(run):
    tr, c = run.program, run.config
    sync = (lambda: torch.cuda.synchronize(run.device)) \
        if run.device.type == "cuda" else (lambda: None)
    steps = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        with run.spans("train_step"):
            tr.train_step()
        steps += 1
    sync()
    wall = time.perf_counter() - t0
    run.window_span = (t0, t0 + wall)
    rays = steps * c["batch_size"]
    run.attempted, run.failed = steps, 0
    run.work = {"steps": steps, "wall_s": wall, "rays": rays,
                "step_flops": step_counts.step_flops(c)}
    run.end_to_end["train_rays_per_s"] = (rays / wall, "rays/s")


def release(run):
    program.free(run)


def reference(run, precision: str) -> dict:
    """The plain reference's readings of the checked steps."""
    from portbench.reference.model import Net, state_from, strict_f32
    from portbench.reference.train import (ALPHA, COLOR, Adam, Adaptive,
                                           onecycle, phase1_loss)
    c, inp, dev = run.config, run.inputs, run.device
    learned = set(run.readings["grad"]) & set(inp["weights"])
    p = state_from(inp["weights"], dev, learned)
    net = Net(p, n_layers=c["fc_layers"], precision=precision,
              bn="ghost" if c.get("pallas_trunk") else "full",
              tile=GHOST_TILE)
    color = Adaptive(3, dev, **COLOR)
    alpha = Adaptive(1, dev, **ALPHA)
    leaves = {k: p[k] for k in sorted(learned)}
    latents = {"color.latent_alpha": color.latent_alpha,
               "color.latent_scale": color.latent_scale,
               "alpha.latent_alpha": alpha.latent_alpha,
               "alpha.latent_scale": alpha.latent_scale}
    opt, opt_ada = Adam(leaves.values()), Adam(latents.values())
    rows = torch.from_numpy(inp["rows"]).to(dev)
    prior = torch.from_numpy(inp["prior"]).to(dev)
    phase_end = int(0.2 * run.traffic["max_train_steps"])
    lr, lr_ada = c["lr"], c["lr"] * c["lr_alpha_scale"]
    losses, grads = [], {}
    with strict_f32(tf32=precision == "tf32"):
        for step in range(CHECKED):
            d = inp["draws"](step)
            total, terms = phase1_loss(
                net, color, alpha, inputs.columns(rows[d["idx"]]), d, step,
                prior, c["n_samples"], phase_end, c["sc_lambda"])
            total.backward()
            losses.append({"Total": float(total.detach()),
                           **{k: float(v) for k, v in terms.items()}})
            if step == 0:
                grads = {k: (v.grad.detach().clone() if v.grad is not None
                             else None)
                         for k, v in {**leaves, **latents}.items()}
            opt.step(onecycle(lr, phase_end, step))
            opt_ada.step(onecycle(lr_ada, phase_end, step))
    delta = {k: v.detach() - inp["weights"][k] for k, v in leaves.items()}
    delta.update({k: v.detach().clone() for k, v in latents.items()})
    stats = {k: p[k] - inp["weights"][k] for k in run.readings["stats"]}
    return {"loss": losses, "grad": grads, "delta": delta, "stats": stats}


def _gaps(prog: dict, ref: dict, keep) -> dict:
    """Each leaf's gap between the two sides' norms, over the reference's
    norm of that leaf or of the median leaf, the larger."""
    norms = {k: float(ref[k].norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(prog[k].norm()) - norms[k]) / max(norms[k], med)
            for k in keep}


def _diffs(prog: dict, ref: dict, keep) -> dict:
    """Each leaf's norm of the difference between the two sides, over the
    reference's norm of that leaf or of the median leaf, the larger."""
    norms = {k: float(ref[k].norm()) for k in keep}
    med = float(np.median(list(norms.values())))
    return {k: float((prog[k] - ref[k]).norm()) / max(norms[k], med)
            for k in keep}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers of the checked steps: the worst step's gap of the
    total loss; the worst and the median leaf's gap of the first
    gradient's norm; the worst leaf's gap of the change's norm (leaves the
    reference does not move must not move); and the median BatchNorm
    statistic's norm of the difference between the two sides' changes of
    the running statistics."""
    moved = [k for k, g in ref["grad"].items() if g is not None]
    gnorm = {k: float(ref["grad"][k].norm()) for k in moved}
    med = float(np.median(list(gnorm.values())))
    keep = [k for k in moved if gnorm[k] >= QUIET * med]
    still = [k for k, g in ref["grad"].items() if g is None]
    grad = _gaps(prog["grad"], ref["grad"], moved)
    upd = _gaps(prog["delta"], ref["delta"], keep)
    worst = sorted(grad, key=grad.get, reverse=True)[:3]
    print("worst gradient leaves: " + ", ".join(
        f"{k} {grad[k]:.4g}" for k in worst), file=sys.stderr)
    return {
        "loss_gap": max(abs(a["Total"] - b["Total"]) / abs(b["Total"])
                        for a, b in zip(prog["loss"], ref["loss"])),
        "grad_gap": max(grad.values()),
        "grad_gap_median": float(np.median(list(grad.values()))),
        "update_gap": max(list(upd.values()) + [
            1.0 for k in still if float(prog["delta"][k].norm()) > 0]),
        "stats_diff_median": float(np.median(list(_diffs(
            prog["stats"], ref["stats"], list(ref["stats"])).values()))),
    }


def check(run, modes) -> dict:
    """-> {mode: numbers}: the program's ("program") or the reference's
    at another precision in its place, against the float32 reference."""
    ref = reference(run, "f32")
    dt = run.config["compute_dtype"]
    return {m: compare(run.readings if m == "program" else
                       reference(run, bench.PRECISION[m][dt]), ref)
            for m in modes}
