"""Entry: one shape-fitting step through `parallel.sharding.fit_step`.

`fit_step` runs at world 1: set-up starts a one-rank process group
(NCCL on the card, gloo on the CPU) on a free localhost port. The
target is the reference's field (float64, rounded to f32) at the run's
seeded true parameters over the whole image, handed to the program as a
tensor on its device. A request is the parameters {shift, grow} to step
from; the output is the new parameters and the loss, as the program
returns them (host floats, so a step ends with its result on the host).

The check, at each sampled step and at set-up's steps: the reference
works out the loss and its gradient at the step's parameters (the same
target), and the step it would take, p - lr g. A descent drives the
loss and its steps toward 0, and a seeded start may lie next to the
truth, so no share of a step's own loss or step holds the program's
rounding; each gap is measured against the field's scale instead, the
target's root mean square t_rms, which no seed moves:

- loss_gap: |sqrt(loss) - sqrt(loss_ref)| / t_rms, the gap of the root
  mean square residuals; a program whose field errs by e (root mean
  square) reads at most e / t_rms, by the triangle inequality;
- step_gap: by the worst leaf k, |step - step_ref| over
  2 lr t_rms rms(dd/dk), the step that a residual as large as the
  field would take; the same error e moves it by at most e / t_rms,
  by Cauchy-Schwarz, besides the partials' own rounding.
"""

from __future__ import annotations

import socket

import torch

SAMPLES = 8
#: set-up's steps, run through the same call, all checked
WARM_CHECKED = 3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def setup(c):
    import torch.distributed as dist
    from fidget_tpu_torch.parallel import sharding

    if not dist.is_initialized():
        backend = "nccl" if c.device.type == "cuda" else "gloo"
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            rank=0, world_size=1)
    mesh = sharding.make_mesh(device=c.device)
    W, H = c.cfg["size"]
    ref = c.reference.Reference(c.cfg["scene"], c.device, torch.float64)
    x, y = _points(c)
    target = ref.field(x, y, **c.gen.truth).reshape(H, W).float()
    c.target = target  # the benchmark's input: the check reads it too
    opts = dict(c.entry_cfg.get("options", {}))
    return {"sharding": sharding, "mesh": mesh, "target": target,
            "size": c.port.ImageSize(W, H), "tape": c.tape, "vars": c.vars,
            "opts": opts}


def teardown(prog):
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _points(c):
    """Model (x, y) [H * W] of every pixel, float64 row-major: the
    identity view that `fit_step` renders, the shorter side spanning
    [-1, 1]."""
    W, H = c.cfg["size"]
    s = 2.0 / min(W, H)
    px = torch.arange(W, dtype=torch.float64, device=c.device)
    py = torch.arange(H, dtype=torch.float64, device=c.device)
    wx = (s * px - (W / 2.0) * s)[None, :].expand(H, W)
    wy = (-(s * py - (H / 2.0 - 1.0) * s))[:, None].expand(H, W)
    return wx.reshape(-1), wy.reshape(-1)


def call(prog, req):
    vars_ = prog["vars"]
    params = {vars_[p]: v for p, v in req["params"].items()}
    new, loss = prog["sharding"].fit_step(
        prog["tape"], prog["size"], prog["mesh"], params, prog["target"],
        **prog["opts"])
    return {"params": {p: new[vars_[p]] for p in req["params"]},
            "loss": loss}


def keep(out):
    return out


def _reference_step(c, ref, target, params):
    """(loss, {name: new value}, {name: rms of the partial}) of a step
    in the reference's dtype."""
    x, y = _points(c)
    d, dsh, dgr = ref.field(x, y, params["shift"], params["grow"], grad=True)
    t = target.reshape(-1).to(ref.dtype)
    res = d - t
    loss = (res * res).mean()
    lr = float(c.entry_cfg["options"]["lr"])
    partial = {"shift": dsh, "grow": dgr}
    g = {k: 2 * (res * v).mean() for k, v in partial.items()}
    p = {k: torch.tensor(v, dtype=ref.dtype, device=c.device)
         for k, v in params.items()}
    rms = {k: float(v.square().mean().sqrt()) for k, v in partial.items()}
    return float(loss), {k: float(p[k] - lr * g[k]) for k in p}, rms


def check(c, samples) -> dict:
    ref = c.reference.Reference(c.cfg["scene"], c.device, torch.float64)
    lr = float(c.entry_cfg["options"]["lr"])
    t_rms = float(c.target.double().square().mean().sqrt())
    loss_gap = step_gap = 0.0
    for req, out in samples:
        p = req["params"]
        loss_r, new_r, rms = _reference_step(c, ref, c.target, p)
        gap = abs(max(out["loss"], 0.0) ** 0.5 - loss_r ** 0.5)
        loss_gap = max(loss_gap, gap / t_rms)
        for k in p:
            gap = abs((out["params"][k] - p[k]) - (new_r[k] - p[k]))
            step_gap = max(step_gap, gap / (2 * lr * t_rms * rms[k]))
    return {"loss_gap": loss_gap, "step_gap": step_gap}


def control(c, req):
    """The reference's step in bfloat16 in the program's place."""
    ref = c.reference.Reference(c.cfg["scene"], c.device, torch.bfloat16)
    loss, new, _ = _reference_step(c, ref, c.target, req["params"])
    return {"params": new, "loss": loss}


def _stale(call):
    def f(prog, req):
        out = call(prog, req)
        return {"params": dict(req["params"]), "loss": out["loss"]}
    return f


def _faulty_step(prog, req, fault):
    """`fit_step`'s arithmetic on the program's own pieces (world 1),
    with `fault` planted: "half" forms the loss and its gradient over
    the top half of the rows alone (the mean over those), "altered" adds
    0.1 to one pixel's distance where the renderer produces it."""
    sh = prog["sharding"]
    from fidget_tpu_torch.render.render2d import PixelRenderer
    from fidget_tpu_torch.render.unrolled2d import ready, state

    size, vars_ = prog["size"], prog["vars"]
    H, W = size.height, size.width
    lr = float(prog["opts"]["lr"])
    r = sh._renderer(PixelRenderer, prog["tape"], size, prog["mesh"].device)
    ready(r, [state(r).float_full], "block")
    params = {vars_[p]: v for p, v in req["params"].items()}
    vec = torch.tensor(r._var_vec(params), device=r.device,
                       requires_grad=True)
    mat = torch.as_tensor(r._mat4(None), device=r.device)
    zt = torch.tensor(0.0, dtype=torch.float32, device=r.device)
    rows = H // 2 if fault == "half" else H
    dist_ = sh._dense_rows(r, 0, rows, mat, zt, vec)
    if fault == "altered":
        bump = torch.zeros_like(dist_)
        bump[rows // 2, W // 2] = 0.1
        dist_ = dist_ + bump
    local = ((dist_ - prog["target"][:rows]) ** 2).sum() / (rows * W)
    (g,) = torch.autograd.grad(local, vec)
    new = (vec.detach() - lr * g).tolist()
    idx = r.tape.var_map
    return {"params": {p: new[idx[vars_[p]]] for p in req["params"]},
            "loss": float(local.detach())}


def _planted(fault):
    def wrap(call):
        return lambda prog, req: _faulty_step(prog, req, fault)
    return wrap


FAULTS = {"stale": _stale, "half": _planted("half"),
          "altered": _planted("altered")}
