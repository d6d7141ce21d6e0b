"""Plain reference of the `standin2d` configuration, in PyTorch.

The circle field of `scenes/circles2d.py` in closed form, from the
circle list alone: it reads no tape and calls nothing of the program.
`field` gives the distance at model points and, on request, its
derivatives in the shape parameters (shift, grow). Points go through in
blocks, so that a 2048^2 image fits. `dtype` is the precision of every
operation: float64 for the reference, bfloat16 for the control.
"""

from __future__ import annotations

import torch

from ..scenes import circles2d

#: points a block: a block's [points, circles] planes take ~100 MB in f64
BLOCK = 1 << 14


class Reference:
    def __init__(self, scene: dict, device, dtype=torch.float64):
        d = circles2d.draws(scene)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        self.cx, self.cy = t(d["centres"][:, 0]), t(d["centres"][:, 1])
        self.r = t(d["radii"])
        self.clip = torch.as_tensor(d["clipped"], device=device)
        self.dtype, self.device = dtype, device

    def field(self, x, y, shift=0.0, grow=0.0, *, grad=False):
        """d [N] at model points x, y [N] (any float dtype; cast to the
        reference's); with `grad`, also (dd/dshift, dd/dgrow) [N] each."""
        x = x.to(self.dtype).reshape(-1)
        y = y.to(self.dtype).reshape(-1)
        sh = torch.tensor(shift, dtype=self.dtype, device=self.device)
        gr = torch.tensor(grow, dtype=self.dtype, device=self.device)
        out, dsh = [], []
        for i in range(0, x.numel(), BLOCK):
            u = (x[i:i + BLOCK] - sh)[:, None] - self.cx
            v = y[i:i + BLOCK][:, None] - self.cy
            rho = torch.sqrt(u * u + v * v)
            circ = rho - self.r
            band = torch.abs(v) - self.r * 0.5
            f = torch.where(self.clip & (band > circ), band, circ)
            d, k = f.min(dim=1)
            out.append(d - gr)
            if grad:
                # the active circle's term moves with shift; its band
                # term does not
                ku = torch.gather(u, 1, k[:, None])[:, 0]
                krho = torch.gather(rho, 1, k[:, None])[:, 0]
                on_band = (self.clip[k]
                           & (torch.gather(band, 1, k[:, None])[:, 0]
                              > torch.gather(circ, 1, k[:, None])[:, 0]))
                dsh.append(torch.where(on_band, 0.0, -ku / krho))
        d = torch.cat(out)
        if not grad:
            return d
        return d, torch.cat(dsh), torch.full_like(d, -1.0)
