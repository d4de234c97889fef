"""Where a plain reference rounds: the configuration's compute dtype, or
the control's lower precision.

``Precision.q`` is applied to each operand of every product in the
references. For the stated precision it is the identity (operands are
already in the compute dtype); for the control it rounds the operand to
float8 e4m3 with a per-tensor scale (the tensor's largest magnitude maps
to e4m3's largest, 448) and back, which is the nearest precision below
bfloat16 that a later change could be tempted to compute in. The
backward pass takes the gradient as if the rounding were not there.
"""
from __future__ import annotations

import dataclasses

import torch

E4M3_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.bfloat16
    fp8: bool = False

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in the compute dtype, rounded as the products see it."""
        return self.q(x.to(self.dtype))

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        amax = x.detach().abs().amax().float().clamp(min=1e-30)
        scale = E4M3_MAX / amax
        y = ((x.detach().float() * scale).to(torch.float8_e4m3fn).float()
             / scale).to(x.dtype)
        return x + (y - x).detach()     # the rounded value, x's gradient


STATED = Precision()
CONTROL = Precision(fp8=True)
