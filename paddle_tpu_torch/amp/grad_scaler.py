"""Loss scaling for AMP — the counterpart of
``paddle_tpu/amp/grad_scaler.py`` (``GradScaler``, alias ``AmpScaler``),
with its semantics: ``scale`` multiplies the loss; ``unscale_`` divides
every gradient by the scale and checks them all for non-finite values;
``step`` unscales (again, after a manual ``unscale_``, as the reference
does), updates unless a value was inf or NaN, and calls ``update``;
``update`` doubles the scale after ``incr_every_n_steps`` good steps in
a row and halves it (never below 1.0) after ``decr_every_n_nan_or_inf``
bad ones.

The finite check is one host read per ``unscale_``: each gradient's
``isfinite().all()`` is reduced on the device and read once. The
reference reads a host bool per gradient (``bool(jnp.all(...))``),
which cannot run inside a trace; here it cannot run inside a CUDA graph
capture, so ``unscale_`` (and so ``step`` and ``minimize``) raise
RuntimeError there: the check is not moved onto the device.
"""

from __future__ import annotations

import torch

from ..device import capturing


class GradScaler:
    def __init__(self, enable: bool = True, init_loss_scaling: float = 2.**15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, optimizer_or_params):
        """Divide every gradient by the scale (rebinding ``p.grad``) and
        record whether any value is inf or NaN. Takes an optimizer or a
        list of parameters (or ``(name, parameter)`` pairs)."""
        if not self._enable:
            return
        if capturing():
            raise RuntimeError(
                "GradScaler.unscale_ reads its finite check on the host, "
                "which a CUDA graph capture cannot do; run the scaled step "
                "eagerly (jit.no_capture()) or without a GradScaler")
        items = (optimizer_or_params
                 if isinstance(optimizer_or_params, (list, tuple))
                 else optimizer_or_params._parameter_list)
        params = [p[1] if isinstance(p, tuple) else p for p in items]
        flags = []
        with torch.no_grad():
            for p in params:
                if p.grad is None:
                    continue
                p.grad = p.grad / self._scale
                flags.append(torch.isfinite(p.grad).all())
        self._found_inf = bool(flags) and not bool(torch.stack(flags).all())

    def step(self, optimizer):
        """minimize-style step honoring found_inf."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, d):
        self._scale = d["scale"]
        self._good_steps = d["good_steps"]
        self._bad_steps = d["bad_steps"]


AmpScaler = GradScaler
