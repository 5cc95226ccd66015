"""TF1-exact Adam on a continuously decayed learning rate.

Port of roomnet_tpu/train/optimizer.py (reference network.py:36-37, :61-69):

  * LR schedule: `tf.train.exponential_decay(lr0, step, num_steps, 0.068)`,
    staircase=False: ``lr = lr0 * 0.068 ** (step / num_steps)``.
  * `tf.train.AdamOptimizer`, which is not `torch.optim.Adam`: TF1 applies
    ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)`` and then
    ``p -= lr_t * m / (sqrt(v) + eps)``, eps outside the bias correction,
    where torch adds eps to sqrt(v_hat).

The state is flat ``{path: tensor}`` dicts, kept on the device: `update`
reads no value back to the host. Each update makes new tensors (`_foreach`
ops over the whole dict) and leaves its inputs as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch


def exponential_decay(lr0: float, num_steps: int, decay_rate: float = 0.068) -> Callable:
    """The schedule step -> f32 tensor of the continuous decay (network.py:36-37)."""

    def schedule(step):
        t = torch.as_tensor(step).float()
        return lr0 * torch.pow(decay_rate, t / num_steps)

    return schedule


class TF1AdamState(NamedTuple):
    count: torch.Tensor  # int32 update counter (t = 1 on the first update)
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TF1Adam:
    """`tf.train.AdamOptimizer`'s update rule on flat dicts of tensors."""

    learning_rate: float | Callable
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: dict[str, torch.Tensor]) -> TF1AdamState:
        device = next(iter(params.values())).device
        return TF1AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                            mu={k: torch.zeros_like(v) for k, v in params.items()},
                            nu={k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads: dict[str, torch.Tensor], state: TF1AdamState, step=None):
        """(updates, new state): the deltas to add to the params.

        The schedule's clock is `step`, the global step, when given (the
        reference restores it from the checkpoint name, network.py:124, so
        the decay goes on after a params-only restore resets the moments);
        else count - 1. `count` serves the bias correction alone."""
        keys = list(grads)
        g = [grads[k] for k in keys]
        count = state.count + 1
        mu = torch._foreach_add(torch._foreach_mul([state.mu[k] for k in keys], self.b1),
                                torch._foreach_mul(g, 1.0 - self.b1))
        nu = torch._foreach_add(torch._foreach_mul([state.nu[k] for k in keys], self.b2),
                                torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2))
        t = count.float()
        sched_step = count - 1 if step is None else torch.as_tensor(step, device=count.device)
        lr = self.learning_rate(sched_step) if callable(self.learning_rate) else self.learning_rate
        lr_t = lr * torch.sqrt(1.0 - torch.pow(self.b2, t)) / (1.0 - torch.pow(self.b1, t))
        updates = torch._foreach_div(torch._foreach_mul(mu, -lr_t),
                                     torch._foreach_add(torch._foreach_sqrt(nu), self.eps))
        return (dict(zip(keys, updates)),
                TF1AdamState(count=count, mu=dict(zip(keys, mu)), nu=dict(zip(keys, nu))))


def tf1_adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> TF1Adam:
    return TF1Adam(learning_rate, b1, b2, eps)


def flatten_opt_state(state: TF1AdamState) -> dict:
    """TF1AdamState -> {"count", "mu/<path>", "nu/<path>": tensor}, the
    JAX package's checkpoint keys."""
    out = {"count": state.count}
    out.update({f"mu/{k}": v for k, v in state.mu.items()})
    out.update({f"nu/{k}": v for k, v in state.nu.items()})
    return out


def unflatten_opt_state(flat: dict, device=None) -> TF1AdamState:
    """The inverse of `flatten_opt_state`; numpy values (a JAX package
    checkpoint) become tensors on `device`."""

    def tensor(v):
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        return t.to(device) if device is not None else t

    mu = {k[len("mu/"):]: tensor(v) for k, v in flat.items() if k.startswith("mu/")}
    nu = {k[len("nu/"):]: tensor(v) for k, v in flat.items() if k.startswith("nu/")}
    return TF1AdamState(count=tensor(flat["count"]).to(torch.int32), mu=mu, nu=nu)
