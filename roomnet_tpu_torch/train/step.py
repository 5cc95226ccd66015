"""Loss and train step: sparse CE on ReLU6-clipped logits, L2, TF1 Adam.

Port of roomnet_tpu/train/step.py. The reference loss graph
(network.py:56-69):

  * `sparse_softmax_cross_entropy_with_logits` on the ReLU6-clipped logits;
  * L2 over every trainable tensor, BN gamma and beta included, of
    ``l2_coeff * 0.5 * ||v||^2`` (`tf.nn.l2_loss`), added to the mean CE;
  * TF1 Adam on the exponentially decayed LR; the BN moving averages move
    with the step when enabled (`update_batchnorm_means_vars`, :64-67).

The state is a TrainState of flat {path: tensor} dicts on the device. The
step takes raw uint8 BGR and normalizes it on the device; its forward runs
through the port's kernels under autograd (`models.roomnet.forward`), its
backward is PyTorch's, and the update is `_foreach` ops. Nothing is read
back to the host: the metrics are device tensors. Each step returns new
tensors and leaves the state it was given as it was.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..models.roomnet import DEFAULT_CONFIG, RoomNetConfig, forward, normalize_bgr_uint8, update_moving_stats
from ..ops import blocks as B
from ..params import schema
from .optimizer import TF1AdamState, exponential_decay, tf1_adam


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    """Reference train.py:26-41 constants as a typed config."""

    learn_rate: float = 2e-4
    num_steps: int = 100_000
    l2_coeff: float = 6e-2
    dropout_enabled: bool = False
    dropout_rate: float = 0.35
    compute_bn_mean_var: bool = False  # BN uses batch stats when True
    update_bn_moving: bool = False  # fold moving-average updates when True
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8


class TrainState(NamedTuple):
    step: torch.Tensor  # int32 global step (reference step_ph)
    train_vars: dict[str, torch.Tensor]  # trainable flat dict
    frozen_vars: dict[str, torch.Tensor]  # BN moving stats flat dict
    opt_state: TF1AdamState

    def variables(self, cfg: RoomNetConfig = DEFAULT_CONFIG):
        return schema.unflatten_variables({**self.train_vars, **self.frozen_vars}, cfg)


def _optimizer(hp: TrainHParams):
    return tf1_adam(exponential_decay(hp.learn_rate, hp.num_steps), hp.adam_b1, hp.adam_b2, hp.adam_eps)


def init_train_state(variables, hp: TrainHParams = TrainHParams()) -> TrainState:
    """The state at step 0, on the variables' device. Every tensor is a
    copy, so that nothing a step does reaches the caller's variables."""
    flat = {k: v.detach().clone() for k, v in schema.flatten_tensors(variables).items()}
    train_vars, frozen_vars = schema.partition_flat(flat)
    device = next(iter(flat.values())).device
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=device), train_vars=train_vars,
                      frozen_vars=frozen_vars, opt_state=_optimizer(hp).init(train_vars))


def loss_fn(train_vars, frozen_vars, x_norm, y, hp: TrainHParams, cfg: RoomNetConfig,
            generator: torch.Generator | None = None, row_mask: torch.Tensor | None = None):
    """(loss, (logits, bn_stats or None)).

    row_mask: optional float (B,) of 1.0 (real row) / 0.0 (padding). Masked
    rows add nothing to the CE, whose mean divides by the real rows, nor to
    the BN batch statistics, so a padded batch computes the loss, gradients
    and statistics of the shrunk batch of its real rows."""
    variables = schema.unflatten_variables({**train_vars, **frozen_vars}, cfg)
    out = forward(
        variables, x_norm, cfg,
        use_batch_stats=hp.compute_bn_mean_var,
        collect_batch_stats=hp.compute_bn_mean_var and hp.update_bn_moving,
        dropout_rate=hp.dropout_rate if hp.dropout_enabled else None,
        generator=generator if hp.dropout_enabled else None,
        batch_row_mask=row_mask,
    )
    logits, bn_stats = out if isinstance(out, tuple) else (out, None)
    ce = F.cross_entropy(logits, y.long(), reduction="none")
    l2 = hp.l2_coeff * 0.5 * torch.stack([v.float().square().sum() for v in train_vars.values()]).sum()
    if row_mask is None:
        ce_mean = ce.mean()
    else:
        m = row_mask.to(ce.dtype)
        ce_mean = (ce * m).sum() / torch.clamp(m.sum(), min=1.0)
    return ce_mean + l2, (logits, bn_stats)


def make_train_step(hp: TrainHParams = TrainHParams(), cfg: RoomNetConfig = DEFAULT_CONFIG) -> Callable:
    """step(state, x_bgr_uint8, y, generator=None, row_mask=None, *,
    mark=None) -> (state, metrics).

    `generator` (a torch.Generator on the batch's device) draws the dropout
    masks; `row_mask` as in `loss_fn`. A batch with no real row leaves the
    params, the Adam state and the BN moving stats as they were, and only
    the step advances. `mark`, when given, is called with "forward" and
    then "backward" as each part of the step has been issued (a timer
    records a CUDA event there). The forward and backward run with TF32
    off (`blocks.full_f32`), so f32 steps are full f32 on the card.
    """
    opt = _optimizer(hp)

    def step_fn(state: TrainState, x_bgr_uint8, y, generator=None, row_mask=None, *, mark=None):
        params = {k: v.detach().requires_grad_() for k, v in state.train_vars.items()}
        with B.full_f32():
            loss, (logits, bn_stats) = loss_fn(params, state.frozen_vars, normalize_bgr_uint8(x_bgr_uint8),
                                               y, hp, cfg, generator, row_mask)
            if mark is not None:
                mark("forward")
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            if mark is not None:
                mark("backward")
        grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
        # step=state.step: the schedule follows the global step, not Adam's
        # moment count, so the applied LR and metrics["learn_rate"] agree.
        updates, opt_state = opt.update(grads, state.opt_state, step=state.step)
        keys = list(state.train_vars)
        train_vars = dict(zip(keys, torch._foreach_add([state.train_vars[k] for k in keys],
                                                       [updates[k] for k in keys])))
        frozen_vars = state.frozen_vars
        if bn_stats:
            # The moving-average update (momentum 0.99), the UPDATE_OPS
            # control dependency of network.py:64-67.
            merged = schema.unflatten_variables({**state.train_vars, **frozen_vars}, cfg)
            updated = update_moving_stats(merged, bn_stats, cfg.bn_momentum)
            frozen_vars = schema.partition_flat(schema.flatten_tensors(updated))[1]
        hits = (logits.detach().argmax(-1) == y).float()
        if row_mask is None:
            acc = hits.mean()
        else:
            # A batch with no real row is a state no-op: the masked CE is
            # zero but the L2 gradient, Adam's moments and the BN averages
            # would still move. `where`, not a host-side branch, keeps the
            # step free of a sync.
            has_real = row_mask.sum() > 0

            def keep(new: dict, old: dict) -> dict:
                return {k: torch.where(has_real, new[k], old[k]) for k in new}

            train_vars = keep(train_vars, state.train_vars)
            frozen_vars = keep(frozen_vars, state.frozen_vars)
            old = state.opt_state
            opt_state = TF1AdamState(count=torch.where(has_real, opt_state.count, old.count),
                                     mu=keep(opt_state.mu, old.mu), nu=keep(opt_state.nu, old.nu))
            m = row_mask.float()
            acc = (hits * m).sum() / torch.clamp(m.sum(), min=1.0)
        metrics = {"loss": loss.detach(), "learn_rate": opt.learning_rate(state.step), "accuracy": acc}
        return TrainState(step=state.step + 1, train_vars=train_vars, frozen_vars=frozen_vars,
                          opt_state=opt_state), metrics

    return step_fn


def make_multi_train_step(hp: TrainHParams = TrainHParams(), cfg: RoomNetConfig = DEFAULT_CONFIG) -> Callable:
    """multi_step(state, x[K,B,S,S,3] uint8, y[K,B], generator=None,
    row_mask[K,B]=None) -> (state, metrics): K train steps in one call, the
    same as K calls of `make_train_step`'s step with the same generator.
    The metrics are the last step's plus `mean_loss` over the K."""
    step_fn = make_train_step(hp, cfg)

    def multi_step_fn(state: TrainState, x_k, y_k, generator=None, row_mask_k=None):
        losses = []
        for i in range(x_k.shape[0]):
            state, metrics = step_fn(state, x_k[i], y_k[i], generator,
                                     None if row_mask_k is None else row_mask_k[i])
            losses.append(metrics["loss"])
        return state, {**metrics, "mean_loss": torch.stack(losses).mean()}

    return multi_step_fn
