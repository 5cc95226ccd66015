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

from ..models import family
from ..models.roomnet import DEFAULT_CONFIG, RoomNetConfig, forward, normalize_bgr_uint8, update_moving_stats
from ..ops import blocks as B
from ..parallel import collectives as C
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
            generator: torch.Generator | None = None, row_mask: torch.Tensor | None = None, group=None, tp=None):
    """(loss, (logits, bn_stats or None, count)).

    row_mask: optional float (B,) of 1.0 (real row) / 0.0 (padding). Masked
    rows add nothing to the CE, whose mean divides by the real rows, nor to
    the BN batch statistics, so a padded batch computes the loss, gradients
    and statistics of the shrunk batch of its real rows.

    group: a mesh's data group. The loss is then this rank's share of the
    global batch's: its CE sum over the global count of real rows, plus
    L2 / world, so that the shares summed over the ranks are the
    single-device loss, and so are their gradients summed (`make_train_step`).
    `count` is that global count of real rows, before the clamp to one.

    tp: the placements over the mesh's 'model' axis
    (`parallel/tensor.py:TensorParallel`); `train_vars` then holds this
    rank's slices of the split leaves, and the forward applies them. The L2
    that is differentiated takes each split leaf's slice, so its gradient
    stays this rank's; the loss's value adds, detached, the L2 of the other
    ranks' slices (summed over 'model'), so that it is the whole model's.
    """
    variables = schema.unflatten_variables({**train_vars, **frozen_vars}, cfg)
    out = forward(
        variables, x_norm, cfg,
        use_batch_stats=hp.compute_bn_mean_var,
        collect_batch_stats=hp.compute_bn_mean_var and hp.update_bn_moving,
        dropout_rate=hp.dropout_rate if hp.dropout_enabled else None,
        generator=generator if hp.dropout_enabled else None,
        batch_row_mask=row_mask,
        group=group,
        tp=tp,
    )
    logits, bn_stats = out if isinstance(out, tuple) else (out, None)
    ce = F.cross_entropy(logits, y.long(), reduction="none")
    sq = {k: v.float().square().sum() for k, v in train_vars.items()}
    l2 = hp.l2_coeff * 0.5 * torch.stack(list(sq.values())).sum()
    world = C.size(group)
    if tp is not None and tp.axes:
        # The other 'model' ranks' slices: a value without a gradient (a
        # differentiable all-reduce would multiply the slices' L2 gradient
        # by the row's size).
        mine = torch.stack([sq[k] for k in tp.axes]).sum().detach()
        l2 = l2 + hp.l2_coeff * 0.5 * (C.all_reduce_sum(mine, tp.group) - mine)
    # One formula with and without a mask (and the same bits for a mask of
    # ones): the count of real rows is a device tensor either way.
    if row_mask is None:
        ce_sum, local = ce.sum(), ce.new_full((), float(ce.shape[0]))
    else:
        m = row_mask.to(ce.dtype)
        ce_sum, local = (ce * m).sum(), m.sum()
    count = C.all_reduce_sum(local, group)
    return ce_sum / torch.clamp(count, min=1.0) + l2 / world, (logits, bn_stats, count)


def make_train_step(hp: TrainHParams = TrainHParams(), cfg: RoomNetConfig = DEFAULT_CONFIG, *,
                    group=None, tp=None) -> Callable:
    """step(state, x_bgr_uint8, y, generator=None, row_mask=None, *,
    mark=None) -> (state, metrics).

    `generator` (a torch.Generator on the batch's device) draws the dropout
    masks; `row_mask` as in `loss_fn`. A batch with no real row leaves the
    params, the Adam state and the BN moving stats as they were, and only
    the step advances. `mark`, when given, is called with "forward" and
    then "backward" as each part of the step has been issued (a timer
    records a CUDA event there). The forward and backward run with TF32
    off (`blocks.full_f32`), so f32 steps are full f32 on the card.

    `group`, a mesh's data group: the step takes this rank's rows of the
    global batch and computes the single-device step of the global batch,
    as the JAX step jitted over a `P("data")` mesh does. BN moments and the
    real-row count are global (`loss_fn`), the gradients are all-reduced
    with SUM (each rank's is the gradient of its share of the loss), and so
    are the loss and the hits of the metrics. The update, the moving stats
    and the step then come out the same on every rank, with no broadcast.
    Every rank must pass the same shapes and a generator seeded alike.

    `tp`, the placements over the mesh's 'model' axis
    (`parallel/tensor.py:tensor_parallel`), with a state from
    `shard_train_state`: each rank holds its slices of the split leaves and
    of their Adam moments, and the step computes the single-device step of
    the global batch, as the JAX step jitted with `variables_shardings(...,
    tensor_parallel=True)` does. `group` stays the data group: each slice's
    gradient is summed over the ranks that hold the same slice, and Adam,
    the gate and the moving stats run unchanged on the local tensors.
    """
    family.require_roomnet(cfg, "make_train_step")
    opt = _optimizer(hp)

    def step_fn(state: TrainState, x_bgr_uint8, y, generator=None, row_mask=None, *, mark=None):
        params = {k: v.detach().requires_grad_() for k, v in state.train_vars.items()}
        with B.full_f32():
            loss, (logits, bn_stats, count) = loss_fn(params, state.frozen_vars, normalize_bgr_uint8(x_bgr_uint8),
                                                      y, hp, cfg, generator, row_mask, group, tp)
            if mark is not None:
                mark("forward")
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            if mark is not None:
                mark("backward")
        grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
        hits = (logits.detach().argmax(-1) == y).float()
        if row_mask is not None:
            hits = hits * row_mask.float()
        hit_sum, loss = hits.sum(), loss.detach()
        if group is not None:
            # One all-reduce for the gradients and the metrics' sums.
            keys = list(grads)
            flat = C.all_reduce_sum(torch.cat([grads[k].reshape(-1) for k in keys]
                                              + [loss.reshape(1), hit_sum.reshape(1)]), group)
            parts = flat.split([grads[k].numel() for k in keys] + [1, 1])
            grads = {k: p.view_as(grads[k]) for k, p in zip(keys, parts)}
            loss, hit_sum = parts[-2][0], parts[-1][0]
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
        acc = hit_sum / torch.clamp(count, min=1.0)
        if row_mask is not None:
            # A batch with no real row (over every rank) is a state no-op:
            # the masked CE is zero but the L2 gradient, Adam's moments and
            # the BN averages would still move. `where`, not a host-side
            # branch, keeps the step free of a sync, and every rank runs the
            # same collectives.
            has_real = count > 0

            def keep(new: dict, old: dict) -> dict:
                return {k: torch.where(has_real, new[k], old[k]) for k in new}

            train_vars = keep(train_vars, state.train_vars)
            frozen_vars = keep(frozen_vars, state.frozen_vars)
            old = state.opt_state
            opt_state = TF1AdamState(count=torch.where(has_real, opt_state.count, old.count),
                                     mu=keep(opt_state.mu, old.mu), nu=keep(opt_state.nu, old.nu))
        metrics = {"loss": loss, "learn_rate": opt.learning_rate(state.step), "accuracy": acc}
        return TrainState(step=state.step + 1, train_vars=train_vars, frozen_vars=frozen_vars,
                          opt_state=opt_state), metrics

    return step_fn


def make_multi_train_step(hp: TrainHParams = TrainHParams(), cfg: RoomNetConfig = DEFAULT_CONFIG, *,
                          group=None, tp=None) -> Callable:
    """multi_step(state, x[K,B,S,S,3] uint8, y[K,B], generator=None,
    row_mask[K,B]=None) -> (state, metrics): K train steps in one call, the
    same as K calls of `make_train_step`'s step with the same generator.
    The metrics are the last step's plus `mean_loss` over the K."""
    step_fn = make_train_step(hp, cfg, group=group, tp=tp)

    def multi_step_fn(state: TrainState, x_k, y_k, generator=None, row_mask_k=None):
        losses = []
        for i in range(x_k.shape[0]):
            state, metrics = step_fn(state, x_k[i], y_k[i], generator,
                                     None if row_mask_k is None else row_mask_k[i])
            losses.append(metrics["loss"])
        return state, {**metrics, "mean_loss": torch.stack(losses).mean()}

    return multi_step_fn
