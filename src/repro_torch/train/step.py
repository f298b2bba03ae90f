"""Training step factory: loss + gradient + clip + AdamW, with the
reference's functional signature (``repro.train.step``)."""

from __future__ import annotations

import torch

from repro_torch.models.model import Model
from repro_torch.optim.adamw import Optimizer
from repro_torch.utils.params import tree_leaves, tree_map


def make_train_step(model: Model, optimizer: Optimizer, remat: bool = True):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    The gradient is ``torch.autograd.grad`` of ``model.loss_fn`` over every
    parameter leaf; a leaf that the loss does not reach raises instead of
    getting no gradient. ``optimizer.update`` then writes the new parameters
    and moments in place (see ``repro_torch.optim.adamw``). metrics: loss,
    nll, grad_norm and lr, as 0-d tensors on the parameters' device.
    """

    def train_step(params, opt_state, batch):
        inputs = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, nll = model.loss_fn(inputs, batch, remat=remat)
        grads = iter(torch.autograd.grad(loss, tree_leaves(inputs)))
        grads = tree_map(lambda _: next(grads), params)
        params, opt_state, om = optimizer.update(grads, opt_state, params)
        return params, opt_state, dict(loss=loss.detach(), nll=nll.detach(), **om)

    return train_step


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params, batch):
        _, nll = model.loss_fn(params, batch, remat=False)
        return dict(nll=nll, ppl=torch.exp(nll))
    return eval_step
