"""The model's float32 casts widened to float64 while its loss and
gradients are taken, the train step around it left as it is: shared by
the CPU parity tests against the reference (``tests/torch_train_parity.py``)
and the card tests (``tests/test_torch_cuda.py``, which import no jax).
"""

import torch

from repro_torch.core import tree as T


class _Given(torch.autograd.Function):
    """``loss`` (in float32) whose gradient with respect to ``leaves`` is
    ``grads``, taken beforehand."""

    @staticmethod
    def forward(ctx, loss, grads, *leaves):
        ctx.grads = grads
        return loss.to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *[g * x for x in ctx.grads])


class WidenedModel:
    """``model`` with ``Tensor.float`` returning float64 while its loss and
    gradients are taken (forward, recompute and backward); the loss is
    returned in float32, as the unwidened model's."""

    def __init__(self, model):
        self.model = model

    def loss(self, params, batch):
        leaves = T.leaves(params)
        narrow, torch.Tensor.float = torch.Tensor.float, torch.Tensor.double
        try:
            loss, metrics = self.model.loss(params, batch)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            torch.Tensor.float = narrow
        return _Given.apply(loss.detach(), grads, *leaves), metrics
