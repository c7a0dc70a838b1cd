"""Adam with the staircase-decayed learning rate, written out.

The JAX package trains with ``optax.adam(exponential_decay(lr,
batches_per_epoch, decay, staircase=True))``: the step's rate is
``lr * decay ** (count // batches_per_epoch)`` on the Adam count before
the update, and the update is ``-rate * m_hat / (sqrt(v_hat) + eps)``
with bias-corrected moments.  This class is that update, with its state
(moments and count) in the open so checkpoints can name it.
"""

from __future__ import annotations

import torch


class Adam:
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8) over ``params`` with the
    staircase rate ``lr * decay ** (count // batches_per_epoch)``."""

    def __init__(self, params, lr: float, decay: float,
                 batches_per_epoch: int, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.decay, self.bpe = lr, decay, batches_per_epoch
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                  for p in self.params]
        self.v = [torch.zeros_like(p, memory_format=torch.contiguous_format)
                  for p in self.params]
        self.count = 0

    def rate(self) -> float:
        """The rate the next update uses (on the count before it)."""
        return self.lr * self.decay ** (self.count // self.bpe)

    @torch.no_grad()
    def step(self, grads) -> None:
        """Apply one update from ``grads`` (in ``params`` order), in
        place."""
        rate = self.rate()
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(rate * (m / bc1) / ((v / bc2).sqrt_() + self.eps))
