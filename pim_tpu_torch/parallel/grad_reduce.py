"""The gradient average of the data-parallel train steps.

Shared by `render/diff.py::make_train_step(..., mesh=)` (Adam, the
deployment's step) and `shard.make_sharded_train_step` (plain SGD, the JAX
package's counterpart).  It imports nothing of `render/`, so the render
layer can use it without depending on `shard.py`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pim_tpu_torch.core import profiler as prof
from pim_tpu_torch.parallel.dist import Mesh


class GradReducer:
    """Averages the leaves' gradients and the loss over the mesh, each
    group's all_reduce issued in its index order on every rank, then the
    loss's.  Overlapped (`hooks`): a group's all_reduce starts from its
    post-accumulate-grad hook as soon as its gradient and those of every
    group before it are final, while the backward runs on; serialized (no
    hooks): all start in `finish`.

    While tracing, each all_reduce issued counts in `reduce.calls` and its
    bytes in `reduce.bytes`."""

    def __init__(self, mesh: Mesh, leaves):
        self.mesh = mesh
        self.leaves = leaves
        self.ready = [False] * len(leaves)
        self.works = []

    def _all_reduce(self, t: torch.Tensor):
        prof.count("reduce.calls", 1)
        prof.count("reduce.bytes", t.numel() * t.element_size())
        return dist.all_reduce(t, group=self.mesh.group, async_op=True)

    def hooks(self):
        """The post-accumulate-grad hooks that start the all_reduces (their
        handles, for `remove`)."""
        return [p.register_post_accumulate_grad_hook(lambda _p, i=i: self.start(i))
                for i, p in enumerate(self.leaves)]

    def start(self, i: int) -> None:
        self.ready[i] = True
        while len(self.works) < len(self.leaves) and self.ready[len(self.works)]:
            self.works.append(self._all_reduce(self.leaves[len(self.works)].grad))

    def finish(self, loss: torch.Tensor) -> torch.Tensor:
        """After the backward: every group's gradient replaced in place by
        its mean over the ranks (zeros where no gradient reached a group);
        returns the ranks' mean of `loss`."""
        for i, p in enumerate(self.leaves):
            if p.grad is None:  # no gradient reached this group
                p.grad = torch.zeros_like(p)
            if not self.ready[i]:
                self.start(i)
        loss = loss.detach().clone()
        works = self.works + [self._all_reduce(loss)]
        for w in works:
            w.wait()
        for p in self.leaves:
            p.grad.div_(self.mesh.size)
        return loss / self.mesh.size
