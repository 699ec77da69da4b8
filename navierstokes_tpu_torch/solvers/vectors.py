"""The vector space the Krylov methods run in: one tensor, or shards.

On one device a Krylov vector is one tensor.  The distributed solver
(`parallel/distributed.py`) splits every vector into row blocks, one per
shard, each on its shard's device: a `Shards`.  GMRES and CA-GMRES
(`solvers/gmres.py`, `solvers/sstep.py`) take either through the functions
here; for a tensor each is the torch expression the single-device solver
always ran, so that path is unchanged bit for bit.

For shards, elementwise arithmetic runs shard by shard.  Every global
reduction (a norm, each CGS2 pass's inner products) is the sum of the
per-shard partials, taken on the first shard's device in shard order and
copied back where the shards need it, and the tall-skinny QR stacks the
per-shard R factors there in shard order: no atomics and no order that
depends on timing, so two runs repeat bit for bit.  Nothing here joins
the shards into one vector.
"""

from __future__ import annotations

import torch


class Shards:
    """A vector (or a stack of vectors: a Krylov basis, a column block) cut
    into row blocks, `parts[s]` on shard s's device.  Rows are the last axis
    of a vector and of a basis's rows, the first axis of a column block."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The first shard's device: where reductions land."""
        return self.parts[0].device

    def _zip(self, other, op):
        if isinstance(other, Shards):
            return Shards(op(a, b) for a, b in zip(self.parts, other.parts))
        if isinstance(other, torch.Tensor):
            return Shards(op(a, other.to(a.device)) for a in self.parts)
        return Shards(op(a, other) for a in self.parts)

    def __add__(self, other):
        return self._zip(other, torch.add)

    def __sub__(self, other):
        return self._zip(other, torch.sub)

    def __mul__(self, other):
        return self._zip(other, torch.mul)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._zip(other, torch.div)

    def __getitem__(self, index):
        return Shards(a[index] for a in self.parts)

    def __setitem__(self, index, value):
        for a, v in zip(self.parts, value.parts):
            a[index] = v

    def clone(self):
        return Shards(a.clone() for a in self.parts)

    def zero_(self):
        for a in self.parts:
            a.zero_()
        return self


def shard_sum(partials) -> torch.Tensor:
    """The sum of per-shard partials, on the first one's device, in shard
    order."""
    home = partials[0].device
    total = partials[0]
    for p in partials[1:]:
        total = total + p.to(home)
    return total


def zeros_like(v):
    if isinstance(v, Shards):
        return Shards(torch.zeros_like(a) for a in v.parts)
    return torch.zeros_like(v)


def norm(v) -> torch.Tensor:
    """The 2-norm, a 0-dim tensor (on the first shard's device)."""
    if isinstance(v, Shards):
        return torch.sqrt(shard_sum([a @ a for a in v.parts]))
    return torch.linalg.norm(v)


def divide_into(out, v, s: torch.Tensor) -> None:
    """out = v / s, written in place: one kernel into `out` (a basis row),
    no copy after it (a copy would be one more node of a CUDA graph).  s is
    0-dim, on the first shard's device."""
    if isinstance(out, Shards):
        for o, a in zip(out.parts, v.parts):
            torch.div(a, s.to(a.device), out=o)
    else:
        torch.div(v, s, out=out)


def basis(rows: int, like):
    """A zero Krylov basis of `rows` vectors shaped like `like`."""
    if isinstance(like, Shards):
        return Shards(torch.zeros((rows, a.shape[0]), dtype=a.dtype,
                                  device=a.device) for a in like.parts)
    return torch.zeros((rows, like.shape[0]), dtype=like.dtype,
                       device=like.device)


def cgs2(V, w, k: int) -> tuple:
    """Classical Gram-Schmidt, twice, of w against the basis rows 0..k:
    (w projected, h = h1 + h2), through GEMVs."""
    if not isinstance(V, Shards):
        Vk = V[:k + 1]                   # the live rows 0..k
        h1 = Vk @ w
        w = w - Vk.T @ h1
        h2 = Vk @ w
        w = w - Vk.T @ h2
        return w, h1 + h2
    hs = []
    for _ in range(2):
        h = shard_sum([a[:k + 1] @ b for a, b in zip(V.parts, w.parts)])
        w = Shards(b - a[:k + 1].T @ h.to(a.device)
                   for a, b in zip(V.parts, w.parts))
        hs.append(h)
    return w, hs[0] + hs[1]


def combine(V, k: int, y: torch.Tensor):
    """V[:k]^T y: the combination of the first k basis rows."""
    if isinstance(V, Shards):
        return Shards(a[:k].T @ y.to(a.device) for a in V.parts)
    return V[:k].T @ y


def columns(cols: list):
    """Vectors -> the column block (n, len(cols))."""
    if isinstance(cols[0], Shards):
        return Shards(torch.stack([c.parts[s] for c in cols], dim=1)
                      for s in range(len(cols[0].parts)))
    return torch.stack(cols, dim=1)


def prepend_column(v, W):
    """[v | W]: a vector before a column block."""
    if isinstance(v, Shards):
        return Shards(torch.cat([a[:, None], b], dim=1)
                      for a, b in zip(v.parts, W.parts))
    return torch.cat([v[:, None], W], dim=1)


def column_norms(W) -> torch.Tensor:
    """The 2-norm of each column of a block (n, m)."""
    if isinstance(W, Shards):
        return torch.sqrt(shard_sum([(a * a).sum(0) for a in W.parts]))
    return torch.linalg.norm(W, dim=0)


def qr(W) -> tuple:
    """The reduced QR of a tall column block.  Shards: the tall-skinny QR,
    a QR per shard, then one of the stacked R factors on the first shard's
    device; each shard's Q is its local Q times its block of that one."""
    if not isinstance(W, Shards):
        return torch.linalg.qr(W)
    home = W.device
    local = [torch.linalg.qr(a) for a in W.parts]
    Q2, R = torch.linalg.qr(torch.cat([r.to(home) for _, r in local]))
    out, row = [], 0
    for q, r in local:
        out.append(q @ Q2[row:row + r.shape[0]].to(q.device))
        row += r.shape[0]
    return Shards(out), R


def apply_columns(Q, m: int, y: torch.Tensor):
    """Q[:, :m] y."""
    if isinstance(Q, Shards):
        return Shards(a[:, :m] @ y.to(a.device) for a in Q.parts)
    return Q[:, :m] @ y
