"""The random draws of a training step: from a generator, or one rank's rows
of the draw the single-card step makes for the whole batch.

Scheduled sampling draws its coins (``models.seq2seq.draw_coins``) and noisy
teacher forcing its noise (``models.transformer.draw_noise``) for the batch
the forward is given. Under data parallelism a rank is given its rows of the
global batch; :class:`RankDraw` makes it draw the global batch's coins or
noise from the step's generator and keep its rows, and take the noise scale's
standard deviation over every rank's rows, so that a data-parallel step draws
what the single-card step draws. (JAX's shards reuse one key and scale by
their own rows' deviation, so its shards' draws repeat; ROADMAP.md, known
divergences.)
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import torch

__all__ = ["RankDraw", "rand", "randn", "batch_std"]


class RankDraw(NamedTuple):
    """Rank ``rank`` of ``world`` equal shards of the batch, drawing from
    ``gen``; ``group`` is the process group the ranks share (None: the
    default group)."""

    gen: torch.Generator
    rank: int
    world: int
    group: Any = None


def _generator(rng) -> torch.Generator:
    gen = rng.gen if isinstance(rng, RankDraw) else rng
    if not isinstance(gen, torch.Generator):
        raise TypeError(f"rng must be a torch.Generator, got {type(rng).__name__}")
    return gen


def _draw(fn, rng, shape: Sequence[int], dim: int) -> torch.Tensor:
    gen = _generator(rng)
    if not isinstance(rng, RankDraw):
        return fn(tuple(shape), generator=gen, device=gen.device)
    rows = shape[dim]
    full = list(shape)
    full[dim] = rows * rng.world
    return fn(tuple(full), generator=gen, device=gen.device).narrow(dim, rng.rank * rows, rows)


def rand(rng, shape: Sequence[int], dim: int) -> torch.Tensor:
    """U[0, 1) f32 of ``shape`` on the generator's device, in one call;
    ``dim`` is the batch axis, along which a :class:`RankDraw` keeps its
    rows of the global draw."""
    return _draw(torch.rand, rng, shape, dim)


def randn(rng, shape: Sequence[int], dim: int) -> torch.Tensor:
    """N(0, 1) f32, as :func:`rand`."""
    return _draw(torch.randn, rng, shape, dim)


def batch_std(rng, x: torch.Tensor) -> torch.Tensor:
    """The population standard deviation of ``x``, and under a
    :class:`RankDraw` of more than one rank, of every rank's ``x`` together:
    the mean and then the squared deviations are summed over the ranks by
    ``all_reduce``, as f32 scalars."""
    if not isinstance(rng, RankDraw) or rng.world == 1:
        return x.std(correction=0)
    import torch.distributed as dist

    x = x.float()
    s = torch.stack([x.sum(), torch.tensor(float(x.numel()), device=x.device)])
    dist.all_reduce(s, group=rng.group)
    mean = s[0] / s[1]
    ss = ((x - mean) ** 2).sum()
    dist.all_reduce(ss, group=rng.group)
    return torch.sqrt(ss / s[1])
