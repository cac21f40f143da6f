"""Scatters with the JAX package's semantics.

JAX's `.at[i].set(v, mode="drop")` drops writes whose index is out of
range; torch raises instead. `put_drop` gives the JAX result by writing into
a copy with one spare slice that takes the dropped writes and is cut off
again, so nothing is read back to the host to filter the indices.

`add_at` sums values into rows with duplicates. It is `index_put` with
`accumulate=True`, which on a CUDA tensor sorts the indices and sums each
row's values in a fixed order: the sums come out the same from run to run,
unlike atomic adds (`index_add_`). One warp sums each row, so a row that
takes thousands of entries is slow: entries that add nothing (`valid`
False; the JAX package sends them all to row 0) are spread over the rows
instead, where their zeros change no sum.

`mark` is the boolean scatter-max (`.at[i].max(flag)`) as writes of True.
"""

from __future__ import annotations

import torch


def put_drop(t, index, values, dim: int = 0):
    """Copy of `t` with `t[index] = values`, where an index equal to
    `t.shape[dim]` along `dim` drops its write. `index` is what `t[...]`
    takes: one tensor for dim 0, or a tuple whose entry `dim` may hold the
    out-of-range value."""
    ext = torch.cat([t, t.narrow(dim, 0, 1)], dim=dim)
    ext[index] = values
    return ext.narrow(dim, 0, t.shape[dim]).contiguous()


def add_at(t, index, values, valid=None):
    """Copy of `t` with `values` summed into `t[index]`; `index` is a tensor
    or a tuple of tensors (all in range) indexing the leading dimensions.
    Entries where `valid` [E] is False add nothing."""
    if torch.is_tensor(index):
        index = (index,)
    if valid is not None:
        n = valid.shape[0]
        mask = valid.reshape((n,) + (1,) * (values.dim() - 1))
        values = torch.where(mask, values, torch.zeros_like(values))
        spread = torch.arange(n, device=valid.device) % t.shape[0]
        index = (torch.where(valid, index[0], spread),) + tuple(index[1:])
    return t.index_put(index, values, accumulate=True)


def mark(n: int, index, flag, device):
    """[n] bool: True at index[i] where flag[i] (a scatter of logical or).
    Every write is True, so duplicates give the same result in any order."""
    out = torch.zeros((n + 1,), dtype=torch.bool, device=device)
    out[torch.where(flag, index, n)] = True
    return out[:n]
