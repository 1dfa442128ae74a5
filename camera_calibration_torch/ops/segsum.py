"""Segment sums for flat (non-grid) observation tables.

The reference package writes this as a one-hot matmul because scatters are
slow on its accelerator; on a GPU ``index_add_`` is the direct form.  Ids
outside ``[0, num_segments)`` are dropped, as a one-hot row would drop them.
"""

from __future__ import annotations

import torch


def onehot_segment_sum(values, segment_ids, num_segments):
    """segment_sum(values, segment_ids) -> (num_segments,) + values.shape[1:]."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    shape = (num_segments,) + tuple(values.shape[1:])
    out = torch.zeros(shape, dtype=values.dtype, device=values.device)
    keep_b = keep.reshape((-1,) + (1,) * (values.dim() - 1))
    return out.index_add_(0, torch.where(keep, ids, 0),
                          torch.where(keep_b, values, 0.0))
