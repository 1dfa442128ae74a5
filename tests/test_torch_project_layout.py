"""Shared memory and launch shape of the projection kernels, on the CPU.

``csrc/project.cu`` stages the grid (and, for ``project_blocks``, its two
frame fields) in shared memory as packed 12-byte knots where they fit one
block, and launches persistent blocks of 256 threads where four fit in one
SM's shared memory, else of 1024.  Where the fields do not fit, the same
kernel reads them from device memory, with no dynamic shared memory, in
blocks of 256.  ``models/central_generic_cuda.py`` mirrors these rules; a
card test (``tests/test_torch_cuda.py``) holds them equal to the library.
"""

import pytest

from camera_calibration_torch import _cuda
from camera_calibration_torch.models import central_generic_cuda as cgc

# (gh, gw, blocks, bytes, threads), the bytes counted by hand.
SMEM_CASES = [
    (16, 16, False, 12 * 16 * 16, 256),      # bench grid: 3,072
    (45, 79, False, 12 * 45 * 79, 256),      # 1080p grid: 42,660
    (68, 68, False, 12 * 68 * 68, 256),      # 55,488: four blocks fit
    (69, 70, False, 12 * 69 * 70, 1024),     # 57,960: four do not
    (139, 139, False, 12 * 139 * 139, 1024),  # largest square: 231,852
    (16, 16, True, 36 * 16 * 16, 256),       # 9,216
    (21, 28, True, 36 * 21 * 28, 256),       # 21,168
    (39, 39, True, 36 * 39 * 39, 256),       # 54,756: four blocks fit
    (40, 40, True, 36 * 40 * 40, 1024),      # 57,600: four do not
    (45, 79, True, 36 * 45 * 79, 1024),      # 127,980
    (80, 80, True, 36 * 80 * 80, 1024),      # largest square: 230,400
]


@pytest.mark.parametrize("gh,gw,blocks,nbytes,threads", SMEM_CASES)
def test_projection_smem_bytes_and_block_size(gh, gw, blocks, nbytes,
                                              threads):
    assert cgc.project_staged(gh, gw, blocks)
    assert cgc.staged_bytes(gh, gw, blocks) == nbytes
    assert cgc.project_smem_bytes(gh, gw, blocks) == nbytes
    assert cgc.threads(gh, gw, blocks) == threads
    _cuda.check_smem(nbytes, "project")


@pytest.mark.parametrize("gh,gw,blocks", [
    (140, 140, False), (113, 172, False), (8, 2500, False),
    (81, 81, True), (45, 144, True), (84, 100, True)])
def test_projection_past_the_block_limit_is_refused(gh, gw, blocks):
    """Past one block's shared memory the staged plan is refused, and the
    kernel reads its fields from device memory instead: no dynamic shared
    memory, blocks of 256 threads."""
    nbytes = cgc.staged_bytes(gh, gw, blocks)
    assert nbytes > _cuda.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        _cuda.check_smem(nbytes, "project")
    assert not cgc.project_staged(gh, gw, blocks)
    assert cgc.project_smem_bytes(gh, gw, blocks) == 0
    assert cgc.threads(gh, gw, blocks) == 256


@pytest.mark.parametrize("blocks,per_knot,largest", [(False, 12, 139),
                                                     (True, 36, 80)])
def test_projection_takes_every_grid_of_the_earlier_kernels(blocks, per_knot,
                                                            largest):
    """Every grid the earlier kernels took (the grid in packed 12-byte knots
    and, for the blocks form, both frame fields beside it) still fits one
    block: up to 139x139 for ``project`` and 80x80 for ``project_blocks``."""
    square = 0
    for gh in range(4, 300):
        for gw in range(4, 60_000):
            if per_knot * gh * gw > _cuda.MAX_SMEM_BYTES:
                break
            nbytes = cgc.project_smem_bytes(gh, gw, blocks)
            assert nbytes <= _cuda.MAX_SMEM_BYTES, (gh, gw)
            if gh == gw:
                square = gh
    assert square == largest


@pytest.mark.parametrize("n,tile,per_sm,sms,launched", [
    (262_144, 256, 4, 132, 512),    # 1024 tiles: 2 per block
    (262_144, 256, 3, 132, 342),    # 3 per block, the last block 1
    (33, 256, 4, 132, 1),
    (256 * 132 * 4 + 1, 256, 4, 132, 265),
    (262_144, 1024, 1, 132, 128),   # 256 tiles: 2 per block
    (1024 * 132, 1024, 1, 132, 132),  # one full wave: 1 tile each
])
def test_projection_launch_blocks(n, tile, per_sm, sms, launched):
    assert _cuda.persistent_blocks(n, tile, per_sm, sms) == launched
    tiles = -(-n // tile)
    per_block = -(-tiles // launched)
    assert launched <= per_sm * sms and (launched - 1) * per_block < tiles
