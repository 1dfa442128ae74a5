"""Work of one projection call (``project``, or ``project_blocks`` with
``blocks=True``) on N points: the directions and warm starts read, the
grid (and, for the blocks form, both frame fields) read once, the outputs
written; the LM loop's FLOP (which depend on how many iterations the
inputs need), the final cost and, for the blocks form, the tail.
(``chip_smoke.projection_work`` and its constants, frozen here.)"""

FLOP_LM_ITERATION = 550
FLOP_FINAL_COST = 160
FLOP_BLOCKS_TAIL = 850


def work(n, grid_bytes, loop_flop, blocks=False):
    """(bytes, FLOP) of one call; ``loop_flop`` is FLOP_LM_ITERATION times
    the loop iterations the N points took in all."""
    if not blocks:
        return (n * (3 + 2) * 4 + grid_bytes + n * (2 + 1) * 4,
                loop_flop + FLOP_FINAL_COST * n)
    return (n * (3 + 2) * 4 + 3 * grid_bytes + n * (2 + 1 + 6 + 64 + 2) * 4,
            loop_flop + (FLOP_FINAL_COST + FLOP_BLOCKS_TAIL) * n)
