"""Work of one block-Jacobi diagonal call (``window_block_diag``) on N
observation rows of a (gh, gw) grid with K tangent values a knot:
``j_win`` (2·16·K × N), the window bases (N × 2 int32) and the weights (N)
read, the (gh·gw·K·K) blocks written; for each of the 16 window knots of a
row, the K(K+1)/2 distinct products of its two residual rows, a multiply
and an add each.  (The byte count of ``chip_smoke.py``'s [5] row, frozen
here.)"""


def work(n, gh, gw, k, elem_bytes=4):
    """(bytes, FLOP) of one call."""
    jwin = 2 * 16 * k * n
    return (jwin * elem_bytes + n * 2 * 4 + n * 4 + gh * gw * k * k * 4,
            2 * 2 * 16 * (k * (k + 1) // 2) * n)
