"""Work of one J_intr·v call (``window_apply_j``) on N observation rows of
a (gh, gw) grid with K tangent values a knot: ``j_win`` (2·16·K × N) and
the window bases (N × 2 int32) read, the tangent (gh·gw·K) read, the
(N × 2) product written; a multiply and an add per ``j_win`` value.
(The byte count of ``chip_smoke.py``'s [5] row, frozen here.)"""


def work(n, gh, gw, k, elem_bytes=4):
    """(bytes, FLOP) of one call."""
    jwin = 2 * 16 * k * n
    return (jwin * elem_bytes + n * 2 * 4 + gh * gw * k * 4 + n * 2 * 4,
            2 * jwin)
