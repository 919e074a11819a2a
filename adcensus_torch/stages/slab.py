"""How a stage reaches beyond the rows its call owns.

A cross window and a voting region reach ``max_arm`` rows, the
discontinuity adjustment and the out-of-place median one row,
interpolation and the in-place median the whole map. On one card a call
owns the whole map: ``WHOLE`` returns every input as it is, so the
one-card path runs no extra tensor op. The sharded layer
(``parallel/sharded.py:_RowSlab``) passes its rank's padded row slab,
whose methods exchange halos and gather the map.
"""
from __future__ import annotations


class Slab:
    """The whole map. ``real_w``: the image's width where the map is
    padded on the right; ``in_image``: the (rows, W) bool mask of the own
    rows' real pixels (None: the map's width, every pixel)."""

    real_w = None
    in_image = None

    def halo(self, x, rows: int, axis: int = 0):
        """``x`` with ``rows`` rows of the neighbours' on both sides along
        ``axis`` (zeros beyond the image)."""
        return x

    def pad(self, x, rows: int):
        """``x`` with ``rows`` rows of False on both sides: a target."""
        return x

    def own(self, x, rows: int, axis: int = 0):
        """The own rows of a haloed ``x``."""
        return x

    def gather(self, x):
        """The whole map of which ``x`` holds the own rows."""
        return x

    def place(self, x):
        """``x``'s rows in a whole map of False: a target."""
        return x

    def scatter(self, full):
        """The own rows of a whole map, or of one ``crop``-ped (its pad
        then +inf)."""
        return full

    def crop(self, full):
        """A whole map cut to the image."""
        return full

    def mask(self, x, fill):
        """``x`` with ``fill`` outside the image (bool maps: False)."""
        return x

    def interior(self, new, old):
        """``new`` inside the image, ``old`` on its border and beyond."""
        return new


WHOLE = Slab()
