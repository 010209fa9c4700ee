"""The Order structure: permutation + supernode ranges.

Equivalent of the reference's ``Order`` struct (``src/order/src/order.h``:
``permtab``, ``peritab``, ``rangtab``, ``cblknbr``) with ``orderCheck``
(order_check.c) and ``orderSave``/``orderLoad`` (order_io.c) —
SURVEY.md section 2 row 2.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class Order:
    """Fill-reducing ordering result.

    permtab[old] = new position; peritab[new] = old position;
    rangtab[k]:rangtab[k+1] is the (new-index) column range of supernode k.
    """

    permtab: np.ndarray  # int64[n]
    peritab: np.ndarray  # int64[n]
    rangtab: np.ndarray  # int64[cblknbr+1]

    @property
    def n(self) -> int:
        return self.permtab.shape[0]

    @property
    def cblknbr(self) -> int:
        return self.rangtab.shape[0] - 1

    def check(self) -> None:
        """orderCheck equivalent: validate permutation + supernode ranges."""
        n = self.n
        if self.peritab.shape[0] != n:
            raise ValueError("peritab size mismatch")
        if not np.array_equal(np.sort(self.permtab), np.arange(n)):
            raise ValueError("permtab is not a permutation")
        if not np.array_equal(self.permtab[self.peritab], np.arange(n)):
            raise ValueError("peritab is not the inverse of permtab")
        r = self.rangtab
        if r[0] != 0 or r[-1] != n or np.any(np.diff(r) <= 0):
            raise ValueError("rangtab must be strictly increasing from 0 to n")

    def save(self, path: str) -> None:
        """orderSave equivalent (npz instead of the reference's text format)."""
        np.savez_compressed(
            path, permtab=self.permtab, peritab=self.peritab, rangtab=self.rangtab
        )

    @classmethod
    def load(cls, path: str) -> "Order":
        """orderLoad equivalent."""
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        z = np.load(path)
        return cls(
            permtab=z["permtab"].astype(np.int64),
            peritab=z["peritab"].astype(np.int64),
            rangtab=z["rangtab"].astype(np.int64),
        )

    @classmethod
    def identity(cls, n: int) -> "Order":
        ar = np.arange(n, dtype=np.int64)
        return cls(permtab=ar.copy(), peritab=ar.copy(), rangtab=np.array([0, n], dtype=np.int64))
