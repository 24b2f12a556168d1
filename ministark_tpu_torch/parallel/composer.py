"""The DEEP composer on a rank's share of the LDE rows.

``composer.DeepPolyComposer`` over ``ShardedMatrix`` operands, whose
columns hold the rows j = rank + i d of the LDE: x_i = o g^(rank + i d)
and the weights g^(rank + i d) are the rank's own, kernel A inverts the
rank's (y - x_i), and kernel F's OOD entry point sums over the rank's
rows.  The d partial sums are gathered and added in the field (a
collective's reduction would add int64 words, not mod p); the barycentric
scale keeps the whole domain's N.  The DEEP vector it returns is the
rank's cyclic share, (n / d,) or (3, n / d).
"""

from __future__ import annotations

import torch

from ..composer import DeepPolyComposer
from ..fields import device as fd
from .executor import domain_points
from .sharded import Mesh


class ShardedDeepPolyComposer(DeepPolyComposer):
    """``DeepPolyComposer`` on this rank's rows of the LDEs (see the
    module docstring)."""

    def __init__(self, mesh: Mesh, air, z, base_lde, composition_lde,
                 extension_lde=None):
        super().__init__(air, z, base_lde, composition_lde, extension_lde)
        self.mesh = mesh

    def _points(self, device) -> tuple:
        d = self.mesh.d
        return domain_points(self.lde_dom, self.mesh.rank, d,
                             self.lde_dom.size // d, device)

    def _total(self, sums: torch.Tensor) -> torch.Tensor:
        return fd.sum_mod(self.mesh.all_gather(sums), 0)
