"""DEEP polynomial composition in evaluation space (reference:
src/composer.rs), for Fp transcripts (fib) and Fq3 transcripts
(brainfuck).

* OOD evaluations by barycentric interpolation over the LDE coset
  {o*g^i, i<N}:   P(y) = (y^N - o^N)/(N*o^(N-1)) * sum_i e_i*g^i/(y - x_i)
  with one inversion of (y - x_i) for all the distinct OOD points, shared
  by every column.
* The DEEP LDE assembled pointwise by the verifier's quotient formula:
      deep(x_i) = [ sum_t a_t*(ood_t - T_t(x_i)) / (y_t - x_i) ] * (A + B*x_i)
"""

from __future__ import annotations

import torch

from .fields import device as fd
from .fields.scalar import Fp, Fq3, P
from .ntt import powers
from .ops import deep as kdeep


class DeepCompositionCoeffs:
    """(execution_trace alphas, composition_trace alphas, (alpha,beta) degree
    pair) — one alpha per trace argument / composition column
    (src/stark.rs:41-53)."""

    def __init__(self, execution_trace, composition_trace, degree):
        self.execution_trace = list(execution_trace)
        self.composition_trace = list(composition_trace)
        self.degree = degree


def _fp(v) -> int:
    if isinstance(v, Fq3):
        raise TypeError("an Fq3 scalar in an Fp transcript")
    return v.v if isinstance(v, Fp) else int(v) % P


class DeepPolyComposer:
    """Evaluation-space DEEP composer over the natural-order LDEs of the
    base trace, the extension trace (or None) and the composition trace.
    The transcript is Fq3 when the OOD point z is."""

    def __init__(self, air, z, base_lde, composition_lde,
                 extension_lde=None):
        self.air = air
        self.ext = isinstance(z, Fq3)
        self.z = z if self.ext else Fp(_fp(z))
        self.base_lde = base_lde
        self.extension_lde = extension_lde
        self.composition_lde = composition_lde
        self.lde_dom = air.lde_domain()
        self._cache = None

    def _trace_points(self) -> list[tuple[int, int, Fp]]:
        td = self.air.trace_domain()
        pts = []
        for (col, offset) in self.air.trace_arguments():
            gen = td.group_gen if offset >= 0 else td.group_gen_inv
            pts.append((col, offset, self.z * Fp(pow(gen, abs(offset), P))))
        return pts

    def _distinct_points(self):
        """Distinct OOD point keys (insertion order) + values; the
        composition point z^m is always LAST."""
        keys, vals = [], []
        for (_col, off, y) in self._trace_points():
            if ("t", off) not in keys:
                keys.append(("t", off))
                vals.append(y)
        keys.append(("c", 0))
        vals.append(self.z ** self.composition_lde.num_cols)
        return keys, vals

    def _scale_of(self, y):
        """Barycentric prefactor (y^N - o^N) / (N * o^(N-1))."""
        dom = self.lde_dom
        return (y ** dom.size - Fp(dom.offset_pow_size())) / (
            Fp(dom.size) * Fp(pow(dom.offset, dom.size - 1, P)))

    def _trace_column(self, col: int) -> torch.Tensor:
        """Trace column `col`: (n,) base or (3, n) extension values."""
        nb = self.base_lde.num_cols
        if col < nb:
            return self.base_lde.values[col]
        return self.extension_lde.values[col - nb]

    def _points(self, device) -> tuple:
        """(x_i, g^i) at the LDE rows the columns hold: all of them, in
        natural order (``parallel.composer`` takes a rank's share)."""
        dom = self.lde_dom
        return dom.elements(device), powers(dom.group_gen, dom.size, device)

    def _total(self, sums: torch.Tensor) -> torch.Tensor:
        """The OOD sums over every row from the sums over the rows held."""
        return sums

    def get_ood_evals(self):
        """(execution trace OOD evals, composition trace OOD evals)."""
        trace_pts = self._trace_points()
        keys, vals = self._distinct_points()
        dev = self.base_lde.device
        x, gpow = self._points(dev)
        if self.ext:
            ys = fd.ext3_table(vals, dev).reshape(-1, 3, 1)
            invs = fd.ext3_batch_inv(fd.sub(ys, fd.ext3_from_base(x)))
        else:
            ys = torch.tensor([fd.to_i64(y.v) for y in vals],
                              dtype=torch.int64, device=dev)
            invs = fd.batch_inv(fd.sub(ys.reshape(-1, 1), x))

        # one pair (point, column) per trace argument's column at its
        # point, then the composition columns at z^m
        ncomp = self.composition_lde.num_cols
        cols = [self._trace_column(c) for c in range(
            self.base_lde.num_cols
            + (self.extension_lde.num_cols if self.extension_lde else 0))]
        cols += [self.composition_lde.values[k] for k in range(ncomp)]
        pairs = sorted({(keys.index(("t", off)), col)
                        for (col, off, _y) in trace_pts},
                       key=lambda jc: (jc[1], jc[0]))
        pairs += [(len(keys) - 1, len(cols) - ncomp + k) for k in range(ncomp)]
        if self.ext:
            sums = fd.ext3_to_scalars(self._total(
                kdeep.ood_sums_ext3(cols, invs, pairs, gpow)))
        else:
            sums = [Fp(v) for v in fd.to_ints(self._total(
                kdeep.ood_sums(cols, invs, pairs, gpow)))]
        by_pair = dict(zip(pairs, sums))
        scales = [self._scale_of(y) for y in vals]

        execution_oods = []
        for (col, off, _y) in trace_pts:
            j = keys.index(("t", off))
            execution_oods.append(by_pair[(j, col)] * scales[j])
        composition_oods = [v * scales[-1] for v in sums[len(sums) - ncomp:]]
        self._cache = (trace_pts, keys, invs, execution_oods,
                       composition_oods, x)
        return execution_oods, composition_oods

    def deep_lde(self, coeffs: DeepCompositionCoeffs) -> torch.Tensor:
        """The DEEP composition over the LDE domain, natural order: (n,)
        for an Fp transcript, (3, n) for an Fq3 one."""
        assert self._cache is not None, "call get_ood_evals first"
        trace_pts, keys, invs, exec_oods, comp_oods, x = self._cache
        comp = self.composition_lde.values
        dev = comp.device
        # one view a column and a point, shared by their terms
        rows, views = list(invs), {}
        cols, inv_rows, svals = [], [], []
        for j, (col, off, _y) in enumerate(trace_pts):
            if col not in views:
                views[col] = self._trace_column(col)
            cols.append(views[col])
            inv_rows.append(rows[keys.index(("t", off))])
            svals += [exec_oods[j], coeffs.execution_trace[j]]
        for k in range(comp.shape[0]):
            cols.append(comp[k])
            inv_rows.append(rows[-1])
            svals += [comp_oods[k], coeffs.composition_trace[k]]
        svals += [coeffs.degree[0], coeffs.degree[1]]
        if self.ext:
            s = fd.ext3_table(svals, dev)
            return kdeep.deep_ext3(cols, inv_rows, s, x)
        s = torch.tensor([fd.to_i64(_fp(v)) for v in svals],
                         dtype=torch.int64, device=dev)
        return kdeep.deep(cols, inv_rows, s, x)
