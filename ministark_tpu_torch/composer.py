"""DEEP polynomial composition in evaluation space (reference:
src/composer.rs; mirrors ``ministark_tpu.composer``), for Fp transcripts
(fib) and Fq3 transcripts (brainfuck).

* OOD evaluations by barycentric interpolation over the LDE coset
  {o*g^i, i<N}:   P(y) = (y^N - o^N)/(N*o^(N-1)) * sum_i e_i*g^i/(y - x_i)
  -> one batched inversion of (y - x_i) for the distinct OOD points
  (kernel A, in Fp or Fq3), shared by every column; per column a multiply
  and a field sum (plain PyTorch, where the JAX package ran one XLA
  program).  Columns go through the sums a few at a time, so no product
  of the whole trace with the weights is ever held.
* The DEEP LDE assembled pointwise by the verifier's quotient formula:
      deep(x_i) = [ sum_t a_t*(ood_t - T_t(x_i)) / (y_t - x_i) ] * (A + B*x_i)
  in one pass of kernel F.

Values are exact mod-p algebra, identical to the JAX package's.
"""

from __future__ import annotations

import torch

from .fields import device as fd
from .fields.scalar import Fp, Fq3, P
from .ntt import powers
from .ops import deep as kdeep

# elements of the largest (columns, 3, n) product the OOD sums hold at once
_OOD_CHUNK = 1 << 26


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

    def get_ood_evals(self):
        """(execution trace OOD evals, composition trace OOD evals)."""
        if self.ext:
            return self._ood_evals_ext3()
        trace_pts = self._trace_points()
        keys, vals = self._distinct_points()
        dom = self.lde_dom
        dev = self.base_lde.device
        x = dom.elements(dev)
        gpow = powers(dom.group_gen, dom.size, dev)
        base = self.base_lde.values
        comp = self.composition_lde.values

        invs, sums = [], []
        for j, y in enumerate(vals):
            inv = fd.batch_inv(fd.sub(fd.full(x.shape, y.v, dev), x))
            invs.append(inv)
            w = fd.mul(inv, gpow)
            cols = comp if j == len(vals) - 1 else base
            sums.append(fd.to_ints(fd.sum_mod(fd.mul(cols, w), dim=-1)))
        scales = [self._scale_of(y) for y in vals]

        execution_oods = [
            Fp(sums[keys.index(("t", off))][col])
            * scales[keys.index(("t", off))]
            for (col, off, _y) in trace_pts]
        composition_oods = [Fp(v) * scales[-1] for v in sums[-1]]
        self._cache = (trace_pts, keys, torch.stack(invs), execution_oods,
                       composition_oods)
        return execution_oods, composition_oods

    def _trace_column(self, col: int) -> torch.Tensor:
        """Trace column `col`: (n,) base or (3, n) extension values."""
        nb = self.base_lde.num_cols
        if col < nb:
            return self.base_lde.values[col]
        return self.extension_lde.values[col - nb]

    def _weighted_sums(self, cols: list[int], w: torch.Tensor,
                       column) -> list[Fq3]:
        """sum_i column(c)[i] * w[i] in Fq3 for each c in `cols`, a few
        columns at a time; w is (3, n), column(c) (n,) or (3, n)."""
        step = max(1, _OOD_CHUNK // (3 * w.shape[-1]))
        out = {}
        base = [c for c in cols if column(c).ndim == 1]
        ext = [c for c in cols if column(c).ndim == 2]
        for group, times_w in ((base, lambda t: fd.ext3_mul_base(w, t)),
                               (ext, lambda t: fd.ext3_mul(t, w))):
            for k in range(0, len(group), step):
                part = group[k:k + step]
                t = torch.stack([column(c) for c in part])
                s = fd.sum_mod(times_w(t), dim=-1)  # (len(part), 3)
                out.update(zip(part, fd.ext3_to_scalars(s.T)))
        return [out[c] for c in cols]

    def _ood_evals_ext3(self):
        trace_pts = self._trace_points()
        keys, vals = self._distinct_points()
        dom = self.lde_dom
        dev = self.base_lde.device
        x = dom.elements(dev)
        gpow = powers(dom.group_gen, dom.size, dev)
        ys = fd.ext3_table(vals, dev).reshape(-1, 3, 1)
        invs = fd.ext3_batch_inv(fd.sub(ys, fd.ext3_from_base(x)))

        sums = {}
        for j, key in enumerate(keys[:-1]):
            cols = sorted({c for (c, off, _y) in trace_pts
                           if ("t", off) == key})
            w = fd.ext3_mul_base(invs[j], gpow)
            for c, v in zip(cols, self._weighted_sums(
                    cols, w, self._trace_column)):
                sums[(j, c)] = v
        ncomp = self.composition_lde.num_cols
        w = fd.ext3_mul_base(invs[-1], gpow)
        comp_sums = self._weighted_sums(
            list(range(ncomp)), w, lambda k: self.composition_lde.values[k])
        scales = [self._scale_of(y) for y in vals]

        execution_oods = []
        for (col, off, _y) in trace_pts:
            j = keys.index(("t", off))
            execution_oods.append(sums[(j, col)] * scales[j])
        composition_oods = [v * scales[-1] for v in comp_sums]
        self._cache = (trace_pts, keys, invs, execution_oods,
                       composition_oods)
        return execution_oods, composition_oods

    def deep_lde(self, coeffs: DeepCompositionCoeffs) -> torch.Tensor:
        """The DEEP composition over the LDE domain, natural order: (n,)
        for an Fp transcript, (3, n) for an Fq3 one."""
        assert self._cache is not None, "call get_ood_evals first"
        trace_pts, keys, invs, exec_oods, comp_oods = self._cache
        comp = self.composition_lde.values
        dev = comp.device
        cols, inv_rows, svals = [], [], []
        for j, (col, off, _y) in enumerate(trace_pts):
            cols.append(self._trace_column(col))
            inv_rows.append(invs[keys.index(("t", off))])
            svals += [exec_oods[j], coeffs.execution_trace[j]]
        for k in range(comp.shape[0]):
            cols.append(comp[k])
            inv_rows.append(invs[-1])
            svals += [comp_oods[k], coeffs.composition_trace[k]]
        svals += [coeffs.degree[0], coeffs.degree[1]]
        x = self.lde_dom.elements(dev)
        if self.ext:
            s = fd.ext3_table(svals, dev)
            return kdeep.deep_ext3(cols, inv_rows, s, x)
        s = torch.tensor([fd.to_i64(_fp(v)) for v in svals],
                         dtype=torch.int64, device=dev)
        return kdeep.deep(cols, inv_rows, s, x)
