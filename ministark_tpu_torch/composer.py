"""DEEP polynomial composition in evaluation space, Fp AIRs (reference:
src/composer.rs; mirrors ``ministark_tpu.composer``).

* OOD evaluations by barycentric interpolation over the LDE coset
  {o*g^i, i<N}:   P(y) = (y^N - o^N)/(N*o^(N-1)) * sum_i e_i*g^i/(y - x_i)
  -> one batched inversion of (y - x_i) per distinct OOD point (kernel A),
  shared by every column; per column a multiply and a field sum (plain
  PyTorch, where the JAX package ran one XLA program).
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
        raise NotImplementedError("extension-field AIRs are not ported yet")
    return v.v if isinstance(v, Fp) else int(v) % P


class DeepPolyComposer:
    """Evaluation-space DEEP composer over the natural-order LDEs of the
    base trace and the composition trace (Matrix each)."""

    def __init__(self, air, z, base_lde, composition_lde):
        self.air = air
        self.z = Fp(_fp(z))
        self.base_lde = base_lde
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

    def _scale_of(self, y: Fp) -> Fp:
        """Barycentric prefactor (y^N - o^N) / (N * o^(N-1))."""
        dom = self.lde_dom
        return (y ** dom.size - Fp(dom.offset_pow_size())) / (
            Fp(dom.size) * Fp(pow(dom.offset, dom.size - 1, P)))

    def get_ood_evals(self):
        """(execution trace OOD evals, composition trace OOD evals)."""
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

    def deep_lde(self, coeffs: DeepCompositionCoeffs) -> torch.Tensor:
        """The DEEP composition over the LDE domain, natural order: (n,)."""
        assert self._cache is not None, "call get_ood_evals first"
        trace_pts, keys, invs, exec_oods, comp_oods = self._cache
        base = self.base_lde.values
        comp = self.composition_lde.values
        cols, inv_rows, svals = [], [], []
        for j, (col, off, _y) in enumerate(trace_pts):
            cols.append(base[col])
            inv_rows.append(invs[keys.index(("t", off))])
            svals += [exec_oods[j].v, _fp(coeffs.execution_trace[j])]
        for k in range(comp.shape[0]):
            cols.append(comp[k])
            inv_rows.append(invs[-1])
            svals += [comp_oods[k].v, _fp(coeffs.composition_trace[k])]
        svals += [_fp(coeffs.degree[0]), _fp(coeffs.degree[1])]
        s = torch.tensor([fd.to_i64(v) for v in svals], dtype=torch.int64,
                         device=base.device)
        return kdeep.deep(cols, inv_rows, s, self.lde_dom.elements(base.device))
