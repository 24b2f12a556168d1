"""Kernel F (csrc/deep.cu, math in csrc/deep.cuh), in Fp and in Fq3, each
entry point beside its plain PyTorch version: the DEEP sum over the LDE
domain (``deep``, ``deep_ext3``) and the OOD barycentric sums
(``ood_sums``, ``ood_sums_ext3``)."""

from __future__ import annotations

import torch

from ..fields import device as fd
from . import build

KERNEL = build.register(
    "deep", "deep.cu",
    replaces="ministark_tpu/ops/deep_pallas.py:103 _group_kernel_base")
KERNEL_EXT3 = build.register(
    "deep_ext3", "deep.cu",
    replaces="ministark_tpu/ops/deep_pallas.py:64 _group_kernel_ext")
KERNEL_OOD = build.register(
    "ood_sums", "deep.cu",
    replaces="ministark_tpu/composer.py:76 _ood_program_impl (prog_fp, XLA)")
KERNEL_OOD_EXT3 = build.register(
    "ood_sums_ext3", "deep.cu",
    replaces="ministark_tpu/composer.py:76 _ood_program_impl (prog_ext, XLA)")

# The OOD kernels' groups (csrc/deep.cuh, deep.cu): at most OOD_W[ext]
# points and P (point, column) pairs each.  An Fp transcript's group holds
# P = the first of OOD_FP_PAIRS that takes all its pairs (the kernel's
# instantiations); an Fq3 transcript's OOD_P3 pairs of Fq3 columns or
# OOD_P30 of Fp columns (deep.cu's OOD_P3, OOD_P30).  The launch's chunks
# of points are the kernel's to choose (deep.cu ms_ood_chunks).
OOD_W = {False: 4, True: 2}
OOD_FP_PAIRS = (16, 20, 32)
OOD_P3 = 4
OOD_P30 = 12
# columns the plain OOD sums multiply by the weights at once, as
# (columns, 3, n) elements: bounds the plain version's temporaries
PLAIN_OOD_ELEMS = 1 << 26


def deep_plain(cols, invs, s, x):
    T = len(cols)
    sv = s.tolist()
    acc = torch.zeros_like(x)
    for t in range(T):
        d = fd.sub(torch.full_like(x, sv[2 * t]), cols[t])
        acc = fd.add(acc, fd.mul(fd.mul(d, invs[t]), s[2 * t + 1]))
    return fd.mul(acc, fd.add(fd.mul(x, s[2 * T + 1]), s[2 * T]))


def deep_ext3_plain(cols, invs, s, x):
    T = len(cols)
    sc = s.reshape(-1, 3, 1)  # one (3, 1) Fq3 scalar per slot triple
    acc = torch.zeros((3, x.shape[0]), dtype=torch.int64, device=x.device)
    for t in range(T):
        ood, alpha = sc[2 * t], sc[2 * t + 1]
        c = cols[t] if cols[t].ndim == 2 else fd.ext3_from_base(cols[t])
        q = fd.ext3_mul(fd.sub(ood, c), invs[t])
        acc = fd.add(acc, fd.ext3_mul(q, alpha))
    adj = fd.add(sc[2 * T], fd.ext3_mul_base(sc[2 * T + 1], x))
    return fd.ext3_mul(acc, adj)


def deep_lanes(ext: bool) -> int:
    """Threads that share a point of the DEEP sum.  Timed in turns on an
    H100 at 1, 2, 4 and 8 lanes (scripts/ab_kernels.py): two run fastest
    for Fq3 transcripts at 2^15 and 2^24 points, one for Fp at 2^23 (where
    the sum is memory-bound)."""
    return 2 if ext else 1


def _pointers(tensors) -> list:
    """data_ptr() of each tensor, asked once a tensor object (terms share
    their rows and columns, and data_ptr() costs a microsecond)."""
    seen: dict = {}
    out = []
    for t in tensors:
        p = seen.get(id(t))
        if p is None:
            p = seen[id(t)] = t.data_ptr()
        out.append(p)
    return out


def deep_plan(cols, invs, lanes: int) -> tuple[list, int]:
    """The DEEP kernel's plan (csrc/deep.cuh): the terms grouped by their
    inverse row (the same tensor storage), each group cut into segments of
    one column kind, and, with lanes > 1, of at most T / (2 lanes) terms.
    Returns (int64 words, number of segments)."""
    T = len(cols)
    col_ptrs, row_ptrs = _pointers(cols), _pointers(invs)
    groups: dict = {}
    for t, ptr in enumerate(row_ptrs):
        groups.setdefault(ptr, ([], []))[int(cols[t].ndim == 2)].append(t)
    longest = max(1, -(-T // (2 * lanes))) if lanes > 1 else max(T, 1)
    order, starts, kinds, rows = [], [0], [], []
    for ptr, by_kind in groups.items():
        for kind, same in enumerate(by_kind):
            for k in range(0, len(same), longest):
                order += same[k:k + longest]
                starts.append(len(order))
                kinds.append(kind)
                rows.append(ptr)
    words = ([T, len(kinds)] + [col_ptrs[t] for t in order] + order
             + starts + kinds + rows)
    return words, len(kinds)


def _check_inputs(what, ts, ok):
    """check_cuda and the shape (one of `ok`) of each tensor object of `ts`
    once (terms share their rows and columns)."""
    for t in {id(t): t for t in ts}.values():
        build.check_cuda(t, name=what)
        if tuple(t.shape) not in ok:
            raise ValueError(f"{what} of shape {tuple(t.shape)} is not one "
                             f"of {ok}")


def _check_terms(cols, invs, x, ext: bool):
    n = x.shape[0]
    build.check_cuda(x, name="x")
    _check_inputs("deep: col", cols, ((n,), (3, n)) if ext else ((n,),))
    _check_inputs("deep: inv", invs, ((3, n),) if ext else ((n,),))


def _int64_table(words, device) -> torch.Tensor:
    """`words` on the card, copied from pinned memory without waiting for
    the card (a copy from pageable memory would wait for the stream)."""
    return torch.tensor(words, dtype=torch.int64,
                        pin_memory=True).to(device, non_blocking=True)


def _launch_deep(kernel, fn, cols, invs, s, x, out, lanes, ext):
    n = x.shape[0]
    lanes = lanes or deep_lanes(ext)
    words, nseg = deep_plan(cols, invs, lanes)
    plan = _int64_table(words, x.device)
    kernel.launch(fn, build.ptr(plan), build.i64(len(cols)), build.i64(nseg),
                  build.ptr(s), build.ptr(x), build.ptr(out), build.i64(n),
                  build.c_int(lanes))
    return out


def deep(cols: list, invs: list, s: torch.Tensor, x: torch.Tensor,
         lanes: int | None = None):
    """sum_t alpha_t * (ood_t - cols[t]) * invs[t], times (A + B * x).
    cols/invs: T (n,) int64 vectors; s: [ood_0, alpha_0, ..., A, B].
    CUDA tensors launch the kernel (`lanes` threads a point, by default
    ``deep_lanes``); CPU tensors take the plain version."""
    if not x.is_cuda:
        return deep_plain(cols, invs, s, x)
    T = len(cols)
    if len(invs) != T or s.shape != (2 * T + 2,):
        raise ValueError("deep: need one inverse row and two scalars per term")
    build.check_cuda(s, name="s")
    _check_terms(cols, invs, x, False)
    return _launch_deep(KERNEL, "ms_deep", cols, invs, s, x,
                        torch.empty_like(x), lanes, False)


def deep_ext3(cols: list, invs: list, s: torch.Tensor, x: torch.Tensor,
              lanes: int | None = None):
    """The DEEP sum over an Fq3 transcript, times (A + B * x), as a (3, n)
    tensor.  cols: T columns, each (n,) in Fp or (3, n) in Fq3; invs: T
    (3, n) inverse rows; s: 3 slots per Fq3 scalar, [ood_0, alpha_0, ...,
    A, B]; x: (n,).  CUDA tensors launch the kernel (`lanes` as in
    ``deep``); CPU tensors take the plain version."""
    if not x.is_cuda:
        return deep_ext3_plain(cols, invs, s, x)
    T = len(cols)
    if len(invs) != T or s.shape != (6 * T + 6,):
        raise ValueError("deep_ext3: need one inverse row and two Fq3 "
                         "scalars per term")
    build.check_cuda(s, name="s")
    _check_terms(cols, invs, x, True)
    out = torch.empty((3, x.shape[0]), dtype=torch.int64, device=x.device)
    return _launch_deep(KERNEL_EXT3, "ms_deep_ext3", cols, invs, s, x, out,
                        lanes, True)


# -- the OOD barycentric sums --------------------------------------------------


def _plain_sums(cols, invs, pairs, gpow, ext: bool):
    """sum_i cols[c][i] * invs[j][i] * gpow[i] for each pair (j, c), a few
    columns at a time: point by point, its columns' products with the
    weights w = invs[j] * gpow, summed by ``fd.sum_mod``."""
    n = gpow.shape[-1]
    step = max(1, PLAIN_OOD_ELEMS // (3 * n))
    out: dict = {}
    if not pairs:
        return torch.zeros((3, 0) if ext else (0,), dtype=torch.int64,
                           device=gpow.device)
    for j in sorted({j for j, _c in pairs}):
        w = (fd.ext3_mul_base(invs[j], gpow) if ext
             else fd.mul(invs[j], gpow))
        ks = [k for k, (jj, _c) in enumerate(pairs) if jj == j]
        base = [k for k in ks if cols[pairs[k][1]].ndim == 1]
        wide = [k for k in ks if cols[pairs[k][1]].ndim == 2]
        for group, times_w in ((base, (lambda t: fd.ext3_mul_base(w, t))
                                if ext else (lambda t: fd.mul(t, w))),
                               (wide, lambda t: fd.ext3_mul(t, w))):
            for a in range(0, len(group), step):
                part = group[a:a + step]
                t = torch.stack([cols[pairs[k][1]] for k in part])
                out.update(zip(part, fd.sum_mod(times_w(t), dim=-1)))
    return torch.stack([out[k] for k in range(len(pairs))], dim=-1)


def ood_sums_plain(cols, invs, pairs, gpow):
    return _plain_sums(cols, invs, pairs, gpow, False)


def ood_sums_ext3_plain(cols, invs, pairs, gpow):
    return _plain_sums(cols, invs, pairs, gpow, True)


def ood_pairs_a_group(ext: bool, npairs: int) -> tuple[int, int]:
    """(P, P0): the pairs a group of the OOD kernel, of Fq3 columns and of
    Fp columns.  An Fq3 transcript's (OOD_P3, OOD_P30); an Fp one's the
    first of OOD_FP_PAIRS that holds all `npairs` (one group, each row read
    once a point), else the largest, both."""
    if ext:
        return OOD_P3, OOD_P30
    P = next((P for P in OOD_FP_PAIRS if P >= npairs), OOD_FP_PAIRS[-1])
    return P, P


def ood_record_words(ext: bool, P: int, P0: int | None = None) -> int:
    """int64 words of one OOD group's record of max(P, P0) pairs
    (csrc/deep.cuh OOD_RECORD)."""
    return 3 + OOD_W[ext] + 3 * max(P, P0 or P)


def ood_groups(cols, invs, pairs, ext: bool, P: int,
               P0: int | None = None) -> list:
    """The OOD kernel's groups (csrc/deep.cuh), one record each of max(P,
    P0) pairs, flattened: a column's pairs go to one group where they fit
    (columns of one kind a group, at most OOD_W[ext] points and P pairs, P0
    for Fp columns in an Fq3 transcript), in the order of the columns' first
    pairs.  Unused slots and pairs repeat the group's first inverse row and
    column (the kernel loads them all, unconditionally).  invs: one
    contiguous tensor, row j at invs[j]."""
    W = OOD_W[ext]
    P0 = P0 or P
    RP = max(P, P0)
    row0, row_bytes = invs.data_ptr(), invs.stride(0) * 8
    by_col: dict = {}
    for k, (j, c) in enumerate(pairs):
        by_col.setdefault(c, []).append((k, j))
    records: list = []
    ptrs: list = []   # the group's pairs: column pointers, slots, outputs
    slots: list = []
    outs: list = []
    pts: list = []    # its points, in order of first use
    wide = False

    def flush():
        if not ptrs:
            return
        m = len(ptrs)
        rows = [row0 + j * row_bytes for j in pts]
        records.extend([m, len(pts), int(wide)])
        records.extend(rows + rows[:1] * (W - len(pts)))
        records.extend(ptrs + ptrs[:1] * (RP - m))
        records.extend(slots + [0] * (RP - m))
        records.extend(outs + [0] * (RP - m))
        ptrs.clear()
        slots.clear()
        outs.clear()
        pts.clear()

    for c, kjs in by_col.items():
        col = cols[c]
        kind = col.ndim == 2
        cap = P if kind or not ext else P0
        new_pts = {j for _k, j in kjs}.difference(pts)
        if ptrs and (len(ptrs) + len(kjs) > cap
                     or len(pts) + len(new_pts) > W or kind != wide):
            flush()
        wide = kind
        ptr = col.data_ptr()
        for k, j in kjs:  # a column of more pairs or points than a group
            if len(ptrs) == cap or (j not in pts and len(pts) == W):
                flush()
            if j not in pts:
                pts.append(j)
            ptrs.append(ptr)
            slots.append(pts.index(j))
            outs.append(k)
    flush()
    return records


def _check_geometric(gpow: torch.Tensor):
    """The kernel reads gpow[0] and gpow[1] only and makes f g^i from
    them: raise unless the row's middle and last powers agree.  Checked
    once a tensor version: one read back from the card, as the prove reads
    its OOD sums back just after."""
    n = gpow.shape[0]
    if n < 3 or getattr(gpow, "_ood_geometric", None) == gpow._version:
        return
    idx = torch.tensor([0, 1, n // 2, n - 1], device=gpow.device)
    f, fg, mid, last = (v % (1 << 64) % fd.P for v in gpow[idx].tolist())
    g = fg * pow(f, -1, fd.P) % fd.P if f else 0
    if not f or (f * pow(g, n // 2, fd.P) % fd.P != mid
                 or f * pow(g, n - 1, fd.P) % fd.P != last):
        raise ValueError("ood_sums: gpow is not a geometric row f g^i")
    gpow._ood_geometric = gpow._version


def _ood(kernel, fn, cols, invs, pairs, gpow, ext: bool):
    n = gpow.shape[0]
    build.check_cuda(gpow, name="gpow")
    build.check_cuda(invs, name="invs")
    if invs.shape[1:] != ((3, n) if ext else (n,)) or invs.shape[0] > 65535:
        raise ValueError(f"ood_sums: inverse rows of shape "
                         f"{tuple(invs.shape)} for {n} points")
    if n > 1 << 31:
        raise ValueError(f"ood_sums: {n} points, more than 2^31")
    if any(not 0 <= j < invs.shape[0] for j, _c in pairs):
        raise ValueError("ood_sums: a pair of no inverse row")
    _check_inputs("ood_sums: col", [cols[c] for _j, c in pairs],
                  ((n,), (3, n)) if ext else ((n,),))
    slots = 3 if ext else 1
    out = torch.empty(slots * len(pairs), dtype=torch.int64,
                      device=gpow.device)
    if pairs:
        _check_geometric(gpow)
        P, P0 = ood_pairs_a_group(ext, len(pairs))
        words = ood_groups(cols, invs, pairs, ext, P, P0)
        groups = len(words) // ood_record_words(ext, P, P0)
        chunks = kernel.query("ms_ood_chunks", int(ext), P, n, groups)
        recs = _int64_table(words, gpow.device)
        partial = torch.empty(chunks * slots * len(pairs), dtype=torch.int64,
                              device=gpow.device)
        args = [build.ptr(recs), build.i64(groups), build.ptr(gpow),
                build.ptr(partial), build.ptr(out), build.i64(n),
                build.i64(chunks), build.i64(len(pairs))]
        kernel.launch(fn, *args, *(() if ext else (build.i64(P),)))
    return out.reshape(3, -1) if ext else out


def ood_sums(cols: list, invs: torch.Tensor, pairs: list,
             gpow: torch.Tensor) -> torch.Tensor:
    """S[k] = sum_i cols[c][i] * invs[j][i] * gpow[i] for each pair k =
    (j, c), in Fp: cols (n,) vectors, invs (npts, n), gpow (n,) the powers
    f g^i (f = 1 for the whole LDE group, g^r for a rank's cyclic share of
    it); returns (len(pairs),).  CUDA tensors launch the kernel (two
    launches: the groups' partial sums, then their sum), which reads only
    gpow[0] and gpow[1] and makes the other powers (a row that is not
    geometric raises); CPU tensors take the plain version, which reads
    every power."""
    if not gpow.is_cuda:
        return ood_sums_plain(cols, invs, pairs, gpow)
    return _ood(KERNEL_OOD, "ms_ood_sums", cols, invs, pairs, gpow, False)


def ood_sums_ext3(cols: list, invs: torch.Tensor, pairs: list,
                  gpow: torch.Tensor) -> torch.Tensor:
    """The OOD sums of an Fq3 transcript: cols (n,) Fp or (3, n) Fq3
    columns, invs (npts, 3, n) Fq3 inverse rows, gpow (n,) as for
    ``ood_sums``; returns (3, len(pairs)).  CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    if not gpow.is_cuda:
        return ood_sums_ext3_plain(cols, invs, pairs, gpow)
    return _ood(KERNEL_OOD_EXT3, "ms_ood_sums_ext3", cols, invs, pairs, gpow,
                True)
