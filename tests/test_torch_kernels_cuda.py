"""Each hand-written CUDA kernel against its plain PyTorch version on the
card, at small and awkward shapes (the prove's own shapes are checked by
chip_smoke.py).  Integer field math: equality is exact.  The
multi-process prover proves fib 2^10 on the card at NCCL world size 1 and
in two gloo ranks sharing it, and the fully algebraic fib 2^7 (RPO-256
trees and coin) in two gloo ranks, to the golden bytes; RPO-256 runs at a
rank's shapes (the tip's tops over 2 and 4 roots, cyclic row views); NCCL
ranks that would share a card raise.

These tests need an NVIDIA GPU and nvcc; without a card they skip.  Run
them on the card with ``python -m pytest tests/test_torch_kernels_cuda.py``.
No JAX is imported here, so the file also runs where JAX is not installed.
"""

import itertools
import shutil

import numpy as np
import pytest

pytestmark = pytest.mark.cuda

P = 0xFFFFFFFF00000001
KERNELS = ["inv", "ntt", "transpose", "sha256", "eval", "deep", "inv_ext3",
           "sha256_ext3", "eval_ext3", "deep_ext3", "ntt_stage", "rpo256",
           "rpo256_grind", "rpo256_tree", "sha256_grind", "sha256_tree",
           "ood_sums", "ood_sums_ext3", "coin_sha", "coin_rpo", "big_mul",
           "big_ntt", "affine_scan_ext3"]


@pytest.fixture
def dev():
    # no nvidia-smi means no card: skip before paying for the torch import
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU: CUDA kernels run on the card only")
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels run on the card only")
    return torch.device("cuda:0")


def _rand(shape, seed):
    from ministark_tpu_torch.fields.convert import from_u64_numpy

    v = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    return from_u64_numpy(v)


def _same(torch, got, want):
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_matches_plain_on_card(dev, kernel):
    import torch

    from ministark_tpu_torch.ops import build

    k = build.KERNELS.get(kernel)
    before = k.launches if k is not None else 0
    if kernel == "inv":
        from ministark_tpu_torch.ops import inv as kinv

        # lengths around a tile of K T elements (T = 256 threads a block,
        # K = 8, 16 or 32 a thread) and beyond 2^20; and all zeros
        tiles = [k * 256 + d for k in (8, 16, 32) for d in (-1, 0, 1)]
        for n in [1, 100, 4097, *tiles, (1 << 20) + 3]:
            a = _rand(n, n).to(dev)
            a[::3] = 0
            _same(torch, kinv.inv_fp(a), kinv.inv_fp_plain(a))
        z = torch.zeros(5000, dtype=torch.int64, device=dev)
        _same(torch, kinv.inv_fp(z), z)
    elif kernel == "ntt":
        from ministark_tpu_torch.ntt import Domain

        for n, off, B in ((2, 7, 1), (16, 1, 3), (512, 7, 8), (1 << 13, 7, 2)):
            d = Domain(n, off)
            x = _rand((B, n), n)
            got = d.ifft(d.fft(x.to(dev)))
            _same(torch, got, x)
            _same(torch, d.fft(x.to(dev)), d.fft(x))
        from ministark_tpu_torch.fields.scalar import get_root_of_unity
        from ministark_tpu_torch.ntt import powers
        from ministark_tpu_torch.ops import ntt as kntt

        # a column count that no power-of-two tile width divides evenly
        tw = powers(get_root_of_unity(4096).v, 2048, "cpu")
        x, pre = _rand((2, 4096, 6), 4), _rand((4096, 6), 5)
        _same(torch, kntt.col_ntt(x.to(dev), tw.to(dev), pre=pre.to(dev)),
              kntt.col_ntt_plain(x, tw, pre=pre))
        # every column length kernel B takes (one instantiation each): one
        # column, a width of 6 or 40 (tiles of 2 or 8 columns), batches,
        # each combination of the pre and tmat tables
        for log_n1 in range(kntt.MAX_N1.bit_length()):
            n1 = 1 << log_n1
            root = get_root_of_unity(n1).v if n1 > 1 else 1
            tw = powers(root, max(n1 // 2, 1), "cpu")[: n1 // 2]
            shapes = ((3, 1), (2, 6), (1, 40)) if n1 <= 4096 else ((2, 1),
                                                                  (1, 6))
            for (B, C), use_pre, use_tmat in itertools.product(
                    shapes, (False, True), (False, True)):
                seed = 100 * log_n1 + 10 * C + 2 * use_pre + use_tmat
                x = _rand((B, n1, C), seed)
                pre = _rand((n1, C), seed + 1) if use_pre else None
                tmat = _rand((n1, C), seed + 2) if use_tmat else None
                got = kntt.col_ntt(
                    x.to(dev), tw.to(dev),
                    pre=None if pre is None else pre.to(dev),
                    tmat=None if tmat is None else tmat.to(dev))
                _same(torch, got, kntt.col_ntt_plain(x, tw, pre, tmat))
    elif kernel == "ntt_stage":
        from ministark_tpu_torch.fields.scalar import get_root_of_unity
        from ministark_tpu_torch.ntt import powers
        from ministark_tpu_torch.ops import ntt as kntt

        # columns longer than shared memory take the multi-pass kernel
        n1 = 1 << 15
        tw = powers(get_root_of_unity(n1).v, n1 // 2, "cpu")
        x, pre, tmat = _rand((2, n1, 3), 6), _rand((n1, 3), 7), _rand((n1, 3), 8)
        _same(torch, kntt.col_ntt(x.to(dev), tw.to(dev), pre=pre.to(dev),
                                  tmat=tmat.to(dev)),
              kntt.col_ntt_plain(x, tw, pre=pre, tmat=tmat))
        # and short ones too, when asked, against the plain version
        for n1, C in ((1, 2), (2, 5), (256, 6)):
            tw = powers(get_root_of_unity(n1).v, max(n1 // 2, 1), "cpu")
            x, tmat = _rand((3, n1, C), n1), _rand((n1, C), C)
            _same(torch, kntt.col_ntt_staged(x.to(dev), tw.to(dev),
                                             tmat=tmat.to(dev)),
                  kntt.col_ntt_plain(x, tw[:n1 // 2], tmat=tmat))
        # every column length 2^0 .. 2^16 (one to two passes, each pass
        # length and first or later), one column, a width of 6 or 40
        # (tiles of 2 and 8 columns), each combination of the tables
        for log_n1 in range(17):
            n1 = 1 << log_n1
            root = get_root_of_unity(n1).v if n1 > 1 else 1
            tw = powers(root, max(n1 // 2, 1), "cpu")[: n1 // 2]
            shapes = ((2, 1), (1, 6), (1, 40)) if n1 <= 4096 else ((1, 1),
                                                                  (1, 6))
            for (B, C), use_pre, use_tmat in itertools.product(
                    shapes, (False, True), (False, True)):
                seed = 300 * log_n1 + 10 * C + 2 * use_pre + use_tmat
                x = _rand((B, n1, C), seed)
                pre = _rand((n1, C), seed + 1) if use_pre else None
                tmat = _rand((n1, C), seed + 2) if use_tmat else None
                got = kntt.col_ntt_staged(
                    x.to(dev), tw.to(dev),
                    pre=None if pre is None else pre.to(dev),
                    tmat=None if tmat is None else tmat.to(dev))
                _same(torch, got, kntt.col_ntt_plain(x, tw, pre, tmat))
    elif kernel == "rpo256":
        from ministark_tpu_torch.fields.convert import from_u64_numpy
        from ministark_tpu_torch.ops import rpo256 as krpo

        # one permutation of [0, 0, 0, 0 | row] per row of 8, rows of the
        # boundary values 0, 1, p - 1 and 2^32 +- 1 among them
        edge = np.array([0, 1, P - 1, (1 << 32) - 1, (1 << 32) + 1], np.uint64)
        v = np.random.default_rng(30).integers(0, P, (300, 8), dtype=np.uint64)
        v[:5] = edge[:, None]
        v[5:10] = np.resize(edge, (5, 8))
        rows = from_u64_numpy(v).to(dev)
        _same(torch, krpo.hash_rows(rows), krpo.hash_rows_plain(rows))
        for ncols, n in ((1, 5), (8, 300), (9, 64), (17, 33)):
            m = _rand((ncols, n), ncols * n).to(dev)
            _same(torch, krpo.hash_rows(m.T), krpo.hash_rows_plain(m.T))
            rows = m.reshape(n, ncols)
            _same(torch, krpo.hash_rows(rows), krpo.hash_rows_plain(rows))
        for ncols, n in ((1, 5), (3, 64), (16, 40)):
            m = _rand((ncols, 3, n), ncols + n).to(dev)
            _same(torch, krpo.hash_rows_ext3(m), krpo.hash_rows_ext3_plain(m))
        d = torch.randint(0, 256, (200, 32), dtype=torch.uint8, device=dev)
        _same(torch, krpo.merge(d[:100], d[100:]),
              krpo.merge_plain(d[:100], d[100:]))
        # each group layout: 1 element a lane (16 lanes) and 3 (4 lanes)
        edge_m = from_u64_numpy(np.resize(edge, (17, 3))).to(dev)
        keep = krpo.WIDE_LANES_FROM
        for wide_from in (0, 1 << 30):
            krpo.WIDE_LANES_FROM = wide_from
            try:
                m = _rand((17, 3, 37), 31 + wide_from).to(dev)
                _same(torch, krpo.hash_rows_ext3(m),
                      krpo.hash_rows_ext3_plain(m))
                _same(torch, krpo.hash_rows(edge_m.T),
                      krpo.hash_rows_plain(edge_m.T))
                d = torch.randint(0, 256, (66, 32), dtype=torch.uint8,
                                  device=dev)
                _same(torch, krpo.merge(d[:33], d[33:]),
                      krpo.merge_plain(d[:33], d[33:]))
            finally:
                krpo.WIDE_LANES_FROM = keep
    elif kernel == "rpo256_tree":
        from ministark_tpu_torch import hash_rpo, merkle
        from ministark_tpu_torch.ops import rpo256 as krpo

        # every level above 2 .. 64 digests in one launch, against
        # merge_plain level by level; whole trees through merkle.tree_levels
        for m in (2, 4, 32, 64):
            leaves = _rand((m, 4), m).view(torch.uint8)
            got = krpo.tree_tops(leaves.to(dev))
            assert len(got) == m.bit_length() - 1
            cur = leaves
            for g in got:
                cur = krpo.merge_plain(cur[:cur.shape[0] // 2],
                                       cur[cur.shape[0] // 2:])
                _same(torch, g, cur)
        for n in (2, 256, 1 << 12):
            leaves = _rand((n, 4), n).view(torch.uint8)
            got = merkle.tree_levels(leaves.to(dev), hash_rpo)
            cur = leaves
            for lvl in got[1:]:
                cur = krpo.merge_plain(cur[:cur.shape[0] // 2],
                                       cur[cur.shape[0] // 2:])
                _same(torch, lvl, cur)
            assert got[-1].shape == (1, 32)
        with pytest.raises(ValueError):
            krpo.tree_tops(torch.zeros((3, 32), dtype=torch.uint8,
                                       device=dev))
    elif kernel == "rpo256_grind":
        from ministark_tpu_torch.ops import pow as kpow

        seed = kpow.seed_elements(bytes(range(32)), dev)
        for start in (1, (1 << 32) - 100):
            lz = torch.empty(1000, dtype=torch.int32, device=dev)
            got = kpow.grind_batch(seed, start, 1000, 6, lz=lz)
            _same(torch, lz, kpow.leading_zeros_plain(seed, start, 1000))
            assert got == kpow.grind_batch_plain(seed, start, 1000, 6)
        assert kpow.grind_rpo(bytes(range(32)), 6, dev) == kpow.grind_rpo(
            bytes(range(32)), 6, "cpu")
        # each group layout on one batch
        from ministark_tpu_torch.ops import rpo256 as krpo

        want = kpow.leading_zeros_plain(seed, 5, 700)
        keep = krpo.WIDE_LANES_FROM
        for wide_from in (0, 1 << 30):
            krpo.WIDE_LANES_FROM = wide_from
            try:
                lz = torch.empty(700, dtype=torch.int32, device=dev)
                got = kpow.grind_batch(seed, 5, 700, 5, lz=lz)
                _same(torch, lz, want)
                assert got == kpow.grind_batch_plain(seed, 5, 700, 5)
            finally:
                krpo.WIDE_LANES_FROM = keep
    elif kernel == "transpose":
        from ministark_tpu_torch.ops import transpose as ktr

        # rows a multiple of 32 and columns of 64 take the 16-byte tiles,
        # other shapes the masked ones; a batch above the old 65535 cap of
        # the grid
        for shape in ((1, 1, 1), (3, 40, 72), (2, 64, 32), (2, 32, 64),
                      (2, 64, 128), (5, 128, 64), (2, 100, 130),
                      (1, 4096, 64), (3, 96, 192), (70000, 2, 3)):
            x = _rand(shape, sum(shape)).to(dev)
            _same(torch, ktr.transpose(x), ktr.transpose_plain(x))
        # an input 8 bytes off 16-byte alignment takes the masked tiles
        x = _rand(1 + 2 * 64 * 64, 9).to(dev)[1:].view(2, 64, 64)
        _same(torch, ktr.transpose(x), ktr.transpose_plain(x))
    elif kernel == "sha256":
        from ministark_tpu_torch.ops import sha256 as ksha

        # 7, 8 and 16 columns end in a block of padding alone (its
        # schedule a launch constant)
        for ncols, n in ((1, 5), (8, 300), (9, 64), (4, 16), (7, 33),
                         (16, 20)):
            m = _rand((ncols, n), ncols * n).to(dev)
            _same(torch, ksha.hash_rows(m.T), ksha.hash_rows_plain(m.T))
            rows = m.reshape(n, ncols)
            _same(torch, ksha.hash_rows(rows), ksha.hash_rows_plain(rows))
        d = torch.randint(0, 256, (200, 32), dtype=torch.uint8, device=dev)
        _same(torch, ksha.merge(d[:100], d[100:]),
              ksha.merge_plain(d[:100], d[100:]))
    elif kernel == "sha256_grind":
        from ministark_tpu_torch import native
        from ministark_tpu_torch.ops import sha256 as ksha

        # the smallest nonce, as the native host grind finds it, at 1-20 bits
        for bits in range(1, 21):
            seed = bytes((bits * 7 + k) % 256 for k in range(32))
            assert ksha.grind(seed, bits, dev) == native.pow_grind(
                seed, bits), bits
        # every nonce's count of leading zeros, across the carry into the
        # high word, and the first hit of a batch
        seed = bytes(range(32))
        for start, n in ((1, 1000), ((1 << 32) - 300, 700), (5, 129)):
            lz = torch.empty(n, dtype=torch.int32, device=dev)
            got = ksha.grind_batch(seed, start, n, 6, dev, lz=lz)
            _same(torch, lz, ksha.leading_zeros_plain(seed, start, n))
            assert got == ksha.grind_batch_plain(seed, start, n, 6)
            # without lz, blocks past a hit stop: the same first hit
            assert ksha.grind_batch(seed, start, n, 6, dev) == got
        assert ksha.grind_batch(seed, 1, 100, 40, dev) == -1
    elif kernel == "sha256_tree":
        from ministark_tpu_torch import hash as H
        from ministark_tpu_torch import merkle
        from ministark_tpu_torch.ops import sha256 as ksha

        def plain_levels(leaves):
            cur, out = leaves, []
            while cur.shape[0] > 1:
                h = cur.shape[0] // 2
                cur = ksha.merge_plain(cur[:h], cur[h:])
                out.append(cur)
            return out

        def leaves_of(m):
            return torch.from_numpy(np.random.default_rng(m).integers(
                0, 256, (m, 32), dtype=np.uint8))

        # every level above 2 .. TOPS_LEAVES digests in one launch, and
        # above up to the 1024 the kernel takes
        keep = ksha.TOPS_LEAVES
        try:
            ksha.TOPS_LEAVES = 1024
            for m in [1 << k for k in range(1, 11)]:
                leaves = leaves_of(m)
                got = ksha.tree_tops(leaves.to(dev))
                want = plain_levels(leaves)
                assert len(got) == len(want) == m.bit_length() - 1
                for g, w in zip(got, want):
                    _same(torch, g, w)
        finally:
            ksha.TOPS_LEAVES = keep
        # whole trees through merkle.tree_levels: merges, then the tops
        for n in (2, 64, 256, 1 << 15):
            leaves = leaves_of(n)
            got = merkle.tree_levels(leaves.to(dev), H)
            assert len(got) == n.bit_length()
            for g, w in zip(got[1:], plain_levels(leaves)):
                _same(torch, g, w)
        with pytest.raises(ValueError):
            ksha.tree_tops(torch.zeros((3, 32), dtype=torch.uint8,
                                       device=dev))
    elif kernel in ("eval", "eval_ext3"):
        from ministark_tpu_torch import eval as teval
        from ministark_tpu_torch.air import Air, ProofOptions
        from ministark_tpu_torch.fields.scalar import Fp
        from ministark_tpu_torch.ops import eval as keval

        if kernel == "eval":
            from ministark_tpu_torch.models.fib import FibAirConfig

            air = Air(FibAirConfig, 128, Fp(3), ProofOptions(8, 4, 2, 4, 16))
        else:
            from ministark_tpu_torch.models.brainfuck import (
                BrainfuckAirConfig, BrainfuckClaim)

            air = Air(BrainfuckAirConfig, 64,
                      BrainfuckClaim("+.", b"", b"\x01"),
                      ProofOptions(9, 16, 0, 4, 16))
        plan, source, _ = teval._plan_for(air)
        n = air.ce_domain().size
        n_fp = sum(1 for k in plan.inv_keys if plan.inv_kind[k] == "fp")
        nb = air.config.NUM_BASE_COLUMNS
        ne = getattr(air.config, "NUM_EXTENSION_COLUMNS", 0)
        args = [_rand((nb, n), 1), _rand((ne, 3, n), 4),
                air.ce_domain().elements("cpu"),
                torch.zeros((0, n), dtype=torch.int64), _rand((n_fp, n), 2),
                _rand((len(plan.inv_keys) - n_fp, 3, n), 5),
                _rand(max(plan.num_slots, 1), 3)]
        for what, e, _kind in plan.scalars:  # Pow exponents sit in the table
            if what == "exp":
                args[-1][plan.slot[("exp", e)]] = e
        cb = air.ce_blowup_factor
        want = keval.eval_terms_plain(plan, cb, *args)
        # every group in one launch, and a launch a group
        for launch in ("grid", "groups"):
            _same(torch, keval.eval_terms(plan, source, cb,
                                          *[a.to(dev) for a in args],
                                          launch=launch), want)
    elif kernel == "deep":
        from ministark_tpu_torch.ops import deep as kdeep

        T, n = 5, 777
        cols = [_rand(n, t) for t in range(T)]
        invs = [_rand(n, 10 + t) for t in range(T)]
        s, x = _rand(2 * T + 2, 20), _rand(n, 21)
        _same(torch, kdeep.deep([c.to(dev) for c in cols],
                                [v.to(dev) for v in invs], s.to(dev),
                                x.to(dev)),
              kdeep.deep_plain(cols, invs, s, x))
        # terms sharing inverse rows, 1 to 8 lanes a point, a grid-stride
        # pass (more points than the blocks launched hold)
        for T, n in ((17, 3000), (40, 1 << 19)):
            cols = [_rand(n, 30 + t) for t in range(T)]
            rows = _rand((3, n), 29)
            invs = [rows[t % 3] for t in range(T)]
            s, x = _rand(2 * T + 2, 28), _rand(n, 27)
            want = kdeep.deep_plain(cols, invs, s, x)
            dcols, drows = [c.to(dev) for c in cols], rows.to(dev)
            for lanes in (1, 2, 8):
                _same(torch, kdeep.deep(dcols, [drows[t % 3] for t in range(T)],
                                        s.to(dev), x.to(dev), lanes=lanes),
                      want)
    elif kernel == "inv_ext3":
        from ministark_tpu_torch.ops import inv as kinv

        # single rows, and batches of B > 1 rows shorter and longer than a
        # tile, with a tail; and all zeros
        for shape in ((3, 1), (3, 100), (2, 3, 4097), (5, 3, 7),
                      (3, 3, 2049), (4, 3, 8193), (3, 3, (1 << 18) + 3)):
            a = _rand(shape, shape[-1]).to(dev)
            a[..., ::3] = 0          # zero elements
            a[..., 1:, 1::3] = 0     # base-field elements
            _same(torch, kinv.inv_ext3(a), kinv.inv_ext3_plain(a))
        z = torch.zeros((2, 3, 3000), dtype=torch.int64, device=dev)
        _same(torch, kinv.inv_ext3(z), z)
    elif kernel == "sha256_ext3":
        from ministark_tpu_torch.ops import sha256 as ksha

        for ncols, n in ((1, 5), (9, 300), (16, 64), (4, 16)):
            m = _rand((ncols, 3, n), ncols * n).to(dev)
            _same(torch, ksha.hash_rows_ext3(m), ksha.hash_rows_ext3_plain(m))
    elif kernel == "deep_ext3":
        from ministark_tpu_torch.ops import deep as kdeep

        n = 777
        cols = [_rand(n, 1), _rand((3, n), 2), _rand((3, n), 3), _rand(n, 4)]
        T = len(cols)
        invs = [_rand((3, n), 10 + t % 2) for t in range(T)]
        s, x = _rand(6 * T + 6, 20), _rand(n, 21)
        _same(torch, kdeep.deep_ext3([c.to(dev) for c in cols],
                                     [v.to(dev) for v in invs], s.to(dev),
                                     x.to(dev)),
              kdeep.deep_ext3_plain(cols, invs, s, x))
        # terms of both kinds sharing inverse rows, 1 to 8 lanes a point
        for T, n in ((9, 3000), (33, 1 << 18)):
            cols = [_rand(n, 40 + t) if t % 3 else _rand((3, n), 40 + t)
                    for t in range(T)]
            rows = _rand((3, 3, n), 39)
            invs = [rows[t % 3] for t in range(T)]
            s, x = _rand(6 * T + 6, 38), _rand(n, 37)
            want = kdeep.deep_ext3_plain(cols, invs, s, x)
            dcols, drows = [c.to(dev) for c in cols], rows.to(dev)
            for lanes in (1, 4, 8):
                _same(torch, kdeep.deep_ext3(
                    dcols, [drows[t % 3] for t in range(T)], s.to(dev),
                    x.to(dev), lanes=lanes), want)
    elif kernel in ("ood_sums", "ood_sums_ext3"):
        from ministark_tpu_torch.ops import deep as kdeep

        ext = kernel == "ood_sums_ext3"
        fn = kdeep.ood_sums_ext3 if ext else kdeep.ood_sums
        plain = kdeep.ood_sums_ext3_plain if ext else kdeep.ood_sums_plain
        from ministark_tpu_torch.fields import device as fd

        # one point, points no chunk divides, several chunks; a column
        # read by six points (more than a group holds); every pair in its
        # own column and groups of the widest.  The kernel reads gpow[0]
        # and gpow[1] of the row f g^i: f = 1 (the whole domain) on the odd
        # sizes, f = 5 (a rank's share) on the even ones
        for n, ncols, npts in ((1, 3, 2), (777, 12, 6), (1 << 16, 40, 3),
                               (5000, 70, 4)):
            cols = [_rand((3, n), 50 + c) if ext and c % 2 else
                    _rand(n, 50 + c) for c in range(ncols)]
            invs = _rand((npts, 3, n) if ext else (npts, n), 49)
            gpow = fd.mul(fd.powers(7, n, "cpu"), 1 if n % 2 else 5)
            pairs = [(j, 0) for j in range(npts)]
            pairs += [((c * 7) % npts, c) for c in range(1, ncols)]
            pairs += [((c + 1) % npts, c) for c in range(1, ncols, 3)]
            _same(torch, fn([c.to(dev) for c in cols], invs.to(dev), pairs,
                            gpow.to(dev)),
                  plain(cols, invs, pairs, gpow))
        # the kernel makes every power from the first two: a row that is
        # not geometric raises
        bad = gpow.clone()
        bad[-1] = 3
        with pytest.raises(ValueError, match="geometric"):
            fn([c.to(dev) for c in cols], invs.to(dev), pairs, bad.to(dev))
    elif kernel in ("coin_sha", "coin_rpo"):
        import hashlib

        from ministark_tpu_torch import hash_rpo
        from ministark_tpu_torch.ops import coin as kcoin

        sha = kernel == "coin_sha"
        fn = kcoin.coin_sha if sha else kcoin.coin_rpo
        plain = kcoin.coin_sha_plain if sha else kcoin.coin_rpo_plain
        for i in range(4):
            if sha:
                seed = hashlib.sha256(b"seed %d" % i).digest()
                root = hashlib.sha256(b"root %d" % i).digest()
            else:  # RPO digests: canonical elements
                seed = hash_rpo.hash_elements([i, 3])
                root = hash_rpo.hash_elements([i, 5])
            for k in ((1, 3, 5) if sha else range(1, 9)):
                # alpha's powers for an Fp or Fq3 alpha, 1 to 16 of them
                for N in ((0, 1, 2, 16) if k in (1, 3) else (0,)):
                    s, r = (kcoin.seed_tensor(seed, dev),
                            kcoin.seed_tensor(root, dev))
                    got = fn(s, r, k, N)
                    want = plain(kcoin.seed_tensor(seed, "cpu"),
                                 kcoin.seed_tensor(root, "cpu"), k, N)
                    for g, w in zip(got, want):
                        _same(torch, g, w)
        # a root read in place from a level of a tree on the card
        level = torch.stack([kcoin.seed_tensor(d, dev) for d in (seed, root)])
        s = kcoin.seed_tensor(seed, dev)
        for g, w in zip(fn(s, level[1], 3, 8),
                        plain(s.cpu(), level[1].cpu(), 3, 8)):
            _same(torch, g, w)
    elif kernel in ("big_mul", "big_ntt"):
        from ministark_tpu_torch.fields.bigvec import (BigDomain, BigField,
                                                       Fp128Vec, Fp252Vec)
        from ministark_tpu_torch.ops import bigfield as kbig

        rng = np.random.default_rng(60)

        def vals(f, n):
            nb = (f.p.bit_length() + 7) // 8 + 8
            raw = rng.bytes(nb * n)
            v = [int.from_bytes(raw[i:i + nb], "little") % f.p
                 for i in range(0, nb * n, nb)]
            v[:3] = [0, 1, f.p - 1][:n]
            return v

        # the plain versions run on the card too (2^18 points on the host
        # would take minutes); the named primes take the specialised
        # product, the others the generic one
        others = [BigField("M127", 2**127 - 1, 3, 1),
                  BigField("P255m19", 2**255 - 19, 2, 2)]
        for f in [Fp128Vec, Fp252Vec] + others:
            if kernel == "big_mul":
                for n in (1, 2, 3, 32, 1000, 2048, 4099, 1 << 15, 1 << 18):
                    a = f.pack(vals(f, n), dev)
                    b = f.pack(vals(f, n), dev)
                    _same(torch, kbig.big_mul(a, b, f),
                          kbig.big_mul_plain(a, b, f))
                    _same(torch, kbig.big_mul(a, b[:, :1], f),
                          kbig.big_mul_plain(a, b[:, :1], f))
                    # limb planes 8 bytes off a 16-byte boundary: one
                    # element a thread
                    buf = torch.empty(f.L64 * n + 1, dtype=torch.int64,
                                      device=dev)
                    odd = buf[1:].view(f.L64, n)
                    odd.copy_(a)
                    _same(torch, kbig.big_mul(odd, b, f),
                          kbig.big_mul_plain(a, b, f))
                continue
            sizes = (1, 2, 4, 32, 1 << 9, 1 << 11, 1 << 15, 1 << 18)
            for n in sizes[:f.two_adicity + 1]:
                x = f.pack(vals(f, n), dev)
                for off in (1, f.generator):
                    dom = BigDomain(f, n, off)
                    for inverse in (False, True):
                        t = dom._tables(inverse, str(dev))
                        _same(torch, kbig.big_ntt(x, *t[:1], f, *t[1:]),
                              kbig.big_ntt_plain(x, *t[:1], f, *t[1:]))
                    _same(torch, dom.ifft(dom.fft(x)), x)
    elif kernel == "affine_scan_ext3":
        from ministark_tpu_torch import scan
        from ministark_tpu_torch.models.brainfuck.trace import _INCLUSIVE

        # brainfuck's nine columns at fibonacci.bf's 2^20 rows (512 tiles
        # of 2048 a column: two rounds of the tiles' scan), 2^15 and
        # hello_world's 2^11; ragged lengths (one element, a tile less or
        # more one, three tiles and a part), a bool for all
        for B, n, inc in ((9, 1 << 20, _INCLUSIVE), (9, 1 << 15, _INCLUSIVE),
                          (9, 1 << 11, _INCLUSIVE),
                          (9, 3 * 2048 + 77, _INCLUSIVE), (1, 1, True),
                          (2, 2047, [False, True]), (3, 2049, False)):
            a, b = _rand((B, 3, n), n).to(dev), _rand((B, 3, n), n + 1).to(dev)
            a[..., 0, ::5] = 1       # a = 1 and b = 0: the identity map
            a[..., 1:, ::5] = 0
            b[..., ::5] = 0
            a[..., 7::11] = 0        # a = 0: the state starts again at b
            init = _rand((B, 3), B + n).to(dev)
            _same(torch, scan.affine_scan_ext3(a, b, init, inc),
                  scan.affine_scan_ext3_plain(a, b, init, inc))
    assert build.KERNELS[kernel].launches > before


@pytest.mark.parametrize("trace_len", [64, 1 << 12])
def test_rescue_evaluator_matches_plain_on_card(dev, trace_len):
    """Kernel E's instantiation for the Rescue AIR (eleven periodic inputs,
    eight runtime-exponent powers, x^(N + N/16 + 5) from the chain's
    x^(N/16)) against its plain version, in both launch ways."""
    import torch

    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.models.rescue import RescueAirConfig
    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.ops import eval as keval

    before = build.KERNELS["eval"].launches
    air = Air(RescueAirConfig, trace_len, (7, 8, 1, 2),
              ProofOptions(8, 8, 4, 4, 16))
    plan, source, _ = teval._plan_for(air)
    n = air.ce_domain().size
    empty = torch.zeros((0, 3, n), dtype=torch.int64)
    args = [_rand((4, n), 61), empty, air.ce_domain().elements("cpu"),
            _rand((len(plan.periodic), n), 62),
            _rand((len(plan.inv_keys), n), 63), empty,
            _rand(max(plan.num_slots, 1), 64)]
    for what, e, _kind in plan.scalars:  # Pow exponents sit in the table
        if what == "exp":
            args[-1][plan.slot[("exp", e)]] = e
    want = keval.eval_terms_plain(plan, air.ce_blowup_factor, *args)
    for launch in ("grid", "groups"):
        _same(torch, keval.eval_terms(plan, source, air.ce_blowup_factor,
                                      *[a.to(dev) for a in args],
                                      launch=launch), want)
    assert build.KERNELS["eval"].launches > before


@pytest.mark.parametrize("which", ["fib", "bf", "rescue"])
def test_block_entry_matches_plain_on_card(dev, which):
    """Kernel E's block entry (``eval_terms_block``): the last of four
    blocks of the CE domain from trace columns holding its points and the
    halo after them, against its plain version, in both launch ways."""
    import torch

    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.ops import build
    from ministark_tpu_torch.ops import eval as keval

    if which == "fib":
        from ministark_tpu_torch.fields.scalar import Fp
        from ministark_tpu_torch.models.fib import FibAirConfig

        air = Air(FibAirConfig, 128, Fp(3), ProofOptions(8, 4, 2, 4, 16))
    elif which == "bf":
        from ministark_tpu_torch.models.brainfuck import (BrainfuckAirConfig,
                                                          BrainfuckClaim)

        air = Air(BrainfuckAirConfig, 64, BrainfuckClaim("+.", b"", b"\x01"),
                  ProofOptions(9, 16, 0, 4, 16))
    else:
        from ministark_tpu_torch.models.rescue import RescueAirConfig

        air = Air(RescueAirConfig, 64, (7, 8, 1, 2),
                  ProofOptions(8, 8, 4, 4, 16))
    kernel = build.KERNELS["eval_ext3" if which == "bf" else "eval"]
    before = kernel.launches
    plan, source, _ = teval._plan_for(air)
    n = air.ce_domain().size
    m, h = n // 4, teval.trace_halo(air)
    n_fp = sum(1 for k in plan.inv_keys if plan.inv_kind[k] == "fp")
    nb = air.config.NUM_BASE_COLUMNS
    ne = getattr(air.config, "NUM_EXTENSION_COLUMNS", 0)
    args = [_rand((nb, m + h), 71), _rand((ne, 3, m + h), 72),
            air.ce_domain().elements("cpu")[3 * m:],
            _rand((len(plan.periodic), m), 73), _rand((n_fp, m), 74),
            _rand((len(plan.inv_keys) - n_fp, 3, m), 75),
            _rand(max(plan.num_slots, 1), 76)]
    for what, e, _kind in plan.scalars:  # Pow exponents sit in the table
        if what == "exp":
            args[-1][plan.slot[("exp", e)]] = e
    cb = air.ce_blowup_factor
    want = keval.eval_terms_plain(plan, cb, *args, block=True)
    for launch in ("grid", "groups"):
        _same(torch, keval.eval_terms_block(plan, source, cb,
                                            *[a.to(dev) for a in args],
                                            launch=launch), want)
    assert kernel.launches > before


_OOD_MAC = r"""
#include "deep.cuh"
#include "launch.cuh"

// one thread: `count` products x y into one accumulator (the kernel's
// PTX carry chain), its five words and its reduction
__global__ void ood_mac_run(uint64_t x, uint64_t y, int64_t count,
                            uint32_t* words, uint64_t* red) {
    ood_acc a;
    ood_acc_zero(a);
    for (int64_t k = 0; k < count; k++) ood_mac(a, x, y);
    for (int w = 0; w < 5; w++) words[w] = a.r[w];
    red[0] = ood_acc_reduce(a);
}

MS_API int t_ood_mac(uint64_t x, uint64_t y, int64_t count, uint32_t* words,
                     uint64_t* red, cudaStream_t stream) {
    ood_mac_run<<<1, 1, 0, stream>>>(x, y, count, words, red);
    return ms_last_error();
}

MS_API int64_t t_ood_max_run() { return OOD_MAX_RUN; }
"""


@pytest.mark.parametrize("x, y", [(P - 1, P - 1),
                                  ((1 << 64) - 1, (1 << 64) - 1),
                                  ((1 << 64) - 1, P - 1)])
def test_ood_accumulator_longest_run_on_card(dev, x, y):
    """The card's ood_mac (the PTX carry chain, not the host's __int128)
    over a thread's longest run, 3 x OOD_MAX_RUN products of the largest
    words: its 160-bit sum word for word, and reduced mod p, exact."""
    import ctypes

    import torch

    from ministark_tpu_torch.ops import build

    k = build.CudaKernel("ood_mac_check", None, replaces="")
    k.build(_OOD_MAC)
    lib = build._LIBS[_OOD_MAC]
    lib.t_ood_max_run.restype = ctypes.c_int64
    count = 3 * lib.t_ood_max_run()
    words = torch.zeros(5, dtype=torch.int32, device=dev)
    red = torch.zeros(1, dtype=torch.int64, device=dev)
    k.launch("t_ood_mac", ctypes.c_uint64(x), ctypes.c_uint64(y),
             build.i64(count), build.ptr(words), build.ptr(red),
             source_text=_OOD_MAC)
    torch.cuda.synchronize()
    got = sum((w % (1 << 32)) << (32 * i)
              for i, w in enumerate(words.cpu().tolist()))
    assert got == x * y * count
    assert red.item() % (1 << 64) == x * y * count % P


def _build_fib_path():
    """Every CUDA source and the fib evaluator, built in this process, so
    that spawned ranks load the libraries and never build them."""
    from ministark_tpu_torch import eval as teval
    from ministark_tpu_torch.air import Air, ProofOptions
    from ministark_tpu_torch.fields.scalar import Fp
    from ministark_tpu_torch.models.fib import FibAirConfig
    from ministark_tpu_torch.ops import (bigfield, build, coin,  # noqa: F401
                                         deep, eval, inv, ntt, rpo256,
                                         sha256, transpose)

    from concurrent.futures import ThreadPoolExecutor

    air = Air(FibAirConfig, 1 << 7, Fp(0), ProofOptions(8, 4, 2, 4, 16))
    jobs = [(k, None) for k in {k.source: k for k in build.KERNELS.values()
                                if k.source}.values()]
    jobs.append((build.KERNELS["eval"], teval._plan_for(air)[1]))
    with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
        list(ex.map(lambda j: j[0].build(j[1]), jobs))


def test_prove_sharded_on_card(dev, tmp_path):
    """fib 2^10 by prove_sharded: NCCL at world size 1 in this process,
    then two gloo ranks sharing cuda:0; both give the golden bytes, and
    every collective runs (at world size 1 each is an identity), the
    commits' column exchanges half as many at two ranks."""
    import os

    import torch.distributed as dist

    import torch_sharded_tasks as tasks
    from ministark_tpu_torch.parallel.sharded import make_mesh
    from ministark_tpu_torch.parallel.spawn import RankPool

    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "fib_2e10.proof"), "rb") as f:
        golden = f.read()
    _build_fib_path()
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/nccl",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        assert mesh.device.type == "cuda" and mesh.backend == "nccl"
        one = tasks.prove(mesh, "fib")
    finally:
        dist.destroy_process_group()
    assert one["proof"] == golden and one["collectives"] > 0
    with RankPool(2, "gloo", "cuda", str(tmp_path / "gloo"),
                  timeout=300) as pool:
        out = pool.run(tasks.prove, "fib")
    # the commits exchange a column at a time: at world size 1 a rank
    # holds every column, at two half of them (fib's 8 trace columns, the
    # rows and the CE block; the composition's cb columns)
    claim, trace, opts = tasks.workload("fib", "cpu")
    cb = claim.build_air(trace.base_columns().num_rows,
                         opts).ce_blowup_factor
    fewer = 2 * (8 - 4) + (cb - -(-cb // 2))
    for r in out:
        assert r["proof"] == golden and r["loaded"] == []
        assert r["collectives"] == one["collectives"] - fewer


def test_prove_sharded_rpo_on_card(dev, tmp_path):
    """The fully algebraic fib 2^7 (RPO-256 trees and coin) by
    prove_sharded in two gloo ranks sharing cuda:0: every phase sharded,
    the golden bytes on both ranks, the same collectives on each."""
    import os

    import torch_sharded_tasks as tasks
    from ministark_tpu_torch.parallel.spawn import RankPool

    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "fib_2e7_rpo_full.proof"), "rb") as f:
        golden = f.read()
    _build_fib_path()
    with RankPool(2, "gloo", "cuda", str(tmp_path / "gloo"),
                  timeout=300) as pool:
        out = pool.run(tasks.prove, "rpo_full")
    for r in out:
        assert r["proof"] == golden and r["loaded"] == []
        assert r["collectives"] > 0
    assert len({(r["collectives"], r["bytes"]) for r in out}) == 1


@pytest.mark.parametrize("d", [2, 4])
def test_rpo_at_a_ranks_shapes_on_card(dev, d):
    """RPO-256 as rank r of d runs it in prove_sharded: the tip's tree
    tops over the d gathered subtree roots (m = d, where a one-process
    tree starts its tops launch at 64 leaves), and row hashes of a rank's
    cyclic rows read in place (rows j = r mod d of an (8, n) column-major
    block: row stride d, column stride n), laid out as the executor lays
    them after its exchange ((8, m) contiguous, read as its transpose) and
    as Fq3 columns, on both sides of the lane layouts' switch."""
    import torch

    from ministark_tpu_torch import hash_rpo, merkle
    from ministark_tpu_torch.ops import rpo256 as krpo

    roots = _rand((d, 4), 70 + d).view(torch.uint8)
    tops = krpo.tree_tops(roots.to(dev))
    levels = merkle.tree_levels(roots.to(dev), hash_rpo)
    assert len(tops) == len(levels) - 1 == d.bit_length() - 1
    cur = roots
    for top, lvl in zip(tops, levels[1:]):
        cur = krpo.merge_plain(cur[:cur.shape[0] // 2],
                               cur[cur.shape[0] // 2:])
        _same(torch, top, cur)
        _same(torch, lvl, cur)
    for m in (krpo.WIDE_LANES_FROM // 2, krpo.WIDE_LANES_FROM):
        x = _rand((8, m * d), m + d).to(dev)
        for r in (0, d - 1):
            view = x[:, r::d].T
            _same(torch, krpo.hash_rows(view), krpo.hash_rows_plain(view))
            rows = x[:, r::d].contiguous()
            _same(torch, krpo.hash_rows(rows.T),
                  krpo.hash_rows_plain(rows.T))
        ext = _rand((3, 3, m), m + d + 1).to(dev)
        _same(torch, krpo.hash_rows_ext3(ext), krpo.hash_rows_ext3_plain(ext))


def test_nccl_ranks_sharing_a_card_raise(dev, tmp_path):
    import torch

    from ministark_tpu_torch.parallel.spawn import RankPool

    world = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="gloo"):
        RankPool(world, "nccl", "cuda", str(tmp_path / "store"), timeout=120)
