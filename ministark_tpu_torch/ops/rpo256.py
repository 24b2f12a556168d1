"""RPO-256 (Rescue Prime Optimized, eprint 2022/1577) over Goldilocks:
parameters, the plain permutation, and wrappers for kernel G
(csrc/rpo256.cu) beside their plain PyTorch versions.

Parameters: state width 12, capacity 4, rate 8, digest 4, 7 rounds, the
reference's circulant MDS matrix and round constants (gpu/src/metal/
hash_shaders.h.metal).  They are published in Montgomery form (R = 2^64
mod p) and converted here to canonical values with the port's own
``fields.scalar.R_MONT_INV``, as ``ministark_tpu.ops.rpo256`` converts them.

A state batch is a (12, n) int64 tensor, element k of state i at [k, i].
Digests leave the wrappers as (n, 32) uint8 tensors: the four digest
elements' little-endian bytes (``hash_rpo._digest_bytes``), which is the
memory of an (n, 4) int64 tensor, so a digest array and its elements are
views of each other.  CUDA tensors launch the kernel; CPU tensors take the
plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import device as fd
from ..fields.scalar import P, R_MONT_INV
from . import build
from .sha256 import ext3_rows

STATE_WIDTH = 12
CAPACITY = 4
RATE = 8
DIGEST_SIZE = 4
NUM_ROUNDS = 7
INV_ALPHA = 10540996611094048183  # x^7 inverse exponent (mod p-1)

# Montgomery-form parameters as published in the RPO reference kernels
_MDS_MONT_FIRST_ROW = [
    30064771065, 98784247785, 34359738360, 111669149670, 55834574835,
    42949672950, 38654705655, 30064771065, 25769803770, 94489280490,
    90194313195, 34359738360,
]

_RC0_MONT = [
    [6936159699454947676, 6871277616928621393, 4226339945476756083, 2261225084505152444, 16808067423291017741, 12862191241011323277, 345720808813194915, 10126368034161173654, 840649715788759894, 18155600607269645987, 16577339120870559289, 13749826054300849029],
    [16047969944113931191, 10474334246235299199, 15773847146013662260, 14401231158322525155, 6009395255763488383, 2108579439821148946, 13820200715803196660, 15968614366574245570, 7529997729792773654, 9429194013557833999, 11639903126146281421, 15759666882357935738],
    [14807658266593669785, 17258259860767641342, 9534132615398591413, 358719342502509866, 7123090532818864651, 734193187930710962, 14873184913735487023, 17965359964069906568, 12664837478844326631, 15575491070113731145, 7221479899469196675, 7328957460733188967],
    [15088355010936495340, 16762963605345901631, 15278161326153175940, 6257793333052173411, 8418953127708045776, 6523475766574412380, 15192936988185261803, 1578086224854546096, 10840553425559156784, 7453417405109536362, 5173069484734008228, 3284492202065476384],
    [1724586709636399686, 17997633752581871175, 1284825320737914582, 960534381847281815, 6708901808183456837, 8975591106768797316, 52515315389099119, 10009391031874081397, 3091228317422201238, 1063858230459024983, 3396548655473917480, 15046057790353688034],
    [4867464583127666756, 13816959924674544309, 13931201815459591565, 11494116713280125381, 16823081743980874023, 6760771226809185048, 5346741505458044699, 15124596060558844029, 5332565678905773189, 17640389307200936126, 14049814539797608740, 8882709539093378074],
    [10507930462458090835, 10669463960502417047, 16753662827442720769, 12967456627495301601, 2989815121821278695, 5894674479204135685, 14187454698288462352, 14795723369628125345, 17260571099239679821, 16009836214833755168, 2009092225887788829, 10838446069154019765],
]

_RC1_MONT = [
    [8939123259393952351, 14708045228210488368, 18125168669810517809, 9309821433754818185, 4714467145607136006, 1302482025306688824, 34829973686821040, 5637233680011148778, 227119480134509573, 2530972937109017559, 7210163798538732239, 955913576003606833],
    [4449617297638325218, 10843671682695268638, 13198957499160452915, 11541825028620451829, 10963484480734735121, 4752902142121643229, 3015289210993491059, 16344286514680205966, 1811079964700766606, 12735664961476037524, 5775391330037813314, 18223625362487900986],
    [7222477607687412281, 4215615082079701144, 6177508277476483691, 3491362079220677263, 10961785333913978630, 1935408839283360916, 13974192629927279950, 18013556876298568088, 7565676920589638093, 9265825103386412558, 8061587790235022972, 6806849270604947860],
    [8066442548506952806, 12791828131640457742, 9268748809821748950, 17496234860625277598, 13583894547367420658, 13920282495726802458, 3933141341199584259, 6658057712176150702, 16812362035931029194, 15160401867587809089, 16411108749946146942, 3390826434320009844],
    [18405475140095477472, 13864039573264702148, 496144052468360460, 9791523668470936672, 528582340156917005, 15864481364569144493, 682830611952089590, 347158833826327515, 13752775429919623417, 10254722988306758482, 8794150602427420596, 2480344122229837853],
    [15462337562022968595, 6729968753311049611, 9250220857258211097, 12031447985684644003, 14538803180331344696, 4055445230671851890, 14764039661528567501, 2047787218814287270, 8977863094202715520, 6560450968915612407, 9976241128570886075, 17877509887772213755],
    [3549624494907837709, 4253629935471652443, 2859199883984623807, 1087607721547343649, 7907517619951970198, 11306402795121903516, 10168009948206732524, 9177440083248248246, 13169036816957726187, 12924186209140199217, 9673006056831483321, 747828276541750689],
]


def _from_mont(v: int) -> int:
    return v * R_MONT_INV % P


# canonical small-int circulant MDS (first row)
MDS_FIRST_ROW = [_from_mont(v) for v in _MDS_MONT_FIRST_ROW]
MDS = np.zeros((STATE_WIDTH, STATE_WIDTH), dtype=np.uint32)
for _m in range(STATE_WIDTH):
    for _n in range(STATE_WIDTH):
        MDS[_m, _n] = MDS_FIRST_ROW[(_n - _m) % STATE_WIDTH]
assert MDS.max() < 32

ROUND_CONSTANTS_0 = np.array([[_from_mont(v) for v in row] for row in _RC0_MONT],
                             dtype=np.uint64)
ROUND_CONSTANTS_1 = np.array([[_from_mont(v) for v in row] for row in _RC1_MONT],
                             dtype=np.uint64)

_P, _I = build.PTR, build.I64
KERNEL = build.register(
    "rpo256", "rpo256.cu",
    replaces="ministark_tpu/ops/rpo256_pallas.py:136 _rpo_kernel",
    prototypes={"ms_rpo_hash_rows": (_P, _P) + (_I,) * 5,
                "ms_rpo_merge": (_P, _P, _P, _I, _I)})
KERNEL_TREE = build.register(
    "rpo256_tree", "rpo256.cu",
    replaces="ministark_tpu/ops/rpo256_pallas.py:243 tree_levels_lanes_br",
    prototypes={"ms_rpo_tree_tops": (_P, _P, _I)})

# Kernel G spreads each state over a group of lanes (csrc/rpo256_lanes.cuh),
# ``lane_elems(n)`` elements a lane; a tree level of at most TOPS_LEAVES
# digests has every level above it built by one launch of one block.
# Measured on an NVIDIA H100 80GB HBM3 at 700 W, in turns
# (scripts/ab_kernels.py --rpo-sweep): 1 element a lane wins below 2^13
# states (4096 merges 0.069 against 0.073 ms), 3 from there (8192: 0.096
# against 0.117 ms; 2^22: 44.9 ms); the tops launch over the last 64
# leaves takes a 2^15-leaf tree from 0.818 to 0.745 ms (with 3 elements a
# lane over the last 64-256 leaves, 1.10-1.18 ms), so it runs 1 element a
# lane whatever the merges below it took.  One state a
# thread lost to both at every size from 1 to 2^23 states (one merge 0.48
# against 0.035 ms, 2^22 merges 53.7 against 44.9 ms, 2^23 rows of 8
# columns 115.8 against 85.4 ms) and is gone.
WIDE_LANES_FROM = 1 << 13
TOPS_LEAVES = 64


def lane_elems(n: int) -> int:
    """Elements of a state a lane for a launch of n states: 1 (12 of 16
    lanes, the shortest permutation) below WIDE_LANES_FROM, else 3 (4
    lanes, the most permutations a second)."""
    return 3 if n >= WIDE_LANES_FROM else 1


_MASK32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=8)
def _round_constants(device: str) -> torch.Tensor:
    """(2, 7, 12, 1) int64: RC0 and RC1 on `device`."""
    rc = np.stack([ROUND_CONSTANTS_0, ROUND_CONSTANTS_1]).view(np.int64)
    return torch.from_numpy(rc.copy()).to(device)[..., None]


def _mds_rc_plain(s: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """MDS @ s + rc over (12, n): row m sums MDS_FIRST_ROW[j] * s[(m+j) %
    12], the 32-bit halves apart (each sum < 2^41), then reduces the 74-bit
    total once: lo + hi * 2^32 = l + h * 2^64 and 2^64 = 2^32 - 1 mod p."""
    halves = torch.stack([s & _MASK32, (s >> 32) & _MASK32])   # (2, 12, n)
    twice = torch.cat([halves, halves], dim=1)                 # (2, 24, n)
    acc = MDS_FIRST_ROW[0] * halves
    for j in range(1, STATE_WIDTH):
        acc += MDS_FIRST_ROW[j] * twice[:, j:j + STATE_WIDTH]
    lo, hi = acc
    l = lo + (hi << 32)
    h = (hi >> 32) + fd._ult(l, lo).to(torch.int64)
    return fd.add(fd.canonicalize(fd._reduce128_lazy(h, l)), rc)


def _pow_inv7_plain(x: torch.Tensor) -> torch.Tensor:
    """x^10540996611094048183 (the inverse of x^7) as a lazy representative
    (``fd.mul_lazy``): the 63-squaring, 9-multiply chain of
    ministark_tpu/ops/rpo256_pallas.py:122-133."""
    mul, sqr = fd.mul_lazy, fd.sqr_lazy

    def sqr_n(v, k):
        for _ in range(k):
            v = sqr(v)
        return v

    t1 = sqr(x)
    t2 = sqr(t1)
    t3 = mul(sqr_n(t2, 3), t2)
    t4 = mul(sqr_n(t3, 6), t3)
    t5 = mul(sqr_n(t4, 12), t4)
    t6 = mul(sqr_n(t5, 6), t3)
    t7 = mul(sqr_n(t6, 31), t6)
    a = sqr_n(mul(sqr(t7), t6), 2)
    return mul(a, mul(mul(t1, t2), x))


def permute_plain(state: torch.Tensor) -> torch.Tensor:
    """The RPO permutation of a (12, n) int64 batch of canonical states:
    each round MDS + RC0, x^7, MDS + RC1, x^(1/7)."""
    rc = _round_constants(str(state.device))
    s = state
    for r in range(NUM_ROUNDS):
        s = _mds_rc_plain(s, rc[0, r])
        s3 = fd.mul_lazy(fd.sqr_lazy(s), s)
        s = fd.mul_lazy(fd.sqr_lazy(s3), s)         # x^7
        s = _pow_inv7_plain(_mds_rc_plain(s, rc[1, r]))
    return fd.canonicalize(s)


def _digest_bytes(state: torch.Tensor) -> torch.Tensor:
    """(12, n) states -> (n, 32) uint8 digests (state[4..8])."""
    d = state[CAPACITY:CAPACITY + DIGEST_SIZE].T.contiguous()
    return d.view(torch.uint8)


def _digest_elems(d: torch.Tensor) -> torch.Tensor:
    """(n, 32) uint8 digests -> (n, 4) int64 elements (a view)."""
    if d.ndim != 2 or d.shape[1] != 32 or d.dtype != torch.uint8:
        raise ValueError(f"need (n, 32) uint8 digests, got "
                         f"{tuple(d.shape)} {d.dtype}")
    return d.contiguous().view(torch.int64)


def hash_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """RPO digests of the rows of an (n, C) field matrix (any strides):
    ``hash_rpo.hash_elements`` of each row."""
    n, ncols = rows.shape
    state = torch.zeros((STATE_WIDTH, n), dtype=torch.int64,
                        device=rows.device)
    if ncols % RATE:
        state[0] = 1
    for c0 in range(0, ncols, RATE):
        chunk = rows[:, c0:c0 + RATE].T
        k = chunk.shape[0]
        state[CAPACITY:CAPACITY + k] = chunk
        if k < RATE:
            state[CAPACITY + k] = 1
            state[CAPACITY + k + 1:] = 0
        state = permute_plain(state)
    return _digest_bytes(state)


def merge_plain(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    n = left.shape[0]
    state = torch.cat([torch.zeros((CAPACITY, n), dtype=torch.int64,
                                   device=left.device),
                       _digest_elems(left).T, _digest_elems(right).T])
    return _digest_bytes(permute_plain(state))


def _hash_strided(x: torch.Tensor, n: int, ncols: int, rs: int,
                  cs: int) -> torch.Tensor:
    out = torch.empty((n, DIGEST_SIZE), dtype=torch.int64, device=x.device)
    KERNEL.launch("ms_rpo_hash_rows", x.data_ptr(), out.data_ptr(), n, ncols,
                  rs, cs, lane_elems(n))
    return out.view(torch.uint8)


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """RPO digests of the rows of an (n, C) int64 field matrix -> (n, 32)
    uint8.  `rows` may be a strided view (a transposed column-major
    matrix): the kernel reads it in place."""
    if not rows.is_cuda:
        return hash_rows_plain(rows)
    if rows.dtype != torch.int64 or rows.ndim != 2:
        raise TypeError(f"rows must be a 2-D int64 tensor, got "
                        f"{tuple(rows.shape)} {rows.dtype}")
    n, ncols = rows.shape
    rs, cs = rows.stride()
    return _hash_strided(rows, n, ncols, rs, cs)


def hash_rows_ext3_plain(m: torch.Tensor) -> torch.Tensor:
    return hash_rows_plain(ext3_rows(m))


def hash_rows_ext3(m: torch.Tensor) -> torch.Tensor:
    """RPO digests of the rows of a (C, 3, n) Fq3 matrix, each element
    absorbed as its components c0, c1, c2 (``hash_rpo.hash_elements``) ->
    (n, 32) uint8.  Element (row i, component k of column c) lies at
    (3c + k) * n + i: one strided read, no copy."""
    rows = ext3_rows(m)
    if not m.is_cuda:
        return hash_rows_plain(rows)
    build.check_cuda(m, name="m")
    n, width = rows.shape
    return _hash_strided(m, n, width, 1, n)


def merge(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Merkle merges RPO(left[i] || right[i]) of (n, 32) uint8 digests."""
    if not left.is_cuda:
        return merge_plain(left, right)
    if left.shape != right.shape:
        raise ValueError(f"merge needs two equal digest arrays, got "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    le, ri = _digest_elems(left), _digest_elems(right)
    for name, t in (("left", le), ("right", ri)):
        build.check_cuda(t, name=name)
    out = torch.empty_like(le)
    n = le.shape[0]
    KERNEL.launch("ms_rpo_merge", le.data_ptr(), ri.data_ptr(),
                  out.data_ptr(), n, lane_elems(n))
    return out.view(torch.uint8)


def tree_tops(level: torch.Tensor) -> list[torch.Tensor]:
    """Every tree level above `level`, (m, 32) uint8 digests in tree-bitrev
    storage (m a power of two, 2 <= m <= TOPS_LEAVES): level h holds the
    merges of the two halves of the level below, the root's level last.
    One launch builds them all into one buffer, one element of a state a
    lane, and the levels are views of it.  Card only: its plain version is
    ``merge_plain`` a level at a time, which ``merkle.tree_levels`` runs
    for CPU tensors."""
    m = level.shape[0]
    if m < 2 or m & (m - 1) or m > TOPS_LEAVES:
        raise ValueError(f"tree tops need 2 <= m <= {TOPS_LEAVES} digests, "
                         f"m a power of two; got {m}")
    d = _digest_elems(level)
    build.check_cuda(d, name="level")
    out = torch.empty((m - 1, DIGEST_SIZE), dtype=torch.int64,
                      device=d.device)
    KERNEL_TREE.launch("ms_rpo_tree_tops", d.data_ptr(), out.data_ptr(), m)
    levels, start, h = [], 0, m // 2
    while h:
        levels.append(out[start:start + h].view(torch.uint8))
        start, h = start + h, h // 2
    return levels


def grind(seed: bytes, bits: int, device) -> int:
    """The proof-of-work grind of an RPO-256 coin on `device`
    (``ops.pow.grind_rpo``)."""
    from .pow import grind_rpo  # ops.pow builds on this module

    return grind_rpo(seed, bits, device)
