"""Kernel B1's mma form, held on the CPU.

On the card ``csrc/histogram.cu`` computes a level histogram as the
reference's factored one-hot contraction on the integer tensor cores: a u8
operand A (n, T*N) holding each active (row, tree)'s weight at column
t*N + node, a u8 operand Bm (n, C*S*B) holding a 1 at c*S*B + s*B + b for
each valid (row, split), and P = A^T Bm summed in int32 over 32-row
k-steps (``mma.sync`` m16n8k32).  Here:

* a PyTorch emulation of those operands and that k-step product equals,
  exactly, the JAX ``_count_body``, the Pallas ``forest_level_counts`` in
  interpret mode and the port's plain version, at the rafo level, its root,
  the bench forest's level and small deep levels, with node ids -1, -2 and
  N, classes -1 and C, branch codes outside [0, B), zero weights, weight
  255 and row counts that are not multiples of 32;
* an emulation of the kernel itself, lane by lane, from the plan
  ``mma_plan`` gives (128-row tiles, the operand rows the scatter writes,
  each lane's ldmatrix row addresses and the fragment registers they give,
  read as the PTX m16n8k32 .u8 layout defines them, the warps' tile
  shares, the slabs, the flush back to (T,N,S,B,C)), equals the plain
  version;
* ``level_form`` picks ``mma`` for the rafo and bench levels with uint8
  weights and ``atomic`` for float32 weights and the ``wide`` shape.

``chip_smoke.py`` holds the kernel's two forms against the plain version on
the card.  Every comparison is exact: every sum is an integer.
"""

import numpy as np
import pytest
import torch

import jax

from avenir_tpu.models.forest import _count_body
from avenir_tpu.ops.pallas.histogram import forest_level_counts as pallas_counts
from avenir_tpu_torch.kernels import histogram

_COUNT_JIT = jax.jit(_count_body, static_argnums=(4, 5, 6))

# (T, N, S, B, C): the rafo level, its root, the bench forest's level, the
# single tree (T = 1, C + 1 classes), a deep level, and one whose product
# takes two slabs
SHAPES = {"rafo": (9, 8, 19, 2, 2), "rafo_root": (9, 1, 19, 2, 2),
          "bench": (16, 8, 19, 2, 2), "tree": (1, 8, 19, 2, 3),
          "deep": (3, 32, 5, 3, 2), "slabs": (8, 16, 19, 3, 4)}


def level_inputs(seed, n, shape, edges=True):
    """Seeded inputs; ``edges`` adds node ids -2, -1 and N, classes -1 and
    C, branch codes -1 and B, and weights of 0 and 255."""
    T, N, S, B, C = shape
    rng = np.random.default_rng(seed)
    lo = -2 if edges else 0
    nid = rng.integers(lo, N + 1 if edges else N, (n, T)).astype(np.int32)
    br = rng.integers(-1 if edges else 0, B + 1 if edges else B, (n, S)
                      ).astype(np.int32)
    cls = rng.integers(-1 if edges else 0, C + 1 if edges else C, (n,)
                       ).astype(np.int32)
    w = rng.integers(0, 4, (n, T)).astype(np.uint8)
    if edges:
        w[rng.random((n, T)) < 0.05] = 255
    return nid, br, cls, w


def operand_emulation(nid, br, cls, w, N, B, C):
    """The kernel's contraction in PyTorch: u8 A (n, T*N) and Bm (n,
    C*S*B), their int32 product summed over 32-row k-steps (rows padded
    with zeros), scattered back to (T,N,S,B,C) float32."""
    nid, br, cls, w = (torch.from_numpy(a) for a in (nid, br, cls, w))
    n, T = nid.shape
    S = br.shape[1]
    pad = -n % 32
    A = torch.zeros((n + pad, T * N), dtype=torch.uint8)
    rows, trees = ((nid >= 0) & (nid < N)).nonzero(as_tuple=True)
    A[rows, trees * N + nid[rows, trees]] = w[rows, trees]
    Bm = torch.zeros((n + pad, C * S * B), dtype=torch.uint8)
    ok = (br >= 0) & (br < B) & ((cls >= 0) & (cls < C))[:, None]
    rows, splits = ok.nonzero(as_tuple=True)
    Bm[rows, cls[rows] * S * B + splits * B + br[rows, splits]] = 1
    P = torch.zeros((T * N, C * S * B), dtype=torch.int32)
    for k0 in range(0, n + pad, 32):
        P += A[k0:k0 + 32].to(torch.int32).T @ Bm[k0:k0 + 32].to(torch.int32)
    return P.reshape(T, N, C, S, B).permute(0, 1, 3, 4, 2).to(
        torch.float32).numpy()


def _mma_16x8x32(ra, rb):
    """One m16n8k32 u8 mma from the warp's fragment registers, as the PTX
    ISA lays them out: ra[r] (8 groups, 4 lanes, 4 bytes) for A registers
    r = 0..3, rb[r] for B registers 0..1; returns the (16, 8) product."""
    g = np.arange(8)[:, None, None]
    kk = np.arange(4)[None, :, None] * 4 + np.arange(4)[None, None, :]
    A = np.zeros((16, 32), np.int64)
    A[g, kk] = ra[0]
    A[g + 8, kk] = ra[1]
    A[g, kk + 16] = ra[2]
    A[g + 8, kk + 16] = ra[3]
    Bt = np.zeros((8, 32), np.int64)            # (n, k)
    Bt[g, kk] = rb[0]
    Bt[g, kk + 16] = rb[1]
    return A @ Bt.T


def op_byte(row, r):
    """``csrc/histogram.cu`` ``op_byte``: byte r of operand row ``row``."""
    return row * histogram.MMA_OP_STRIDE + r


def _ldmatrix(op, addrs):
    """``ldmatrix .b16`` from the flat byte buffer ``op``: ``addrs`` (q, 8)
    are the 16-byte row addresses lanes 8q..8q+7 give; lane (g, tig)
    receives row g, 32-bit word tig of each matrix: (q, 8, 4, 4) bytes."""
    rows = op[addrs[..., None] + np.arange(16)]
    return rows.reshape(addrs.shape[0], 8, 4, 4)


def kernel_emulation(nid, br, cls, w, N, B, C):
    """``level_counts_mma_kernel`` lane by lane (numpy): per slab, per
    128-row tile, the operand bytes scattered as the kernel writes them
    (rows of ``MMA_OP_STRIDE`` bytes: A's slab rows, then Bm's), each
    warp's fragments loaded through its lanes' ldmatrix row addresses (the
    warp grid ``mma_plan`` picks), and the int32 sums flushed as the kernel
    adds them into ``out``."""
    n, T = nid.shape
    S = br.shape[1]
    plan = histogram.mma_plan(T, N, S, B, C)
    R, SB, W = histogram.MMA_ROWS, S * B, histogram.MMA_OP_STRIDE
    MT, NT = histogram.MMA_WARP_TILES[plan.shape]
    wn = plan.wn
    wm = histogram.MMA_WARPS // wn
    out = np.zeros(T * N * SB * C, np.float64)
    lane = np.arange(32)
    g = np.arange(8)[:, None]
    tig = np.arange(4)[None, :]
    b_first = plan.slab_tiles * 16 * W
    for slab in range(plan.slabs):
        first = slab * plan.slab_tiles
        m_lo = first * 16
        slab_tiles = min(plan.slab_tiles, plan.m_tiles - first)
        # each warp's (m-tile, n-tile) pairs: every tile of the slab once
        owned = {}
        for warp in range(histogram.MMA_WARPS):
            wi, wj = divmod(warp, wn)
            for u in range(MT):
                for v in range(NT):
                    mt, nt = wi + wm * u, wj + wn * v
                    if mt < slab_tiles and nt < plan.n_tiles:
                        assert (mt, nt) not in owned
                        owned[(mt, nt)] = (warp, u, v)
        assert len(owned) == slab_tiles * plan.n_tiles
        acc = {key: np.zeros((16, 8), np.int64) for key in owned.values()}
        for r0 in range(0, n, R):
            rows = min(R, n - r0)
            op = np.zeros(histogram.operand_bytes(plan.slab_tiles,
                                                  plan.n_tiles), np.uint8)
            j = np.arange(rows * T)
            row, t = j // T, j % T
            node = nid[r0:r0 + rows].reshape(-1)
            wv = w[r0:r0 + rows].reshape(-1)
            m = t * N + node - m_lo
            ok = (node >= 0) & (node < N) & (wv != 0) & (m >= 0) \
                & (m < slab_tiles * 16)
            op[op_byte(m[ok], row[ok])] = wv[ok]
            j = np.arange(rows * S)
            row, s = j // S, j % S
            b = br[r0:r0 + rows].reshape(-1)
            c = cls[r0:r0 + rows][row]
            ok = (b >= 0) & (b < B) & (c >= 0) & (c < C)
            op[b_first + op_byte((c * SB + s * B + b)[ok], row[ok])] = 1
            for warp in range(histogram.MMA_WARPS):
                wi, wj = divmod(warp, wn)
                arow = []
                for u in range(MT):
                    mt = wi + wm * u
                    mt = mt if mt < slab_tiles else 0
                    arow.append(mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7))
                brow = []
                for v2 in range(NT // 2):
                    nt = wj + wn * (2 * v2 + (lane >> 4))
                    brow.append(np.where(nt < plan.n_tiles, nt, 0) * 8
                                + (lane & 7))
                for ks in range(-(-rows // 32)):
                    achunk = (2 * ks + (lane >> 4)) * 16
                    bchunk = (2 * ks + ((lane >> 3) & 1)) * 16
                    af = [_ldmatrix(op, op_byte(x, achunk).reshape(4, 8))
                          for x in arow]
                    bf = []
                    for x in brow:
                        four = _ldmatrix(op, (b_first + op_byte(x, bchunk))
                                         .reshape(4, 8))
                        bf += [four[0:2], four[2:4]]
                    for u in range(MT):
                        for v in range(NT):
                            key = (warp, u, v)
                            if key in acc:
                                acc[key] += _mma_16x8x32(af[u], bf[v])
        M, cols = T * N, C * SB
        for (mt, nt), key in owned.items():
            for h in range(4):
                # lane (g, tig)'s accumulator h: row g (+8), column 2 tig (+1)
                mm = m_lo + mt * 16 + g + (h >> 1) * 8
                col = nt * 8 + tig * 2 + (h & 1)
                v = acc[key][g + (h >> 1) * 8, tig * 2 + (h & 1)]
                live = (v != 0) & (mm < M) & (col < cols)
                c, r = col // SB, col % SB
                np.add.at(out, (mm * SB * C + r * C + c)[live], v[live])
    return out.reshape(T, N, S, B, C).astype(np.float32)


def _plain(nid, br, cls, w, N, B, C):
    return histogram.forest_level_counts_torch(
        *(torch.from_numpy(a) for a in (nid, br, cls, w)), N, B, C).numpy()


@pytest.mark.parametrize("n", [1, 31, 1000])
@pytest.mark.parametrize("edges", [False, True], ids=["valid", "edges"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_operand_emulation_equals_count_body_pallas_and_plain(name, edges, n):
    shape = SHAPES[name]
    T, N, S, B, C = shape
    nid, br, cls, w = level_inputs(n + len(name), n, shape, edges)
    got = operand_emulation(nid, br, cls, w, N, B, C)
    assert got.shape == shape
    np.testing.assert_array_equal(got, _plain(nid, br, cls, w, N, B, C))
    np.testing.assert_array_equal(
        got, np.asarray(_COUNT_JIT(nid, br, cls, w, N, B, C)))
    np.testing.assert_array_equal(
        got, np.asarray(pallas_counts(nid, br, cls, w, N, B, C,
                                      interpret=True)))


@pytest.mark.parametrize("n", [1, 100, 300])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_emulation_equals_plain(name, n):
    shape = SHAPES[name]
    T, N, S, B, C = shape
    nid, br, cls, w = level_inputs(7 * n + len(name), n, shape)
    np.testing.assert_array_equal(kernel_emulation(nid, br, cls, w, N, B, C),
                                  _plain(nid, br, cls, w, N, B, C))


def test_kernel_emulation_counts_every_weight_once():
    """One row a tree in node N-1, weight 255, every split valid: each
    (tree, split) cell of class 0 holds exactly 255 after the flush."""
    T, N, S, B, C = SHAPES["bench"]
    nid = np.full((1, T), N - 1, np.int32)
    br = np.ones((1, S), np.int32)
    cls = np.zeros(1, np.int32)
    w = np.full((1, T), 255, np.uint8)
    got = kernel_emulation(nid, br, cls, w, N, B, C)
    assert got.sum() == 255 * T * S
    assert (got[:, N - 1, :, 1, 0] == 255).all()


@pytest.mark.parametrize("name,mma", [("rafo", True), ("rafo_root", True),
                                      ("bench", True), ("tree", True),
                                      ("deep", True), ("slabs", True)])
def test_plan_fits_the_kernel(name, mma):
    T, N, S, B, C = SHAPES[name]
    plan = histogram.mma_plan(T, N, S, B, C)
    assert (plan is not None) is mma
    assert plan.m_tiles == -(-T * N // 16)
    assert plan.n_tiles == -(-C * S * B // 8)
    assert plan.slabs == -(-plan.m_tiles // plan.slab_tiles)
    assert plan.slabs <= histogram.MMA_SLABS_MAX
    wn = plan.wn
    wm = histogram.MMA_WARPS // wn
    MT, NT = histogram.MMA_WARP_TILES[plan.shape]
    assert -(-plan.slab_tiles // wm) <= MT and -(-plan.n_tiles // wn) <= NT
    assert NT % 2 == 0           # B fragments load two n-tiles at a time
    # an ldmatrix phase's 8 rows (8-aligned) read one 16-byte chunk each:
    # the padded row stride puts them on 32 distinct banks
    for base in (0, 8, 64):
        for chunk in range(histogram.MMA_ROWS // 16):
            banks = {(op_byte(base + r, chunk * 16) // 4 + x) % 32
                     for r in range(8) for x in range(4)}
            assert len(banks) == 32
    assert plan.smem_bytes == 2 * histogram.stage_bytes(T, S) + \
        2 * histogram.operand_bytes(plan.slab_tiles, plan.n_tiles)
    assert plan.smem_bytes <= histogram.SMEM_LIMIT
    if name == "slabs":
        assert plan.slabs == 2


@pytest.mark.parametrize("shape,wdtype,form", [
    ((9, 8, 19, 2, 2), torch.uint8, "mma"),
    ((9, 1, 19, 2, 2), torch.uint8, "mma"),
    ((9, 4, 19, 2, 2), torch.uint8, "mma"),
    ((9, 2, 19, 2, 2), torch.uint8, "mma"),
    ((16, 8, 19, 2, 2), torch.uint8, "mma"),
    ((16, 1, 19, 2, 2), torch.uint8, "mma"),
    ((1, 8, 19, 2, 3), torch.uint8, "mma"),
    ((9, 8, 19, 2, 2), torch.float32, "atomic"),
    ((16, 8, 19, 2, 2), torch.float32, "atomic"),
    ((64, 128, 64, 4, 4), torch.uint8, "atomic"),
    ((64, 128, 64, 4, 4), torch.float32, "atomic"),
])
def test_level_form(shape, wdtype, form):
    assert histogram.level_form(*shape, wdtype) == form


def test_forced_form_on_cpu_keeps_the_plain_answer():
    """On CPU tensors the ``form`` keyword leaves the plain version's
    answer; an unknown form is refused."""
    T, N, S, B, C = SHAPES["rafo"]
    arrays = level_inputs(3, 200, SHAPES["rafo"])
    want = _plain(*arrays, N, B, C)
    for form in ("mma", "atomic"):
        got = histogram.forest_level_counts(
            *(torch.from_numpy(a) for a in arrays), N, B, C, form=form)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="form"):
        histogram.forest_level_counts(
            *(torch.from_numpy(a) for a in arrays), N, B, C, form="tiles")


def test_cuda_launch_refuses_mma_where_the_level_does_not_take_it():
    """The mma form takes uint8 weights only: forcing it on float32
    weights raises before any launch (no fallback to the atomic form)."""
    T, N, S, B, C = SHAPES["rafo"]
    nid, br, cls, w = (torch.from_numpy(a) for a in
                       level_inputs(4, 10, SHAPES["rafo"]))
    before = (histogram.launches, histogram.mma_launches)
    with pytest.raises(ValueError, match="mma form"):
        histogram._launch(nid, br, cls, w.to(torch.float32), N, B, C, "mma")
    assert (histogram.launches, histogram.mma_launches) == before


def test_knockout_cuts_apply_to_the_kernel_source():
    """``kernels/b1_knockouts.py`` times copies of the mma kernel with one
    part cut out; each cut is a text substitution that must match the
    source exactly once (and change it), or the tool measures nothing."""
    from avenir_tpu_torch.kernels import b1_knockouts, build
    src = (build.CSRC_DIR / "histogram.cu").read_text()
    for name, subs in b1_knockouts.CUTS.items():
        for old, new in subs:
            assert src.count(old) == 1 and old != new, name

