"""The index scheme of the Hopper K2 kernel, and its weight packing.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_double_conv_tiling.py -q

K2's CUDA sources (`csrc/double_conv3x3*.cu`) cannot run on the CPU, so
their index arithmetic is rebuilt here step by step in plain PyTorch
(`tiled_model`): tiles with a halo, staged as [position][channel] with one
pitch, each tap a shift of the flattened position, positions in 64-row
wgmma tiles, conv1 in chunks
of the intermediate channels split over the CTAs of a cluster (rank r
computes channels [r * ch / cl, (r + 1) * ch / cl) of each chunk and every
CTA receives the whole chunk), rounded to the input dtype, folded into
each CTA's conv2 accumulators for its n2 output channels, the wrapped
columns dropped at the store.  It reads the weights the way the kernel's
producer copies them: each stage's block of the packed arrays at the
producer's offset, decoded through the swizzled image address
(`b_image_index`).  Held against `double_conv3x3_plain`: float32 to rtol
1e-4 / atol 1e-5 (sums in another order, the weights as TF32 hi + lo),
bfloat16 to 2e-2 of the output scale (one flipped rounding of the
intermediate moves an output by a bf16 step).
"""
import pytest
import torch

from uncltmo_tpu_torch.models.blocks import DoubleConv, DoubleConvT
from uncltmo_tpu_torch.ops.kernels.double_conv import (
    _CFGS, Plan, default_plan, double_conv3x3_plain, pack_double_conv_weights,
    packed_sizes, padded_c2)
from uncltmo_tpu_torch.ops.kernels.packing import (
    b_image_index, tf32_round, tf32_split, weights_key)

SMEM_LIMIT = 232448            # bytes a block may use on an H100
SCR_LD = 68                    # the epilogue scratch's row, floats


def _round_up(n, m):
    return -(-n // m) * m


def tile_geometry(th, tw, cin1=False):
    """Pitch and flattened extents of a TH x TW output tile, as the kernel
    reckons them: conv2 covers M2 positions, conv1 M1 (far enough for
    conv2's last shift), both in whole 64-row wgmma tiles (conv1 on the
    CUDA cores when Cin == 1: 8-row groups), the input NPOS (far enough for
    conv1's)."""
    p = tw + 4
    m2 = _round_up(th * p, 64)
    m1 = _round_up(m2 + 2 * p + 2, 8 if cin1 else 64)
    return p, m2, m1, m1 + 2 * p + 2


def smem_bytes(cfg, dtype, cin1):
    """Shared memory of a block of configuration `cfg`, as the source lays
    it out: bfloat16 (TH, TW, NWG, CH, C2P, CL, CINC, TG, NST), `Smem`;
    float32 (TH, TW, NWG, CH, NB, C2P, CL, CINC, CINS, TG, NST, D2), the
    persistent kernel's `PSmem` (one plane of A, the intermediate in one
    or two buffers)."""
    if dtype == torch.float32:
        th, tw, nwg, ch, nb, c2p, cl, cinc, cins, tg, nst, _ = cfg
        p, m2, m1, npos = tile_geometry(th, tw, cin1)
        slot = _round_up(tg * 2 * 4 * max(0 if cin1 else cinc * nb,
                                          ch * c2p // cl), 1024)
        in_b = _round_up(npos * (1 if cin1 else cins) * 4, 128)
        mid = _round_up(m1 * nb * cl * 4, 128)
        assert mid >= nwg * 16 * SCR_LD * 4       # the epilogue's scratch
        rest = (_round_up((2 * nst + 3) * 8, 128)
                + (10 * nb * cl * 4 if cin1 else 0) + 1024)
        # two buffers of the intermediate where they fit, else one
        mids = 2 if nst * slot + in_b + 2 * mid + rest <= SMEM_LIMIT else 1
        return nst * slot + in_b + mids * mid + rest
    th, tw, nwg, ch, c2p, cl, cinc, tg, nst = cfg
    es = torch.finfo(dtype).bits // 8
    planes = 2 if es == 4 else 1
    p, m2, m1, npos = tile_geometry(th, tw, cin1)
    n1, n2 = ch // cl, c2p // cl
    slot = _round_up(tg * planes * es * max(0 if cin1 else cinc * n1,
                                            ch * n2), 1024)
    in_b = _round_up(max(npos * es if cin1 else planes * npos * cinc * es,
                         nwg * 16 * SCR_LD * 4), 128)
    mid = _round_up(planes * m1 * ch * es, 128)
    return (nst * slot + in_b + 2 * mid + _round_up((2 * nst + 2) * 8, 128)
            + (10 * ch * 4 if cin1 else 0) + 1024)


def b_image(flat, k, n, dtype):
    """(planes, k, n) from one stage image of the packed weights: what the
    wgmma descriptors read for k channels x n outputs."""
    es = torch.finfo(dtype).bits // 8
    planes = 2 if es == 4 else 1
    idx = b_image_index(k, n, es)
    return flat.reshape(planes, k * n)[:, idx]


def conv1_block(pk, plan, dtype, jb, rank, i, tap):
    """The (planes, K_i, n1) image conv1's stage holds for conv1 block jb
    (ch1 channels a cluster, n1 = ch1 / cl a CTA), CTA rank, Cin chunk i
    and tap, at the producer's offset."""
    planes = 2 if dtype == torch.float32 else 1
    n1 = plan.ch1 // plan.cl
    k = min(plan.cinc, plan.cinp - i * plan.cinc)
    off = ((jb * plan.cl + rank) * 9 * plan.cinp + 9 * i * plan.cinc
           + tap * k) * planes * n1
    return b_image(pk.w1[off:off + planes * k * n1], k, n1, dtype)


def conv2_block(pk, plan, dtype, y, j, rank, tap):
    """The (planes, ch, n2) image conv2's stage holds for C2 pass y, C1
    chunk j, CTA rank and tap."""
    planes = 2 if dtype == torch.float32 else 1
    n_j = plan.c1p // plan.ch
    off = (((y * n_j + j) * plan.cl + rank) * 9 + tap) * plan.ch \
        * planes * plan.n2
    return b_image(pk.w2[off:off + planes * plan.ch * plan.n2], plan.ch,
                   plan.n2, dtype)


def unpack(pk, plan, c1, cin, c2, dtype):
    """OIHW weights back from the packed arrays (float32: hi + lo), and
    asserts that the padding is zero."""
    n1, n_j = plan.ch1 // plan.cl, plan.c1p // plan.ch
    w1 = torch.zeros(plan.c1p, max(plan.cinp, cin), 3, 3, dtype=torch.float64)
    if plan.cinp == 1:
        w1[:, 0] = pk.w1.double().reshape(3, 3, plan.c1p).permute(2, 0, 1)
    else:
        for jb in range(plan.c1p // plan.ch1):
            for r in range(plan.cl):
                for i in range(-(-plan.cinp // plan.cinc)):
                    for tap in range(9):
                        img = conv1_block(pk, plan, dtype, jb, r, i,
                                          tap).double().sum(0)
                        co = jb * plan.ch1 + r * n1
                        ci = i * plan.cinc
                        w1[co:co + n1, ci:ci + img.shape[0], tap // 3,
                           tap % 3] = img.T
    w2 = torch.zeros(plan.c2p, plan.c1p, 3, 3, dtype=torch.float64)
    for y in range(plan.c2p // (plan.cl * plan.n2)):
        for j in range(n_j):
            for r in range(plan.cl):
                for tap in range(9):
                    img = conv2_block(pk, plan, dtype, y, j, r,
                                      tap).double().sum(0)
                    co = (y * plan.cl + r) * plan.n2
                    w2[co:co + plan.n2, j * plan.ch:(j + 1) * plan.ch,
                       tap // 3, tap % 3] = img.T
    assert not w1[c1:].any() and not w1[:, cin:].any()
    assert not w2[c2:].any() and not w2[:, c1:].any()
    return w1[:c1, :cin], w2[:c2, :c1]


def persistent_walk(n_items, grid):
    """The work items (image, C2 pass, tile) that each CTA, or cluster, of
    a grid of `grid` takes, in its order: from its index in steps of the
    grid, as the persistent kernel walks them."""
    return [range(c, n_items, grid) for c in range(grid)]


def tiled_model(x, w1, b1, w2, b2, plan, ctas=132, kstep=None):
    """The kernel's walk: work items item = (image * passes + pass) *
    tiles + tile, taken by `ctas` / cl persistent CTAs (clusters) in
    `persistent_walk`'s order (one item a CTA when the plan is not
    persistent); in each, conv1 in blocks of ch1 intermediate channels
    over the Cin chunks, taps and k-steps, and conv2 folding each block as
    sub-chunks of ch channels.  `kstep` None multiplies a stage's chunk at
    once; 8 joins each k-step's partial (its products summed exactly,
    rounded to float32 once) to the float32 accumulator by an add, in the
    kernel's order of joins."""
    b, cin, h, w = x.shape
    c1, c2 = w1.shape[0], w2.shape[0]
    dtype = x.dtype
    pk = pack_double_conv_weights(w1, b1, w2, b2, plan)
    cin1 = plan.cinp == 1
    th, tw, ch, ch1, cl, n2 = (plan.th, plan.tw, plan.ch, plan.ch1, plan.cl,
                               plan.n2)
    n1, n_b = ch1 // cl, plan.c1p // ch1
    n_i = 0 if cin1 else -(-plan.cinp // plan.cinc)
    b1p = torch.zeros(plan.c1p).index_copy_(0, torch.arange(c1), b1.float())
    b2p = torch.zeros(plan.c2p).index_copy_(0, torch.arange(c2), b2.float())
    p, m2, m1, npos = tile_geometry(th, tw, cin1)
    ho, wo = h - 4, w - 4
    tiles_x = -(-wo // tw)
    tiles = tiles_x * -(-ho // th)
    passes = plan.c2p // (cl * n2)
    n_items = b * passes * tiles
    grid = min(n_items, ctas // cl) if plan.persistent else n_items
    y = torch.full((b, c2, ho, wo), float("nan"))
    q = torch.arange(m2)
    row, col = q // p, q % p

    def weights(img):                       # (planes, k, n) -> float32
        return img.float().sum(0)

    def join(acc, a, wt):
        if kstep is None:
            return acc + a @ wt
        for k0 in range(0, a.shape[1], kstep):
            part = torch.zeros(acc.shape, dtype=torch.float64)
            for k in range(k0, min(k0 + kstep, a.shape[1])):
                part += a[:, k, None].double() * wt[None, k].double()
            acc = acc + part.float()
        return acc

    for walk in persistent_walk(n_items, grid):
        for item in walk:
            img, yp = item // (passes * tiles), (item // tiles) % passes
            ty0, tx0 = (item % tiles // tiles_x) * th, (item % tiles_x) * tw
            # the input tile, zero beyond the image, the tile's rows and
            # the real channels
            in_s = torch.zeros(npos, max(plan.cinp, cin), dtype=dtype)
            rows, cols = min(th + 4, h - ty0), min(p, w - tx0)
            grid_in = torch.zeros(cin, th + 4, p, dtype=dtype)
            grid_in[:, :rows, :cols] = x[img, :, ty0:ty0 + rows,
                                         tx0:tx0 + cols]
            in_s[:(th + 4) * p, :cin] = grid_in.reshape(cin, -1).T
            acc2 = [torch.zeros(m2, n2) for _ in range(cl)]
            for jb in range(n_b):
                # every CTA of the cluster ends up with the whole block
                mid = torch.zeros(m1, ch1)
                for r in range(cl):
                    acc1 = torch.zeros(m1, n1)
                    lo = jb * ch1 + r * n1
                    if cin1:
                        for tap in range(9):
                            s = (tap // 3) * p + tap % 3
                            assert s + m1 <= npos
                            acc1 += in_s[s:s + m1, :1].float() * \
                                pk.w1.reshape(9, -1)[tap, lo:lo + n1].float()
                    for i in range(n_i):
                        k = min(plan.cinc, plan.cinp - i * plan.cinc)
                        for tap in range(9):
                            s = (tap // 3) * p + tap % 3
                            assert s + m1 <= npos
                            acc1 = join(
                                acc1, in_s[s:s + m1, i * plan.cinc:
                                           i * plan.cinc + k].float(),
                                weights(conv1_block(pk, plan, dtype, jb, r, i,
                                                    tap)))
                    mid[:, r * n1:(r + 1) * n1] = torch.relu(
                        acc1 + b1p[lo:lo + n1]).to(dtype).float()
                for jj in range(ch1 // ch):
                    j = jb * (ch1 // ch) + jj
                    for r in range(cl):
                        for tap in range(9):
                            s = (tap // 3) * p + tap % 3
                            assert s + m2 <= m1
                            acc2[r] = join(
                                acc2[r], mid[s:s + m2, jj * ch:(jj + 1) * ch],
                                weights(conv2_block(pk, plan, dtype, yp, j, r,
                                                    tap)))
            # output channel (pass, rank, n) = (pass * cl + rank) * n2 + n
            c0 = yp * cl * n2
            out = torch.relu(torch.cat(acc2, dim=1)
                             + b2p[c0:c0 + cl * n2]).to(dtype)
            keep = ((row < th) & (col < tw) & (ty0 + row < ho)
                    & (tx0 + col < wo))
            co = min(c2, c0 + cl * n2)
            assert torch.isnan(y[img, c0:co, ty0 + row[keep],
                                 tx0 + col[keep]]).all()   # stored once
            y[img, c0:co, ty0 + row[keep], tx0 + col[keep]] = \
                out[keep][:, :co - c0].float().T
    assert not torch.isnan(y).any()          # every output was stored
    return y.to(dtype)


def _inputs(seed, b, cin, c1, c2, h, w, dtype):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(dtype)

    return (torch.rand(b, cin, h, w, generator=g).to(dtype),
            rnd(c1, cin, 3, 3, std=(2 / (9 * cin)) ** 0.5), rnd(c1, std=0.1),
            rnd(c2, c1, 3, 3, std=(2 / (9 * c1)) ** 0.5), rnd(c2, std=0.1))


def _check(out, ref, dtype):
    assert out.shape == ref.shape
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
    else:
        assert (out - ref).abs().max() <= 2e-2 * ref.abs().max()


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["f32", "bf16"])

# (name, Cin, C1, C2, H, W): the four cells at a quarter of their width
# and a small size, each on the source's configuration for its channels,
# then Cin = 1, ragged sizes, channel counts that need padding, more input
# channels than one staging chunk and more than 128 output channels (the
# cluster configuration)
CASES = [
    ("inc", 1, 8, 8, 40, 40),
    ("down0", 8, 16, 16, 34, 34),
    ("down1", 16, 32, 32, 23, 23),
    ("down2", 32, 64, 64, 16, 12),
    ("down1_f32_tile", 16, 32, 32, 23, 23),
    ("two_chunks", 4, 80, 8, 14, 13),
    ("ragged_37x40", 16, 24, 16, 37, 40),
    ("ragged_29x33", 8, 24, 8, 29, 33),
    ("smallest", 3, 5, 7, 5, 5),
    ("cluster_c2_160", 16, 40, 160, 12, 14),
    ("cin_144", 144, 24, 8, 9, 10),
]


@DTYPES
@pytest.mark.parametrize("name,cin,c1,c2,h,w", CASES,
                         ids=[c[0] for c in CASES])
def test_tiled_scheme_matches_plain(name, cin, c1, c2, h, w, dtype):
    args = _inputs(3, 2 if cin < 100 else 1, cin, c1, c2, h, w, dtype)
    out = tiled_model(*args, default_plan(cin, c1, c2, dtype)).float()
    _check(out, double_conv3x3_plain(*args).float(), dtype)


@DTYPES
@pytest.mark.parametrize("cl", [1, 2, 4])
def test_tiled_scheme_with_clusters(cl, dtype):
    """The cluster split at every size, on plans of its own: 2 x 16
    intermediate channels a chunk, 64 outputs a cluster, two C2 passes;
    float32 as the persistent kernel walks it, conv1 in one block of both
    chunks over 4 CTAs (clusters)."""
    args = _inputs(5, 1, 6, 40, 100, 11, 13, dtype)
    f32 = dtype == torch.float32
    plan = Plan(cinp=16, cinc=16, c1p=64, ch=32, cl=cl, n2=64 // cl,
                c2p=128, th=3, tw=6, tg=3, nst=2, nwg=2, ch1=64 if f32 else 32,
                persistent=int(f32))
    _check(tiled_model(*args, plan, ctas=4 * cl).float(),
           double_conv3x3_plain(*args).float(), dtype)


@pytest.mark.parametrize("n_items,ctas", [(1, 132), (96, 66), (2160, 132),
                                           (7, 3), (133, 132)])
def test_persistent_walk_covers_each_item_once(n_items, ctas):
    """The grid is min(items, CTAs resident at once); its CTAs together
    take each work item exactly once, and none takes two more than
    another."""
    grid = min(n_items, ctas)
    walks = persistent_walk(n_items, grid)
    taken = sorted(i for walk in walks for i in walk)
    assert taken == list(range(n_items))
    sizes = [len(walk) for walk in walks]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("cin,c1,c2", [(8, 64, 72), (8, 64, 136)],
                         ids=["down1_blocks", "down2_cluster_blocks"])
def test_float32_blocks_keep_the_join_order(cin, c1, c2):
    """conv1 in blocks of ch1 channels (32; 64 over a cluster of 2) with
    conv2 folding them as ch-channel sub-chunks joins every k-step's
    partial in the order of the one-chunk-at-a-time walk: the two runs of
    the model, each k-step's partial added to a float32 accumulator, are
    equal bit for bit."""
    args = _inputs(9, 1, cin, c1, c2, 9, 12, torch.float32)
    plan = default_plan(cin, c1, c2, torch.float32)
    assert plan.ch1 > plan.ch and plan.persistent
    chunks = plan._replace(ch1=plan.ch, persistent=0)
    new = tiled_model(*args, plan, ctas=2 * plan.cl, kstep=8)
    old = tiled_model(*args, chunks, kstep=8)
    assert torch.equal(new, old)
    _check(new, double_conv3x3_plain(*args), torch.float32)


GEOMETRIES = sorted({(c[0], c[1], k == "inc")
                     for t in _CFGS.values() for k, c in t.items()}
                    | {(12, 28, False), (8, 31, False), (10, 19, False),
                       (8, 19, False), (12, 8, False), (8, 8, False),
                       (8, 28, True), (5, 19, False)})


@pytest.mark.parametrize("th,tw,cin1", GEOMETRIES)
def test_tile_geometry_keeps_every_shift_in_bounds(th, tw, cin1):
    p, m2, m1, npos = tile_geometry(th, tw, cin1)
    last = 2 * p + 2
    assert m2 % 64 == 0 and m1 % (8 if cin1 else 64) == 0
    assert m2 >= th * p and m2 - 1 + last < m1 and m1 - 1 + last < npos
    # a stored output never reads a wrapped column or a row below the halo
    assert (tw - 1) + 2 <= p - 3 and (th - 1) + 2 < th + 2
    assert (th + 1) * p + (tw + 1) + last < (th + 4) * p
    # the A descriptor's core-matrix stride (positions * 16 bytes) fits its
    # 14-bit field
    assert npos * 16 >> 4 < 1 << 14


@pytest.mark.parametrize("cin,c1,c2,want", [
    (1, 32, 32, (1, 32, 32)), (32, 64, 64, (32, 64, 64)),
    (64, 128, 128, (64, 128, 128)), (128, 256, 256, (128, 256, 256)),
    (8, 24, 8, (16, 32, 32)), (3, 33, 65, (16, 64, 128)),
    (20, 80, 300, (32, 128, 512))])
def test_padded_channels(cin, c1, c2, want):
    """bfloat16: Cin to a whole swizzle row (16, 32 or 64k; 1 when conv1
    runs on the CUDA cores), C1 to whole chunks, C2 to a configuration's
    width."""
    plan = default_plan(cin, c1, c2, torch.bfloat16)
    assert (plan.cinp, plan.c1p, plan.c2p) == want


@pytest.mark.parametrize("cin,c1,c2,want", [
    (1, 32, 32, (1, 32, 32)), (32, 64, 64, (32, 64, 64)),
    (64, 128, 128, (64, 128, 128)), (128, 256, 256, (128, 256, 256)),
    (8, 24, 8, (16, 32, 32)), (40, 33, 65, (64, 64, 128)),
    (144, 80, 300, (160, 128, 512))])
def test_padded_channels_float32(cin, c1, c2, want):
    """float32: Cin to 16, 32 or 32k (a 128-byte row is 32 floats), C1 to
    whole conv1 blocks (`ch1`: 32 at 128 outputs, 64 beyond)."""
    plan = default_plan(cin, c1, c2, torch.float32)
    assert (plan.cinp, plan.c1p, plan.c2p) == want
    assert plan.c2p == padded_c2(c2)


@DTYPES
def test_pack_layout_and_zero_padding(dtype):
    x, w1, b1, w2, b2 = _inputs(4, 1, 8, 24, 8, 9, 9, dtype)
    plan = default_plan(8, 24, 8, dtype)
    pk = pack_double_conv_weights(w1, b1, w2, b2, plan)
    assert (pk.w1.numel(), pk.w2.numel()) == packed_sizes(
        plan, w1.element_size())
    assert pk.w1.dtype == pk.w2.dtype == dtype
    assert pk.w1.is_contiguous() and pk.w2.is_contiguous()
    u1, u2 = unpack(pk, plan, 24, 8, 8, dtype)          # asserts the zeros
    tol = 0 if dtype == torch.bfloat16 else 2 ** -21
    assert ((u1 - w1.double()).abs() <= tol * w1.double().abs()).all()
    assert ((u2 - w2.double()).abs() <= tol * w2.double().abs()).all()
    assert torch.equal(pk.b1, b1) and torch.equal(pk.b2, b2)


CHANNELS = [(1, 32, 32), (32, 64, 64), (64, 128, 128), (128, 256, 256),
            (3, 5, 7), (5, 24, 80), (7, 80, 24), (24, 3, 5), (80, 7, 3)]


@DTYPES
@pytest.mark.parametrize("cin,c1,c2", CHANNELS)
def test_stage_images_round_trip_oihw(cin, c1, c2, dtype):
    """Every stage image decodes back to the OIHW weights (float32: hi + lo
    within 2^-21 of w), at the cells' channel counts and ragged ones."""
    _, w1, b1, w2, b2 = _inputs(6, 1, cin, c1, c2, 5, 5, dtype)
    plan = default_plan(cin, c1, c2, dtype)
    u1, u2 = unpack(pack_double_conv_weights(w1, b1, w2, b2, plan), plan,
                    c1, cin, c2, dtype)
    tol = 0 if dtype == torch.bfloat16 else 2 ** -21
    assert ((u1 - w1.double()).abs() <= tol * w1.double().abs()).all()
    assert ((u2 - w2.double()).abs() <= tol * w2.double().abs()).all()


@pytest.mark.parametrize("k,n,es", [(16, 8, 2), (32, 16, 2), (64, 32, 2),
                                    (128, 8, 2), (192, 40, 2), (16, 8, 4),
                                    (32, 24, 4), (64, 16, 4), (96, 8, 4)])
def test_b_image_index_is_a_bijection(k, n, es):
    """The swizzled address takes every (k, n) to its own element of the
    image, keeps each 8-row group's 16-byte chunks within their row, and
    puts the 8 rows of a chunk column in 8 different bank groups of a
    128-byte swizzle (fewer for 64 / 32)."""
    idx = b_image_index(k, n, es)
    assert sorted(idx.flatten().tolist()) == list(range(k * n))
    s = min(k * es, 128)
    row = idx * es // s                      # the row within column blocks
    assert ((row % n) == torch.arange(n)[None, :]).all()
    chunks = (idx * es % s) // 16
    assert len(set(chunks[0, :8].tolist())) == s // 16


def test_tf32_split_planes():
    g = torch.Generator().manual_seed(7)
    w = torch.randn(4096, generator=g) * torch.logspace(-6, 6, 4096)
    hi, lo = tf32_split(w)
    for part in (hi, lo):                    # both exact TF32
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert ((hi + lo - w).abs() <= 2 ** -21 * w.abs()).all()
    # round to nearest, ties away from zero, as cvt.rna.tf32.f32
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12])
    assert tf32_round(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0]


@pytest.mark.parametrize("cl,ch,c1p,c2p", [(1, 32, 64, 32), (2, 64, 256, 256),
                                            (4, 128, 256, 256),
                                            (4, 64, 192, 512)])
def test_cluster_plan_covers_each_channel_once(cl, ch, c1p, c2p):
    """CTA rank r of a cluster computes intermediate channels
    j * ch + r * ch / cl + [0, ch / cl) of every chunk j and output
    channels (pass * cl + r) * n2 + [0, n2): each exactly once."""
    n1, n2 = ch // cl, 256 // cl if c2p >= 256 else c2p // cl
    mids = [j * ch + r * n1 + n for j in range(c1p // ch)
            for r in range(cl) for n in range(n1)]
    outs = [(y * cl + r) * n2 + n for y in range(c2p // (cl * n2))
            for r in range(cl) for n in range(n2)]
    assert sorted(mids) == list(range(c1p))
    assert sorted(outs) == list(range(c2p))


@DTYPES
@pytest.mark.parametrize("kind", ["inc", 32, 64, 128, 256])
def test_default_shapes_fit_shared_memory(kind, dtype):
    """Each configuration of the source fits a block's 227 KB, and its
    plan pads as the kernel expects; down2 (256) runs as a cluster that
    gives a frame's rank batch (B = 8) at least one CTA an SM."""
    cfg = _CFGS[dtype][kind]
    assert smem_bytes(cfg, dtype, kind == "inc") <= SMEM_LIMIT
    if dtype == torch.float32:
        th, tw, nwg, ch, nb, c2blk, cl, cinc, cins, tg, nst, d2 = cfg
        assert nb * cl % ch == 0 and cins % cinc == 0 and d2 in (0, 1)
        assert nb in (16, 32, 64, 128) and 1 <= nwg <= 3
    else:
        th, tw, nwg, ch, c2blk, cl, cinc, tg, nst = cfg
        assert ch % (8 * cl) == 0 and 1 <= nwg <= 4
    assert 9 % tg == 0
    if kind == 256:
        tiles = -(-24 // th) * -(-24 // tw)
        assert cl > 1 and tiles * 8 * cl >= 132


def test_packed_weights_carry_no_graph():
    cell = _cell()
    pk = cell.packed_weights()
    assert not any(t.requires_grad for t in pk)


def _cell(kind="k2"):
    """A cell whose kernel reads packed weights: K2's `DoubleConv`, or the
    up cell's `DoubleConvT` (behind a concat of 4 x 32 skip channels)."""
    torch.manual_seed(0)
    return DoubleConv(4, 8) if kind == "k2" else DoubleConvT(128, 32)


def test_cache_packs_once_for_unchanged_weights():
    for kind in ("k2", "up_cell"):
        cell = _cell(kind)
        first = cell.packed_weights()
        assert cell.packed_weights() is first
        fresh = type(cell)._pack(*cell._weights())
        assert torch.equal(first.w1, fresh.w1)
        assert torch.equal(first.w2, fresh.w2)
    cell = _cell()
    plan = default_plan(4, 8, 8, torch.float32)
    u1, _ = unpack(cell.packed_weights(), plan, 8, 4, 8, torch.float32)
    w1 = cell.conv.weight.detach().double()
    assert ((u1 - w1).abs() <= 2 ** -21 * w1.abs()).all()


# K2's cell under each change; the up cell, float32 only, under those it
# can meet
CACHE_CHANGES = ([pytest.param(c, "k2", id=c)
                  for c in ("version", "dtype", "data_ptr")]
                 + [pytest.param(c, "up_cell", id=f"up_cell-{c}")
                    for c in ("version", "data_ptr")])


@pytest.mark.parametrize("change,kind", CACHE_CHANGES)
def test_cache_repacks_when_a_parameter_changes(change, kind):
    cell = _cell(kind)
    first = cell.packed_weights()
    key = weights_key(*cell._weights())
    if change == "version":              # an optimiser's in-place update
        with torch.no_grad():
            cell.conv1.weight.add_(1.0)
    elif change == "dtype":              # the engine's cast of p.data
        for p in cell.parameters():
            p.data = p.data.to(torch.bfloat16)
    else:                                # a reload into new storage
        cell.conv.weight.data = cell.conv.weight.data.clone() * 2
    assert weights_key(*cell._weights()) != key
    second = cell.packed_weights()
    assert second is not first
    fresh = type(cell)._pack(*cell._weights())
    assert second.w1.dtype == cell.conv.weight.dtype
    assert torch.equal(second.w1, fresh.w1)
    assert torch.equal(second.w2, fresh.w2)
    assert cell.packed_weights() is second


def test_cpu_forward_needs_no_packing():
    cell = _cell()
    x = torch.rand(1, 4, 9, 9)
    out = cell(x)
    assert cell._packed is None
    assert torch.equal(out, double_conv3x3_plain(x, *cell._weights()))
