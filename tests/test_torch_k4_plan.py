"""K4's plan and indices, on the CPU.

K4 (csrc/ncc.cu) runs only on the card, so what surrounds its arithmetic is
held here: a torch emulation of the kernel (blocks of a band of rows and a
column tile, the ring of input chunks, each thread's ring of the window's
rows, the shared row of vertical sums and its halo columns, the 4-wide
horizontal groups, even windows' offsets, and the loss mode's fixed-order
partials: thread items, warp butterflies, warps, then the last block's sum
of the partials in double) against ``ncc_map_plain`` and the plain loss;
negative controls (a halo off by one row, an even window's offsets
mirrored) that must fail; and ``ncc_plan`` at every timed and ragged shape.
"""

import numpy as np
import pytest
import torch
import torch_threads

from csof_tpu_torch.ops.kernels import ncc as k4

torch_threads.pin()

#: the timed shapes (the SegFlow loss at its training batch and at the bench
#: geometry) and the card tests' ragged ones, (planes, H, W, window)
TIMED = [(20, 128, 128, 9), (88, 128, 128, 9)]
RAGGED = [(2, 1, 33, 9), (2, 17, 129, 4), (1, 129, 17, 31), (3, 33, 1, 1), (1, 17, 129, 31),
          (1, 9, 7, 21), (1, 40, 300, 9), (1, 20, 600, 31), (2, 17, 257, 15), (3, 33, 70, 8)]


def _planes(n, h, w, seed=0):
    rng = np.random.RandomState(seed)
    i = rng.rand(n, h, w).astype(np.float32)
    i[:, : h // 3, : w // 3] = 0.4  # a constant region: var cancels
    j = (0.7 * i + 0.3 * rng.rand(n, h, w)).astype(np.float32)
    return torch.from_numpy(i), torch.from_numpy(j)


def _butterfly(v):
    """A warp's xor-shuffle sum (common.cuh warp_sum) over the last axis of
    32 lanes: each step adds the lane ``off`` away; lane 0's result."""
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ off]
    return v[..., 0]


def _close(i_sum, j_sum, i2, j2, ij, window, eps):
    win = float(window * window)
    i_mu, j_mu = i_sum / win, j_sum / win
    cross = ij - j_mu * i_sum - i_mu * j_sum + i_mu * j_mu * win
    i_var = i2 - 2 * i_mu * i_sum + i_mu * i_mu * win
    j_var = j2 - 2 * j_mu * j_sum + j_mu * j_mu * win
    return (cross * cross) / (i_var * j_var + eps)


def emulate(pred, target, window, plan, eps=1e-3, loss=False, row_shift=0, mirror=False):
    """K4 as csrc/ncc.cu computes it, block by block, on (planes, H, W)
    float32 planes: the map, or (loss mode) 1 - mean(clamp(cc)) through the
    kernel's partials. ``row_shift`` stages every chunk that many rows low
    (a halo off by one); ``mirror`` takes an even window's offsets the other
    way round (w/2 - 1 above, w/2 below)."""
    planes, h, w = pred.shape
    chunk, halo = k4.chunk_rows(window), k4.halo_cols(window)
    lo = -((window - 1) // 2) if mirror else -(window // 2)
    nt, tc = plan.threads, plan.tile_cols
    vw = tc + 2 * halo
    out = torch.zeros(planes, h, w)
    partials = []
    for block in range(plan.blocks):
        tile, band, plane = block % plan.tiles, (block // plan.tiles) % plan.bands, \
            block // (plan.tiles * plan.bands)
        x0, y0 = tile * tc, band * plan.band_rows
        vlo, vhi = max(x0 - halo, 0), min(x0 + tc + halo, w)
        nv = vhi - vlo
        assert 0 < nv <= nt and tc % 4 == 0 and vw % 4 == 0
        rows_out = min(plan.band_rows, h - y0)
        nchunks = -(-(rows_out + window - 1) // chunk)
        # each column's ring of the window's rows, row r in slot r % window
        # (window 9: chunks of 9 rows, so a register slot is the row's place
        # in its chunk)
        ring = torch.zeros(window, 5, nv)
        wslot = 0
        acc = torch.zeros(nt)  # each thread's clamped cc, in item order
        for ci in range(nchunks):
            # the chunk as cp.async stages it: rows y0 + lo + ci * chunk + k,
            # zero outside the plane
            ys = y0 + lo + row_shift + ci * chunk + torch.arange(chunk)
            inside = ((ys >= 0) & (ys < h)).float()[:, None]
            rows_i = pred[plane, ys.clamp(0, h - 1), vlo:vhi] * inside
            rows_j = target[plane, ys.clamp(0, h - 1), vlo:vhi] * inside
            sv = torch.zeros(chunk, 5, vw)
            for k in range(chunk):  # vertical: each thread its column
                vi, vj = rows_i[k], rows_j[k]
                assert window != k4.SPECIAL_WINDOW or wslot == k
                ring[wslot] = torch.stack([vi, vj, vi * vi, vj * vj, vi * vj])
                wslot = (wslot + 1) % window  # now the oldest row's slot
                y = ci * chunk + k - (window - 1)
                if 0 <= y < rows_out:
                    s = ring[wslot].clone()
                    for o in range(1, window):
                        s = s + ring[(wslot + o) % window]
                    sv[k, :, vlo - x0 + halo:vhi - x0 + halo] = s
            # horizontal: item (row k, group g) on thread item % nt, 4 columns
            k0 = max(window - 1 - ci * chunk, 0)
            k1 = min(chunk, rows_out + window - 1 - ci * chunk)
            ng = tc // 4
            for item in range(max(k1 - k0, 0) * ng):
                k, g = k0 + item // ng, item % ng
                x = x0 + 4 * g
                if x >= w:
                    continue
                idx = 4 * g + halo + lo + torch.arange(4)
                s = sv[k][:, idx]
                for o in range(1, window):
                    s = s + sv[k][:, idx + o]
                v = _close(*s, window, eps)
                ok = x + torch.arange(4) < w
                if loss:
                    for p in range(4):
                        if ok[p]:
                            acc[item % nt] = acc[item % nt] + v[p].clamp(0.001, 0.999)
                else:
                    y = y0 + ci * chunk + k - (window - 1)
                    out[plane, y, x:x + int(ok.sum())] = v[ok]
        if loss:  # warp butterflies, then the warps in order
            warps = _butterfly(acc.view(nt // 32, 32))
            t = warps[0]
            for wv in warps[1:]:
                t = t + wv
            partials.append(t)
    if not loss:
        return out
    # the last block: thread i adds partials i, i + nt, ... in double, then
    # a warp butterfly and the warps in order
    part = torch.stack(partials).double()
    nt_last = plan.threads
    sums = torch.zeros(nt_last, dtype=torch.float64)
    for i in range(len(part)):
        sums[i % nt_last] += part[i]
    warps = _butterfly(sums.view(nt_last // 32, 32))
    t = warps[0]
    for wv in warps[1:]:
        t = t + wv
    return torch.tensor(1.0 - float(t) / (planes * h * w), dtype=torch.float32)


def _tiled_plan(planes, h, w, window, threads, band_rows):
    """A plan forced onto narrow column tiles, so that small planes cross
    tile edges."""
    tc = (threads - 2 * k4.halo_cols(window)) // 4 * 4
    tiles, bands = -(-w // tc), -(-h // band_rows)
    return k4.NccPlan(threads, tc, band_rows, tiles, bands, planes * bands * tiles,
                      k4.smem_bytes(window, threads, tc, 4))


@pytest.mark.parametrize("n,h,w,window", [(2, 17, 33, 9), (1, 20, 23, 4), (1, 13, 9, 21),
                                          (2, 9, 12, 1), (1, 26, 19, 8), (1, 11, 40, 31)])
def test_emulated_kernel_equals_the_plain_map(n, h, w, window):
    i, j = _planes(n, h, w)
    got = emulate(i, j, window, k4.ncc_plan(n, h, w, window, 4))
    assert torch.equal(got, k4.ncc_map_plain(i, j, window))  # the same roundings in order


@pytest.mark.parametrize("h,w,window,threads,band", [(17, 70, 9, 32, 9), (20, 130, 4, 64, 8),
                                                     (13, 100, 15, 64, 16), (9, 38, 5, 32, 8)])
def test_emulated_column_tiles_equal_the_plain_map(h, w, window, threads, band):
    i, j = _planes(1, h, w, seed=1)
    plan = _tiled_plan(1, h, w, window, threads, band)
    assert plan.tiles > 1
    assert torch.equal(emulate(i, j, window, plan), k4.ncc_map_plain(i, j, window))


@pytest.mark.parametrize("what", ["halo_off_by_one_row", "even_offsets_mirrored"])
def test_negative_controls_fail(what):
    window = 9 if what == "halo_off_by_one_row" else 8
    i, j = _planes(2, 19, 21, seed=2)
    plan = k4.ncc_plan(2, 19, 21, window, 4)
    ref = k4.ncc_map_plain(i, j, window)
    kw = {"row_shift": 1} if what == "halo_off_by_one_row" else {"mirror": True}
    bad = emulate(i, j, window, plan, **kw)
    # the card's tolerance (tests/test_torch_cuda.py) must catch it
    assert float((bad - ref).abs().max()) > 1e-2


@pytest.mark.parametrize("n,h,w,window", [(3, 17, 33, 9), (2, 20, 23, 4), (1, 40, 70, 9)])
def test_emulated_loss_partials_match_the_plain_loss(n, h, w, window):
    i, j = _planes(n, h, w, seed=3)
    plan = k4.ncc_plan(n, h, w, window, 4)
    got = emulate(i, j, window, plan, loss=True)
    ref = k4.ncc_loss_kernel(i[..., None], j[..., None], window)
    # float32 thread and block sums in another order than torch's mean
    assert abs(float(got) - float(ref)) < 1e-6
    assert torch.equal(got, emulate(i, j, window, plan, loss=True))  # a fixed order


@pytest.mark.parametrize("planes,h,w,window", TIMED + RAGGED)
@pytest.mark.parametrize("itemsize", [4, 2])
def test_plan_fits_shared_memory_and_covers_the_plane(planes, h, w, window, itemsize):
    plan = k4.ncc_plan(planes, h, w, window, itemsize)
    chunk, halo = k4.chunk_rows(window), k4.halo_cols(window)
    assert plan.smem_bytes == k4.smem_bytes(window, plan.threads, plan.tile_cols, itemsize)
    assert plan.smem_bytes <= k4.MAX_DYNAMIC_SMEM
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= k4.MAX_THREADS
    assert plan.tile_cols % 4 == 0 and plan.band_rows % chunk == 0
    assert min(plan.tile_cols + 2 * halo, w) <= plan.threads  # a thread a column
    assert plan.tiles * plan.tile_cols >= w > (plan.tiles - 1) * plan.tile_cols
    assert plan.bands * plan.band_rows >= h > (plan.bands - 1) * plan.band_rows
    assert plan.blocks == planes * plan.bands * plan.tiles


def test_plan_at_the_timed_shapes():
    # one tile across the plane, 128 threads; the 88 planes in bands of 27
    # rows (440 blocks, 3.3 an SM), the 20 in bands of 9 (300)
    assert k4.ncc_plan(88, 128, 128, 9, 4) == k4.NccPlan(128, 128, 27, 1, 5, 440, 44064)
    assert k4.ncc_plan(20, 128, 128, 9, 4) == k4.NccPlan(128, 128, 9, 1, 15, 300, 44064)


def test_plan_refuses_what_shared_memory_cannot_hold():
    """What the plan still refuses: a window below 1, an empty input and a
    band off the chunk. A window whose rings shared memory cannot hold (101
    on a 1000-wide plane, refused before F9's repair) takes the two-pass
    path."""
    with pytest.raises(ValueError, match="window must be at least 1"):
        k4.ncc_plan(1, 8, 8, 0, 4)
    with pytest.raises(ValueError, match="empty input"):
        k4.ncc_plan(1, 0, 8, 9, 4)
    with pytest.raises(ValueError, match="multiple of 9"):
        k4.ncc_plan(1, 64, 64, 9, 4, band_rows=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        k4.ncc_plan(1, 64, 1000, 101, 4, band_rows=12)
    plan = k4.ncc_plan(1, 64, 1000, 101, 4)
    assert plan == k4.NccPlan(256, 1000, 1, 1, 64, 64, 0, "two_pass")


@pytest.mark.parametrize("n", [20, 88])
def test_k4_bounds_count_each_byte_once(n):
    from csof_tpu_torch import bounds

    px = n * 128 * 128
    map_bytes, map_ops, _ = bounds.ncc_work(n, 128, 128)
    loss_bytes, loss_ops, _ = bounds.ncc_loss_work(n, 128, 128)
    assert map_bytes == 12 * px and loss_bytes == 8 * px  # no map written by the loss
    assert loss_ops > map_ops
    ms, by = bounds.bound_ms(map_bytes, map_ops)
    assert by == "bytes" and ms == pytest.approx(12 * px / bounds.HBM_BPS * 1e3)


@pytest.mark.parametrize("w", [1, 17, 128, 257, 1000, 4096])
def test_plan_takes_every_window_up_to_75_at_any_width(w):
    """K4's window limit (shared memory): every window from 1 to 75 plans at
    any plane width, in both item sizes."""
    for window in range(1, 76):
        for itemsize in (4, 2):
            assert k4.ncc_plan(3, 40, w, window, itemsize).smem_bytes <= k4.MAX_DYNAMIC_SMEM


@pytest.mark.parametrize("w", [1, 17, 128, 257, 1000, 4096])
def test_plan_takes_every_window_up_to_the_plane_at_any_width(w):
    """F9: every window from 1 to the plane's larger side plans, in both
    item sizes: the one-pass kernel where its rings fit shared memory (every
    window up to 75), else the two-pass path."""
    h = 40
    for itemsize in (4, 2):
        for window in range(1, max(h, w) + 1):
            plan = k4.ncc_plan(3, h, w, window, itemsize)
            if plan.path == "fused":
                assert plan.smem_bytes <= k4.MAX_DYNAMIC_SMEM
                assert plan.smem_bytes == k4.smem_bytes(window, plan.threads, plan.tile_cols,
                                                        itemsize)
            else:
                assert plan.path == "two_pass" and window > 75
                assert plan.threads % 32 == 0 and min(w, 256) <= plan.threads <= 256
                assert plan.blocks == min(3 * h, k4.WIDE_MAX_BLOCKS) and plan.smem_bytes == 0


def emulate_two_pass(pred, target, window, plan, eps=1e-3, loss=False):
    """csrc/ncc.cu's two-pass path (ncc_vertical_kernel, then
    ncc_horizontal_kernel) on (planes, H, W) float32 planes: the vertical
    sums of each pixel to the scratch buffer, each the window's rows added
    top to bottom with zeros outside the plane, then along W left to right
    and the closing arithmetic; in loss mode block b's thread t takes
    columns t, t + threads, ... of rows b, b + blocks, ..., and the partials
    close as in the one-pass kernel."""
    planes, h, w = pred.shape
    lo = -(window // 2)
    i, j = pred.reshape(planes * h, w), target.reshape(planes * h, w)
    stats = torch.stack([i, j, i * i, j * j, i * j]).view(5, planes, h, w)
    vs = torch.zeros(5, planes, h, w)
    for y in range(h):
        for o in range(window):
            yy = y + lo + o
            t = stats[:, :, yy] if 0 <= yy < h else torch.zeros(5, planes, w)
            vs[:, :, y] = t if o == 0 else vs[:, :, y] + t
    vs = vs.view(5, planes * h, w)
    hs = torch.zeros_like(vs)
    for x in range(w):
        for o in range(window):
            xx = x + lo + o
            t = vs[:, :, xx] if 0 <= xx < w else torch.zeros(5, planes * h)
            hs[:, :, x] = t if o == 0 else hs[:, :, x] + t
    cc = _close(*hs, window, eps)  # (planes * H, W)
    if not loss:
        return cc.view(planes, h, w)
    nt, nb = plan.threads, plan.blocks
    partials = []
    for b in range(nb):
        acc = torch.zeros(nt)
        for r in range(b, planes * h, nb):
            for x in range(w):
                acc[x % nt] = acc[x % nt] + cc[r, x].clamp(0.001, 0.999)
        warps = _butterfly(acc.view(nt // 32, 32))
        t = warps[0]
        for wv in warps[1:]:
            t = t + wv
        partials.append(t)
    part = torch.stack(partials).double()
    sums = torch.zeros(nt, dtype=torch.float64)
    for k in range(len(part)):
        sums[k % nt] += part[k]
    warps = _butterfly(sums.view(nt // 32, 32))
    t = warps[0]
    for wv in warps[1:]:
        t = t + wv
    return torch.tensor(1.0 - float(t) / (planes * h * w), dtype=torch.float32)


@pytest.mark.parametrize("n,h,w,window", [(2, 9, 40, 77), (1, 13, 30, 101), (1, 20, 23, 9),
                                          (2, 5, 7, 4)])
def test_emulated_two_pass_path_equals_the_plain_map(n, h, w, window):
    """The two-pass path's emulation equals the plain map bit for bit, at
    windows above 75 (wider than the plane) and at ones the one-pass kernel
    also takes; the loss through its partials within float32 order."""
    i, j = _planes(n, h, w, seed=5)
    plan = k4.two_pass_plan(n, h, w)
    assert torch.equal(emulate_two_pass(i, j, window, plan), k4.ncc_map_plain(i, j, window))
    got = emulate_two_pass(i, j, window, plan, loss=True)
    ref = k4.ncc_loss_kernel(i[..., None], j[..., None], window)
    assert abs(float(got) - float(ref)) < 1e-6
