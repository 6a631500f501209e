"""The kernels' C interface and the matmul split, checked on the CPU.

``torch.set_num_threads(2)``: the suite runs in parallel workers.

No card or nvcc here, so what can be held without one is held here: every
wrapper's ctypes argument list against the ``extern "C"`` signature in its
source (a pointer or a stream passed as a 32-bit int would be cut);
``matmul.split_k``, which decides how the FC kernel's grid fills the card;
the conv2d kernel's shared memory at every AlexNet conv (the port's
counterpart of tests/test_kernels.py's VMEM budget); and the paged kernel's
split of each slot's pages over blocks.
"""
import ctypes
import math
import re

import pytest
import torch

from repro_torch.kernels import (_build, conv2d, flash_attention, lrn, matmul,
                                 paged_attention, pooling)

torch.set_num_threads(2)

_WRAPPERS = {
    "repro_matmul": matmul, "repro_conv2d": conv2d, "repro_pool": pooling,
    "repro_lrn": lrn, "repro_paged_attention": paged_attention,
    "repro_flash_attention": flash_attention,
}


def _c_params(source: str, name: str) -> list[str]:
    text = (_build.CSRC / source).read_text()
    found = re.search(r'extern\s+"C"\s+int\s+' + name + r"\s*\(([^)]*)\)",
                      text)
    assert found, f"no extern \"C\" int {name}(...) in {source}"
    return [" ".join(p.split()) for p in found.group(1).split(",")]


def _ctype_of(param: str):
    """The ctypes type a C parameter must be passed as."""
    if "*" in param:
        return ctypes.c_void_p
    kind = param.rsplit(" ", 1)[0].replace("const ", "")
    return {"int": ctypes.c_int, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}[kind]


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_argtypes_match_the_c_signature(name):
    module = _WRAPPERS[name]
    params = _c_params(module.SOURCE, name)
    want = tuple(_ctype_of(p) for p in params)
    assert len(module._ARGTYPES) == len(params), (params, module._ARGTYPES)
    assert module._ARGTYPES == want, list(zip(params, module._ARGTYPES))
    # every pointer, the stream included, goes as a full-width pointer
    assert params[-1].endswith("stream") and \
        module._ARGTYPES[-1] is ctypes.c_void_p


def test_matmul_tile_matches_the_kernel():
    text = (_build.CSRC / "gemm_pipelined.cuh").read_text()
    tile = dict(re.findall(r"(kTile[MNK]) = (\d+)", text))
    assert (int(tile["kTileM"]), int(tile["kTileN"]), int(tile["kTileK"])) \
        == (matmul.TILE_M, matmul.TILE_N, matmul.TILE_K)


def _blocks(m, n, splits):
    return (math.ceil(m / matmul.TILE_M) * math.ceil(n / matmul.TILE_N)
            * splits)


def _assert_covers(k, splits, slice_k):
    assert slice_k % matmul.TILE_K == 0 and slice_k > 0
    bounds = [(s * slice_k, min(k, (s + 1) * slice_k)) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)          # no empty slice
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


# AlexNet's FC layers (n_in, k_o) and the fewest blocks each must launch:
# at batch 64, two per SM for FC6 and FC7, one per SM for FC8; one per SM
# for a single row
_FC = {"FC6": (9216, 4096), "FC7": (4096, 4096), "FC8": (4096, 1000)}


@pytest.mark.parametrize("layer", sorted(_FC))
@pytest.mark.parametrize("m", [64, 1])
def test_split_k_fills_the_card_on_alexnet_fc(layer, m):
    k, n = _FC[layer]
    splits, slice_k = matmul.split_k(m, n, k)
    _assert_covers(k, splits, slice_k)
    fewest = 2 * matmul.SMS if (m == 64 and layer != "FC8") else matmul.SMS
    assert _blocks(m, n, splits) >= fewest
    assert slice_k >= matmul.MIN_SLICE_STEPS * matmul.TILE_K


@pytest.mark.parametrize("m,k,n", [
    (128, 128, 128), (256, 512, 256), (100, 300, 70), (1, 9216, 4096),
    (8, 64, 8), (64, 96, 48), (3, 9217, 130), (1, 1, 1), (4096, 4096, 4096),
])
def test_split_k_covers_k_once(m, k, n):
    splits, slice_k = matmul.split_k(m, n, k)
    _assert_covers(k, splits, slice_k)
    tiles = _blocks(m, n, 1)
    if tiles >= 2 * matmul.SMS:
        assert splits == 1                 # the tiles alone fill the card
    if splits > 1:                         # no slice below the ring's depth
        assert slice_k >= matmul.MIN_SLICE_STEPS * matmul.TILE_K



# --------------------------------------------------------------- conv2d
def _cu_constants(source: str) -> dict:
    text = (_build.CSRC / source).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_conv2d_tiles_match_the_kernel():
    c = _cu_constants("conv2d.cu")
    assert (c["kBM"], c["kBK"]) == (conv2d.TILE_M, conv2d.TILE_K)
    # wgmma: 64-row warpgroups, N a multiple of 8 up to 256, and a B tile
    # row is one 128-byte swizzle span of fp32
    assert c["kBM"] % 64 == 0 and c["kBK"] == 32
    assert all(c[n] % 8 == 0 and c[n] <= 256 for n in ("kNarrowN", "kWideN"))


SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED = 232448, 233472, 1024


def _conv2d_smem(tile_n: int) -> int:
    """Dynamic shared memory of a conv2d block (csrc/conv2d.cu Smem): per
    stage the B_hi and B_lo tiles and the fp32 A tile (rows padded), then
    the per-row patch origins and the slack that aligns the tiles."""
    c = _cu_constants("conv2d.cu")
    stage = 2 * tile_n * c["kBK"] * 4 + c["kBM"] * (c["kBK"] + c["kAPad"]) * 4
    return c["kStages"] * stage + c["kBM"] * 16 + 1024


def _alexnet_convs():
    from repro_torch.core.layer_model import alexnet_full_spec
    for spec in alexnet_full_spec():
        if spec.kind == "conv":
            h, _, ic = spec.m_i
            oc, _, kk, _ = spec.m_k
            yield spec.name, h, ic, oc, kk, spec.stride, spec.padding


@pytest.mark.parametrize("layer", [c[0] for c in _alexnet_convs()])
def test_conv2d_shared_memory_fits_every_alexnet_conv(layer):
    _, h, ic, oc, kk, stride, pad = next(
        c for c in _alexnet_convs() if c[0] == layer)
    c = _cu_constants("conv2d.cu")
    for tile_n in (c["kNarrowN"], c["kWideN"]):   # either may be picked
        smem = _conv2d_smem(tile_n)
        assert smem <= SMEM_PER_BLOCK, (layer, tile_n, smem)
        # the blocks the kernel plans per SM fit the SM together
        assert c["kBlocksPerSM"] * (smem + SMEM_RESERVED) <= SMEM_PER_SM
    # the split filters' rows cover K in whole k slices
    k = kk * kk * ic
    kp = conv2d.padded_k(ic, kk, kk)
    assert kp % conv2d.TILE_K == 0 and k <= kp < k + conv2d.TILE_K
    oh = (h + 2 * pad - kk) // stride + 1
    assert -(-64 * oh * oh // conv2d.TILE_M) <= 65535   # grid.y at batch 64


# --------------------------------------------------------------- pooling
def test_pool_constants_match_the_kernel():
    c = _cu_constants("pooling.cu")
    assert c["kThreads"] == pooling.THREADS
    assert c["kMaxSmem"] == SMEM_PER_BLOCK
    # the staging budget leaves room for the eight blocks of THREADS that
    # fill an SM's 2048 threads
    assert 2048 // pooling.THREADS == 8
    assert 8 * (pooling.SMEM_BUDGET + SMEM_RESERVED) <= SMEM_PER_SM


def _alexnet_pools():
    from repro_torch.core.layer_model import alexnet_full_spec
    for spec in alexnet_full_spec():
        if spec.kind == "pool":
            h, _, c = spec.m_i
            yield spec.name, h, c, spec.window, spec.stride


def _staged(o, band, owt, win, stride, c, elem_bytes):
    """(bytes one block stages, blocks per image) of a tiling."""
    size = ((band - 1) * stride + win) * ((owt - 1) * stride + win) * c \
        * elem_bytes
    return size, -(-o // band) * -(-o // owt)


@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("layer", [p[0] for p in _alexnet_pools()])
def test_pool_plan_at_alexnet(layer, elem_bytes):
    _, h, c, win, stride = next(p for p in _alexnet_pools() if p[0] == layer)
    o = (h - win) // stride + 1
    band, owt, smem = pooling.plan(h, c, o, o, win, stride, elem_bytes)
    size, blocks = _staged(o, band, owt, win, stride, c, elem_bytes)
    assert smem == size and 0 < smem <= pooling.SMEM_BUDGET
    # no tiling that fits stages fewer bytes in all
    least = min(b * s for s, b in (
        _staged(o, bb, t, win, stride, c, elem_bytes)
        for bb in range(1, min(pooling.MAX_BAND, o) + 1)
        for t in range(1, o + 1))
        if s <= pooling.SMEM_BUDGET)
    assert blocks * size == least
    # every thread of a block has an output, and the grid fits
    assert c * elem_bytes // 16 * owt * band >= pooling.THREADS
    assert -(-o // band) <= 65535 and -(-o // owt) <= 2 ** 31 - 1


@pytest.mark.parametrize("w,c,win,stride,staged", [
    (224, 512, 3, 2, True),      # wide rows: a tile of a few columns
    (7, 4096, 7, 1, False),      # not one window fits: taps from memory
    (9, 3, 3, 3, True),          # small: the whole image in one block
])
def test_pool_plan_falls_back_when_rows_do_not_fit(w, c, win, stride,
                                                   staged):
    o = (w - win) // stride + 1
    band, owt, smem = pooling.plan(w, c, o, o, win, stride, 4)
    assert 1 <= band <= o and 1 <= owt <= o
    if staged:
        assert smem == _staged(o, band, owt, win, stride, c, 4)[0]
        assert 0 < smem <= pooling.SMEM_BUDGET
        if w * c * 4 * win > pooling.SMEM_BUDGET:
            assert owt < o
        else:
            assert (band, owt) == (o, o)
    else:
        assert (band, owt, smem) == (1, o, 0)


# ------------------------------------------------------ paged attention
def test_paged_split_matches_the_kernel():
    c = _cu_constants("paged_attention.cu")
    assert c["kPagesPerSplit"] == paged_attention.PAGES_PER_SPLIT


@pytest.mark.parametrize("bs", [8, 16])
def test_paged_splits_cover_each_page_up_to_pos_once(bs):
    # every table width up to 128 pages; positions on both sides of every
    # page boundary (the pages read change only there), past the table's
    # end, and below 0
    for nb in range(1, 129):
        grid = paged_attention.splits(nb)
        for pos in sorted({-2, -1} | {j * bs + e for j in range(nb + 2)
                                      for e in (-1, 0, 1)}):
            seen = [j for s in range(grid)
                    for j in paged_attention.split_pages(pos, bs, nb, s)]
            want = list(range(min(nb, pos // bs + 1))) if pos >= 0 else []
            assert seen == want, (nb, pos)       # each once, in split order
            # a split's pages depend on pos and the constant alone: the
            # same slot in a wider table gets the same splits
            wider = [list(paged_attention.split_pages(pos, bs, 128, s))
                     for s in range(grid)]
            if pos < nb * bs:
                assert wider == [list(paged_attention.split_pages(
                    pos, bs, nb, s)) for s in range(grid)]
