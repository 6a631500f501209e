"""The kernels' C interface and the matmul split, checked on the CPU.

``torch.set_num_threads(2)``: the suite runs in parallel workers.

No card or nvcc here, so what can be held without one is held here: every
wrapper's ctypes argument list against the ``extern "C"`` signature in its
source (a pointer or a stream passed as a 32-bit int would be cut), and
``matmul.split_k``, which decides how the FC kernel's grid fills the card.
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

