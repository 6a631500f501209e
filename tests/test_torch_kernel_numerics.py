"""The arithmetic of the redesigned kernels, emulated in plain PyTorch on the
CPU and held to the oracles before the card runs the kernels themselves.

``torch.set_num_threads(2)``: the suite runs in parallel workers.

* conv2d (``csrc/conv2d.cu``) multiplies in 3xTF32: each operand x is split
  into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest with ties
  away from zero (the rule of ``cvt.rna.tf32.f32``, which the kernel applies
  with two integer operations), and hi*hi + hi*lo + lo*hi is summed in fp32.
  The emulation sums the three products with fp32 GEMMs; it cannot model
  the tensor cores' own accumulation, which rounds toward zero (the kernel
  restarts its accumulator every k slice and adds the slices in fp32).
* paged attention (``csrc/paged_attention.cu``) walks each slot's pages in
  splits of ``PAGES_PER_SPLIT``, keeps per split the row max m, the sum l
  and the unnormalized output, and merges the splits in order.

* pooling (``csrc/pooling.cu``) covers per block a band of output rows and
  a tile of output columns (``pooling.plan``) and reduces each output's
  window row by row along W, then along H; the max lets a NaN tap win.
* LRN (``csrc/lrn.cu``) keeps each pixel's squares in a zero-padded row
  (kOff zeros, C squares, zeros to a multiple of 4), reads per 16-byte
  vector of channels the aligned span its windows cover, sums each window
  in order and scales x by 2^(-beta * log2(d)).

The emulations live here, not in the package: the package's CPU route is
the plain version in ``kernels/ref.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro_torch.kernels import paged_attention, pooling, ref

torch.set_num_threads(2)

LAYER_RTOL = 3e-5        # chip_smoke.py's AlexNet gate, of the largest output


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value, ties away from zero: half a TF32 ulp
    added to the magnitude bits, the 13 low mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def test_tf32_split_keeps_fp32_accuracy():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000).astype(np.float32))
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()   # TF32 values
    assert (hi - x).abs().le(2.0 ** -11 * x.abs()).all()     # half an ulp
    err = (x.double() - hi.double() - lo.double()).abs()
    assert err.le(2.0 ** -21 * x.abs().double()).all()
    # ties go away from zero: 1 + 2^-11 lies halfway between TF32 values
    tie = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11)])
    assert _tf32(tie).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10)]


def _conv_tf32(x, w, stride, pad, products):
    """conv2d of NHWC x and (OC, IC, KH, KW) w as the kernel multiplies:
    patches (M, K) against filters (K, OC) in TF32 parts, fp32 sums."""
    oc, ic, kh, kw = w.shape
    cols = F.unfold(x.permute(0, 3, 1, 2), (kh, kw), padding=pad,
                    stride=stride)                    # (N, IC*KH*KW, L)
    a = cols.transpose(1, 2).reshape(-1, ic * kh * kw)
    b = w.reshape(oc, -1).t()
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    out = a_hi @ b_hi
    if products == 3:
        out = out + a_hi @ b_lo + a_lo @ b_hi
    n = x.shape[0]
    oh = (x.shape[1] + 2 * pad - kh) // stride + 1
    ow = (x.shape[2] + 2 * pad - kw) // stride + 1
    return out.reshape(n, oh, ow, oc)


# Conv4 (K = 3 * 3 * 384 = 3456, the longest AlexNet reduction) on relu'd
# activations, and Conv1's geometry (IC 3, 11 x 11, stride 4) on an image;
# batch 1 and a few output channels keep it to a CPU's seconds
_CONV = {"conv4": (13, 384, 3, 1, 1, True), "conv1": (224, 3, 11, 4, 2, False)}


def _conv_inputs(layer):
    hw, ic, kk, stride, pad, relu = _CONV[layer]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, hw, hw, ic)).astype(np.float32)
    if relu:
        x = np.maximum(x, 0)
    w = (rng.standard_normal((8, ic, kk, kk))
         * (2.0 / (ic * kk * kk)) ** 0.5).astype(np.float32)
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    # ref.conv2d_ref's formula, in float64
    want = F.conv2d(x.permute(0, 3, 1, 2).double(), w.double(),
                    stride=stride, padding=pad).permute(0, 2, 3, 1)
    return x, w, stride, pad, want


@pytest.mark.parametrize("layer", sorted(_CONV))
def test_3xtf32_conv_meets_the_layer_gate(layer):
    x, w, stride, pad, want = _conv_inputs(layer)
    got = _conv_tf32(x, w, stride, pad, products=3)
    rel = ((got.double() - want).abs().max() / want.abs().max()).item()
    assert rel <= LAYER_RTOL, rel
    # and it is as close as the plain fp32 version
    plain = ref.conv2d_ref(x, w, stride=stride, padding=pad)
    rel_plain = ((plain.double() - want).abs().max()
                 / want.abs().max()).item()
    assert rel <= 10 * rel_plain + 1e-7, (rel, rel_plain)


@pytest.mark.parametrize("layer", sorted(_CONV))
def test_1xtf32_alone_misses_the_layer_gate(layer):
    # the split is what keeps fp32 accuracy: one TF32 product does not
    x, w, stride, pad, want = _conv_inputs(layer)
    got = _conv_tf32(x, w, stride, pad, products=1)
    rel = ((got.double() - want).abs().max() / want.abs().max()).item()
    assert rel > LAYER_RTOL, rel


def _split_walk(q, k_arena, v_arena, block_tables, pos):
    """fp32 model of the kernel: for each (slot, kv head) the splits of
    ``paged_attention.split_pages``, each giving (m, l, acc) over its keys
    <= pos, merged in split order; a slot with no page gets zeros."""
    b, hq, _, d = q.shape
    _, hk, bs, _ = k_arena.shape
    nb = block_tables.shape[1]
    g = hq // hk
    out = torch.zeros(b, hq, 1, d)
    for i in range(b):
        p = int(pos[i])
        for h in range(hk):
            qg = q[i, h * g:(h + 1) * g, 0].float()
            parts = []
            for s in range(paged_attention.splits(nb)):
                pages = paged_attention.split_pages(p, bs, nb, s)
                if not pages:
                    continue
                ids = [int(block_tables[i, j]) for j in pages]
                keys = min(len(pages) * bs, p + 1 - pages[0] * bs)
                k = torch.cat([k_arena[j, h] for j in ids]).float()[:keys]
                v = torch.cat([v_arena[j, h] for j in ids]).float()[:keys]
                sc = (qg @ k.t()) * d ** -0.5
                m = sc.max(-1).values
                e = torch.exp(sc - m[:, None])
                parts.append((m, e.sum(-1), e @ v))
            if not parts:
                continue
            top = parts[0][0]
            for m, _, _ in parts[1:]:
                top = torch.maximum(top, m)
            den, acc = torch.zeros(g), torch.zeros(g, d)
            for m, l, a in parts:
                f = torch.exp(m - top)
                den = den + l * f
                acc = acc + a * f[:, None]
            out[i, h * g:(h + 1) * g, 0] = acc / den[:, None]
    return out


def _paged_case(pos_list, *, nb, bs=16, hq=12, hk=2, d=32):
    """Shuffled physical pages, the trash page last; the last slot is an
    inactive one whose table row names the trash page alone; table
    entries past each slot's last page name no page at all."""
    rng = np.random.default_rng(3)
    b = len(pos_list) + 1
    tb = b * nb + 1
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    ka, va = (rng.standard_normal((tb, hk, bs, d)).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(tb - 1)[:b * nb].reshape(b, nb).astype(np.int32)
    bt[-1] = tb - 1
    pos = np.asarray(list(pos_list) + [0], np.int32)
    return q, ka, va, bt, pos


# pos at 0, on page boundaries (15 | 16), on split boundaries (63 | 64, 127 |
# 128 with 4 pages of 16), at the table's end, and below 0
_POS = [0, 15, 16, 17, 63, 64, 65, 127, 128, 255, -1]


def test_split_walk_matches_both_packages_plain_versions():
    q, ka, va, bt, pos = _paged_case(_POS, nb=16)
    want_t = ref.paged_attention_ref(*map(torch.from_numpy,
                                          (q, ka, va, bt, pos)))
    want_j = np.asarray(jref.paged_attention_ref(*map(jnp.asarray,
                                                      (q, ka, va, bt, pos))))
    got = _split_walk(*map(torch.from_numpy, (q, ka, va, bt, pos)))
    live = pos >= 0
    np.testing.assert_allclose(got.numpy()[live], want_t.numpy()[live],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy()[live], want_j[live],
                               rtol=1e-5, atol=1e-5)
    # a slot with nothing to attend is written as zeros, as the Pallas
    # kernel writes it (the plain versions average every row there)
    assert not got[~torch.from_numpy(live)].any()


def test_split_walk_never_reads_past_the_last_page():
    q, ka, va, bt, pos = _paged_case([0, 16, 70], nb=8)
    for i, p in enumerate(pos):
        bt[i, p // 16 + 1:] = 10 ** 6          # no such page
    got = _split_walk(*map(torch.from_numpy, (q, ka, va, bt, pos)))
    bt_ok = np.where(bt == 10 ** 6, 0, bt).astype(np.int32)
    want = ref.paged_attention_ref(*map(torch.from_numpy,
                                        (q, ka, va, bt_ok, pos)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_split_walk_gives_a_slot_the_same_bits_in_any_batch():
    # a slot's splits and merge order follow from its own pos alone
    q, ka, va, bt, pos = _paged_case(_POS, nb=16)
    args = list(map(torch.from_numpy, (q, ka, va, bt, pos)))
    batch = _split_walk(*args)
    i = _POS.index(65)
    wide = torch.zeros((1, 40), dtype=torch.int32)   # another table width
    wide[0, :16] = args[3][i]
    alone = _split_walk(args[0][i:i + 1], args[1], args[2], wide,
                        args[4][i:i + 1])
    assert torch.equal(alone[0], batch[i])


# ---------------------------------------------------------------- pooling
def _combine(acc, v, pool_type):
    if pool_type == "max":                    # NaN wins, as in jax.lax.max
        return torch.where((v > acc) | torch.isnan(v), v, acc)
    return acc + v


def _pool_blocks(x, window, stride, band, owt, pool_type):
    """csrc/pooling.cu's walk: per (band of output rows, tile of output
    columns) of every image, the staged input rows, and per output each
    window row reduced along W, then the rows along H."""
    n, h, w, c = x.shape
    oh, ow = (h - window) // stride + 1, (w - window) // stride + 1
    init = float("-inf") if pool_type == "max" else 0.0
    xf, out = x.float(), torch.empty(n, oh, ow, c)
    for oh0 in range(0, oh, band):
        nb = min(band, oh - oh0)
        for ow0 in range(0, ow, owt):
            nw = min(owt, ow - ow0)
            rows = (nb - 1) * stride + window
            cols = (nw - 1) * stride + window
            tile = xf[:, oh0 * stride:oh0 * stride + rows,
                      ow0 * stride:ow0 * stride + cols]
            for j in range(nb):
                acc = torch.full((n, nw, c), init)
                for kh in range(window):
                    part = torch.full((n, nw, c), init)
                    for kw in range(window):
                        part = _combine(
                            part, tile[:, j * stride + kh,
                                       kw:kw + (nw - 1) * stride + 1:stride],
                            pool_type)
                    acc = _combine(acc, part, pool_type)
                out[:, oh0 + j, ow0:ow0 + nw] = (
                    acc if pool_type == "max" else acc / window ** 2)
    return out.to(x.dtype)


# (input, window, stride, tiling): "plan" takes pooling.plan's, as the
# wrapper does (AlexNet's Pool5, and Pool2's rows with fewer channels, at
# batch 1); the rest force ragged bands and column tiles
_POOL = {
    "pool5": ((1, 13, 13, 256), 3, 2, "plan"),
    "pool2": ((1, 27, 27, 32), 3, 2, "plan"),
    "band4-owt5": ((2, 27, 27, 8), 3, 2, (4, 5)),
    "band3-owt1": ((1, 15, 11, 4), 3, 2, (3, 1)),
    "w2-s2": ((2, 8, 8, 12), 2, 2, (4, 3)),
    "w3-s3": ((2, 9, 9, 3), 3, 3, (2, 2)),
    "w3-s1": ((1, 9, 10, 5), 3, 1, (4, 4)),
}


@pytest.mark.parametrize("pool_type", ["max", "avg"])
@pytest.mark.parametrize("case", sorted(_POOL))
def test_pool_band_walk_matches_the_plain_version(case, pool_type):
    shape, window, stride, tiling = _POOL[case]
    rng = np.random.default_rng(5)
    a = rng.standard_normal(shape).astype(np.float32)
    a.reshape(-1)[rng.choice(a.size, 3, replace=False)] = np.nan
    x = torch.from_numpy(a)
    n, h, w, c = shape
    oh, ow = (h - window) // stride + 1, (w - window) // stride + 1
    if tiling == "plan":
        band, owt, smem = pooling.plan(w, c, oh, ow, window, stride, 4)
        assert smem > 0
    else:
        band, owt = tiling
    got = _pool_blocks(x, window, stride, band, owt, pool_type)
    plain = ref.maxpool_ref if pool_type == "max" else ref.avgpool_ref
    want = plain(x, window=window, stride=stride)
    assert torch.isnan(want).any()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    if pool_type == "max":                  # a max is exact in any order
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6,
                                   equal_nan=True)


# ------------------------------------------------------------------- lrn
def _lrn_rows(x, n, vec, k=2.0, alpha=1e-4, beta=0.75):
    """csrc/lrn.cu lrn_vec_kernel<T, n> with vectors of ``vec`` channels:
    Row<n>'s layout, the aligned span per vector, in-order window sums."""
    c = x.shape[-1]
    off = (n // 2 + 3) // 4 * 4                         # Row<N>::kOff
    shift = off - n // 2                                # Row<N>::kShift
    floats = (off + c + n - 1 - n // 2 + 3) // 4 * 4    # Row<N>::floats
    span = (shift + vec + n - 1 + 3) // 4 * 4           # kSpan
    assert off % 4 == 0 and floats % 4 == 0 and span % 4 == 0
    xf = x.float().reshape(-1, c)
    pix = xf.shape[0]
    # rows back to back, + 4 floats of slack after the last; NaN where the
    # kernel leaves shared memory unwritten, so a read of it would show
    smem = torch.full((pix * floats + 4,), float("nan"))
    rows = smem[:pix * floats].view(pix, floats)
    rows[:, :off] = 0
    rows[:, off:off + c] = xf * xf
    rows[:, off + c:] = 0
    sums = torch.empty_like(xf)
    for c0 in range(0, c, vec):
        lo = torch.arange(pix) * floats + c0
        assert int(lo[-1]) + span <= smem.numel()
        part = smem[lo[:, None] + torch.arange(span)]
        for i in range(vec):
            acc = torch.zeros(pix)
            for j in range(n):
                acc = acc + part[:, shift + i + j]
            sums[:, c0 + i] = acc
    d = k + (alpha / n) * sums
    return (xf * torch.exp2(-beta * torch.log2(d))).reshape(x.shape)


@pytest.mark.parametrize("c,vec", [(4, 4), (12, 4), (96, 4), (8, 8),
                                   (96, 8)])
@pytest.mark.parametrize("n", range(1, 10))
def test_lrn_rows_match_both_packages(n, c, vec):
    # every window the vector kernel is built for (1..kMaxN), odd and even,
    # wider than C (n > 4 at C = 4); large values, so a wrong window shows
    a = (np.random.default_rng(n).standard_normal((2, 3, 3, c)) * 30
         ).astype(np.float32)
    got = _lrn_rows(torch.from_numpy(a), n, vec)
    assert torch.isfinite(got).all()
    want_t = ref.lrn_ref(torch.from_numpy(a), local_size=n)
    want_j = np.asarray(jref.lrn_ref(jnp.asarray(a), local_size=n))
    np.testing.assert_allclose(got.numpy(), want_t.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_j, rtol=1e-5, atol=1e-5)
