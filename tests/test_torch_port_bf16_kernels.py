"""The arithmetic of the port's bf16 tensor-core kernels, emulated on the
CPU where no card can run them (csrc/conv.cu subm_conv16_kernel,
csrc/attention_tile.cuh attend_tiles16):

  * K2's input gradient at bf16 splits each fp32 owner sum into three
    bf16 pieces (tc_common.cuh split_hi, split_mid_lo: hi, then the
    remainder's mid, then what mid leaves as lo). On seeded owner sums of
    a bf16 cotangent the three pieces reproduce every value exactly, so
    their products with a bf16 weight sum to the fp32 product exactly;
    two pieces would not;
  * the bf16 tile's probabilities are the IEEE quotient exp / sum, taken
    as the product by the row's reciprocal corrected once by its fused
    residual (div_rn): equal to torch's fp32 division on seeded pairs;
  * K2's wrapper pads channel counts to whole 16-byte pieces
    (conv_channel_padding, a pure function of the counts and the element
    sizes), and the padded plain call equals the unpadded one bit for
    bit, fp32 and bf16, forward and mirrored.

The kernels themselves run in tests/test_torch_port_gpu.py (`gpu`) and in
chip_smoke.py; the plain versions they are held to are held against the
JAX package in tests/test_torch_port_bf16.py and
tests/test_torch_port_bf16_train.py.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from robot3dlotus_tpu_torch.ops import conv, gather
from robot3dlotus_tpu_torch.ops.sparse_conv import build_neighbor_map

BF16 = torch.bfloat16


def _bf16(x):
    """x rounded to bf16 (to nearest even) and widened back."""
    return x.to(BF16).float()


def split3(x):
    """tc_common.cuh split_hi, split_mid_lo on fp32 x: (hi, mid, lo), fp32
    tensors holding bf16 values."""
    hi = _bf16(x)
    r = x - hi                      # exact in fp32
    mid = _bf16(r)
    return hi, mid, _bf16(r - mid)


def _owner_sums(seed, B=4, N=2048, C=64):
    """The dx kernel's input: fp32 sums of a bf16 cotangent onto voxel
    owners (K8's plain version) on a seeded map with duplicate voxels."""
    rng = np.random.RandomState(seed)
    g = torch.from_numpy(rng.randn(B, N, C).astype(np.float32) *
                         10.0 ** rng.uniform(-6, 0, (B, N, 1))).to(BF16)
    owner = torch.from_numpy(rng.randint(0, N // 3, (B, N)).astype(np.int32))
    return gather.scatter_rows_add_plain(g, owner, N)


@pytest.mark.parametrize("seed", [0, 1])
def test_split3_reproduces_owner_sums_exactly(seed):
    x = _owner_sums(seed)
    assert x.dtype == torch.float32 and bool((x != 0).any())
    hi, mid, lo = split3(x)
    for piece in (hi, mid, lo):
        assert torch.equal(piece, _bf16(piece))
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    # against a bf16 weight each piece's product is exact, so the three
    # products sum to x w as the fp32 product has it
    w = _bf16(torch.randn(x.shape[-1], generator=torch.Generator()
                          .manual_seed(seed)))
    exact = x.double() * w.double()
    assert torch.equal(hi.double() * w.double() + mid.double() * w.double()
                       + lo.double() * w.double(), exact)
    # two pieces leave up to 2^-16 of |x| out: not the fp32 level
    two = hi.double() + mid.double()
    assert float((two - x.double()).abs().max()) > 0.0


def test_div_rn_is_the_ieee_quotient():
    """attention_tile.cuh div_rn(x, y, 1 / y) for a probability x in
    [0, y] and a row sum y in [1, 128], emulated in float64 (the fused
    residual and the fused correction are exact there up to one final
    rounding), against torch's fp32 division."""
    g = torch.Generator().manual_seed(3)
    y = 1.0 + 127.0 * torch.rand(1 << 18, generator=g)
    x = y * torch.rand(1 << 18, generator=g) ** 4
    ry = 1.0 / y                                    # rounded to fp32
    q = x * ry
    r = (x.double() - q.double() * y.double()).float()     # fmaf(-q, y, x)
    got = (r.double() * ry.double() + q.double()).float()  # fmaf(r, ry, q)
    assert torch.equal(got, x / y)
    assert not torch.equal(q, x / y)                # the correction matters


@pytest.mark.parametrize("cin,cout,x_bytes,w_bytes,want", [
    (263, 64, 4, 4, (1, 0)),     # the Concat stem, fp32
    (263, 64, 2, 2, (1, 0)),     # at bf16: 264 = 33 pieces of 8
    (64, 263, 4, 2, (0, 1)),     # its bf16 dx: fp32 owner sums, bf16 W
    (64, 64, 2, 2, (0, 0)),      # the CPE widths
    (768, 768, 4, 2, (0, 0)),
    (7, 12, 2, 2, (1, 4)),
    (8, 20, 4, 2, (0, 4)),
])
def test_conv_channel_padding(cin, cout, x_bytes, w_bytes, want):
    assert conv.conv_channel_padding(cin, cout, x_bytes, w_bytes) == want
    pin, pout = want
    assert ((cin + pin) * x_bytes) % 16 == 0
    assert ((cout + pout) * w_bytes) % 16 == 0


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("cin,cout", [(263, 64), (64, 263), (12, 20)])
def test_padded_plain_call_is_bit_equal(dtype, cin, cout):
    """subm_conv_plain on x and W padded as the wrapper pads them (the
    bf16 route's pieces; at fp32 the fp32 route's), the padded outputs
    dropped, equals the unpadded call bit for bit; the padded outputs are
    zero."""
    rng = np.random.RandomState(cin + cout)
    B, N = 2, 256
    gc = torch.from_numpy(rng.randint(0, 8, (B, N, 3)).astype(np.int32))
    nm = build_neighbor_map(gc, torch.ones(B, N, dtype=torch.bool), 3, 5,
                            extent=128)
    x = torch.from_numpy(rng.randn(B, N, cin).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.randn(27, cin, cout) * cin ** -0.5).astype(
        np.float32)).to(dtype)
    b = torch.from_numpy(rng.randn(cout).astype(np.float32))
    size = x.element_size()
    pin, pout = conv.conv_channel_padding(cin, cout, size, size)
    padded = conv.subm_conv_plain(F.pad(x, (0, pin)), nm.idx, nm.ok,
                                  F.pad(w, (0, pout, 0, pin)),
                                  F.pad(b, (0, pout)))
    assert padded.dtype == dtype
    assert torch.equal(padded[..., :cout],
                       conv.subm_conv_plain(x, nm.idx, nm.ok, w, b))
    assert not padded[..., cout:].any()
