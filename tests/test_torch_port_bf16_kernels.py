"""The arithmetic of the port's bf16 tensor-core kernels, emulated on the
CPU where no card can run them (csrc/conv.cu subm_conv16_kernel,
csrc/attention_tile.cuh attend_tiles16, csrc/conv_grad.cu
wgrad_tc_kernel<bf16>, csrc/attention_dropout.cu attn_drop_bwd16_kernel):

  * K2's input gradient at bf16 splits each fp32 owner sum into three
    bf16 pieces (tc_common.cuh split_hi, split_mid_lo: hi, then the
    remainder's mid, then what mid leaves as lo). On seeded owner sums of
    a bf16 cotangent the three pieces reproduce every value exactly, so
    their products with a bf16 weight sum to the fp32 product exactly;
    two pieces would not;
  * the bf16 tile's probabilities are the IEEE quotient exp / sum, taken
    as the product by the row's reciprocal corrected once by its fused
    residual (div_rn): equal to torch's fp32 division on seeded pairs;
  * K7 at bf16 (csrc/conv_grad.cu) walks each (tap, row range) live list
    in stages of 128 listed rows and 16-row mma steps whose rows past the
    list's end are zero: every live link multiplied once, fewer than 16
    zero rows a list, the stage sums within the card test's bar;
  * K6 at bf16 (csrc/attention_dropout.cu) multiplies the fp32 (dropped)
    probabilities and ds as three bf16 pieces: exact splits, the
    three-piece dq, dk, dv within the bf16 bar of the plain version, one
    piece far off;
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


# ---- K7 at bf16 (csrc/conv_grad.cu wgrad_tc_kernel<bf16>) ----
K7_STAGE_ROWS = 128    # rows_per_stage<bf16>: listed rows a stage holds
K7_STEP_ROWS = 16      # step_rows<bf16>: the mma's k, rows a step


def _emulate_k7_bf16(x, idx, ok, g, splits, per):
    """K7's CPE path at bf16 as the kernel walks it: per (tap, row range)
    the live list in ascending row order, in stages of K7_STAGE_ROWS
    listed rows, each stage in 16-row steps whose rows past the list's
    end are zero (cp.async's zero fill); each step X^T G of bf16 values
    (every product exact, fp32 sums), a stage's steps summed into its
    own part, the parts added to the range's fp32 total in order, the
    ranges added in order. Returns dW and, per (tap, range), the rows
    multiplied and the zero rows among them."""
    B, N, K = idx.shape
    R = B * N
    xf = x.float().reshape(R, -1)
    gf = g.float().reshape(R, -1)
    rows_all = torch.arange(R)
    src_all = (rows_all // N * N)[:, None] + idx.reshape(R, K).long()
    okf = ok.reshape(R, K)
    dw = torch.zeros(K, xf.shape[1], gf.shape[1])
    counts = {}
    for k in range(K):
        total = torch.zeros_like(dw[0])
        for s in range(splits):
            r0, r1 = s * per, min(R, (s + 1) * per)
            live = okf[r0:r1, k]
            rows = rows_all[r0:r1][live]
            srcs = src_all[r0:r1, k][live]
            n = len(rows)
            acc = torch.zeros_like(dw[0])
            multiplied = zeros = 0
            for st in range(0, n, K7_STAGE_ROWS):
                cnt = min(K7_STAGE_ROWS, n - st)
                steps = -(-cnt // K7_STEP_ROWS)
                xs = torch.zeros(steps * K7_STEP_ROWS, xf.shape[1])
                gs = torch.zeros(steps * K7_STEP_ROWS, gf.shape[1])
                xs[:cnt] = xf[srcs[st:st + cnt]]
                gs[:cnt] = gf[rows[st:st + cnt]]
                part = torch.zeros_like(acc)
                for j in range(steps):
                    sl = slice(j * K7_STEP_ROWS, (j + 1) * K7_STEP_ROWS)
                    part += (xs[sl].double().t() @ gs[sl].double()).float()
                acc += part
                multiplied += steps * K7_STEP_ROWS
                zeros += steps * K7_STEP_ROWS - cnt
            counts[k, s] = (n, multiplied, zeros)
            total = acc if s == 0 else total + acc
        dw[k] = total
    return dw, counts


@pytest.mark.parametrize("B,N,cin,cout", [(2, 509, 64, 64), (1, 1500, 32, 16),
                                          (3, 300, 8, 24)])
def test_k7_bf16_steps_emulated(B, N, cin, cout):
    """Every live link multiplied once in its (tap, range) list, the zero
    rows of a list's last step fewer than 16 and only there (lists whose
    live count is not a multiple of 16, several stages a list at
    N = 1500), and the emulated stage / step sums within 1e-4 of the
    plain version's largest value (the card test's bar) on the wrapper's
    plan."""
    rng = np.random.RandomState(B * N + cin)
    gc = torch.from_numpy(rng.randint(0, 9, (B, N, 3)).astype(np.int32))
    nm = build_neighbor_map(gc, torch.ones(B, N, dtype=torch.bool), 3, 5,
                            extent=128)
    x = torch.from_numpy(rng.randn(B, N, cin).astype(np.float32)).to(BF16)
    g = torch.from_numpy(rng.randn(B, N, cout).astype(np.float32)).to(BF16)
    splits, per, _ = conv.weight_grad_plan(B, N, 27, cin, cout, unit=8)
    got, counts = _emulate_k7_bf16(x, nm.idx, nm.ok, g, splits, per)
    want = conv.conv_weight_grad_plain(x, nm.idx, nm.ok, g)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    live = nm.ok.reshape(B * N, 27).sum(0)
    for k in range(27):
        assert sum(counts[k, s][0] for s in range(splits)) == int(live[k])
    assert all(m - n == z and 0 <= z < K7_STEP_ROWS
               for n, m, z in counts.values())
    assert any(z > 0 for _, _, z in counts.values())
    if N == 1500:
        assert max(n for n, _, _ in counts.values()) > K7_STAGE_ROWS


# ---- K6 at bf16 (csrc/attention_dropout.cu attn_drop_bwd16_kernel) ----

def _pieces_mm(a, b, pieces):
    """a @ b for fp32 a and bf16-valued b with a split into `pieces` bf16
    pieces (split3, the small pieces first), each product exact and the
    sums in float64 (the kernel's fp32 sums in another order)."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    for piece in reversed(split3(a)[:pieces]):
        out += piece.double() @ b.double()
    return out.float()


def _k6_bf16_emulated(q, k, v, kv, out, lse, bits, g, scale, rate, pieces):
    """K6's bf16 arithmetic in torch: S^T and dP^T as exact products of bf16
    values, p and ds in fp32 as the kernel forms them, dv, dk and dq from
    `pieces` bf16 pieces of p and ds."""
    from robot3dlotus_tpu_torch.ops import attention
    from robot3dlotus_tpu_torch.ops.bf16 import bf16_value
    P = q.shape[2]
    s16 = bf16_value(scale)
    qs = (q.float() * s16).to(BF16).float()
    kf, vf, gf = k.float(), v.float(), g.float()
    logits = torch.where(kv[:, None, None, :],
                         (qs.double() @ kf.double().transpose(-1, -2))
                         .float(), torch.tensor(-1e9))
    valid = kv[:, None, None, :]
    p = torch.where(valid, torch.exp(logits - lse[..., None]), 0.0)
    p = torch.where(kv.any(-1)[:, None, None, None], p, 1.0 / P)
    keep = attention.unpack_keep_bits(bits, P)
    inv = 1.0 / (1.0 - rate)
    pd = torch.where(keep, p * inv, 0.0)
    dp = (gf.double() @ vf.double().transpose(-1, -2)).float()
    da = torch.where(keep, dp * inv, 0.0)
    D = (gf * out.float()).sum(-1, keepdim=True)
    ds = torch.where(valid, p * (da - D), 0.0)
    dv = _pieces_mm(pd.transpose(-1, -2), gf, pieces)
    dk = _pieces_mm(ds.transpose(-1, -2), qs, pieces)
    dq = _pieces_mm(ds, kf, pieces) * s16
    return dq, dk, dv, (pd, ds)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("P,Dh", [(128, 32), (77, 24), (37, 16)])
def test_k6_bf16_split_emulated(rate, P, Dh):
    """The probabilities (dropped, scaled) and ds that K6 multiplies in fp32
    split into three bf16 pieces exactly, and the three-piece products,
    rounded to bf16 once, are within the bar of ops/bf16.py (the
    gradients' own scale) of K6's plain version on K5's plain outputs;
    patch 0 has no valid key. With one piece (hi alone) the error is
    hundreds of times the three-piece one, and two pieces leave a
    remainder: the kernel keeps three."""
    from robot3dlotus_tpu_torch.ops import attention
    from robot3dlotus_tpu_torch.ops.bf16 import bf16_excess
    gen = torch.Generator().manual_seed(P + Dh)
    G, H, seed, scale = 3, 2, 4242, Dh ** -0.5
    q, k, v, g = (torch.randn(G, H, P, Dh, generator=gen).to(BF16)
                  for _ in range(4))
    kv = torch.rand(G, P, generator=gen) > 0.2
    kv[0] = False
    out, lse, bits = attention.patch_attention_dropout_fwd_plain(
        q, k, v, kv, scale, rate, seed)
    want = attention.patch_attention_dropout_bwd_plain(
        q, k, v, kv, out, lse, bits, g, scale, rate)
    errs = {}
    for pieces in (1, 2, 3):
        got = _k6_bf16_emulated(q, k, v, kv, out, lse, bits, g, scale, rate,
                                pieces)
        errs[pieces] = max(float((a - b).abs().max())
                           for a, b in zip(got[:3], want))
        if pieces == 3:
            for a, b in zip(got[:3], want):
                assert bf16_excess(a.to(BF16), b.to(BF16),
                                   relative=True) <= 0.0
            for t in got[3]:
                hi, mid, lo = split3(t)
                assert torch.equal(hi.double() + mid.double() + lo.double(),
                                   t.double())
            assert bool((got[3][1][0] == 0).all())   # no valid key: ds = 0
    assert errs[1] > 100 * errs[3] and errs[2] >= errs[3]
