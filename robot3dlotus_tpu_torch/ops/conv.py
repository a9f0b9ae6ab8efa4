"""K2, submanifold sparse conv on a (B, N, K) neighbour map, and K7, its
weight gradient (port of robot3dlotus_tpu/ops/pallas_conv.py
`subm_conv_windowed` and its custom VJP `_windowed_op`, and of the
streaming XLA stem conv `_subm_conv_streaming` of
robot3dlotus_tpu/ops/sparse_conv.py at the Concat variant's width).

out[b, n] = sum_k ok[b, n, k] * W[k]^T x[b, idx[b, n, k]] + bias, with W
(K, Cin, Cout) in stencil_offsets order. The CUDA kernels are csrc/conv.cu
(K2) and csrc/conv_grad.cu (K7); both read the map directly: no
WindowMap, no halo, no far lists, and multiply only the live links, on the
tensor cores: 3xTF32 at fp32, bf16 mma.sync at bf16 (the sources say
how). subm_conv_plain and conv_weight_grad_plain are the same functions
in PyTorch, the path for CPU tensors and the kernels' oracles. A CUDA call of either wrapper is one
launch count and one ctypes call, which launches one to three kernels: K2
adds a fixed-order reduction of its tap ranges when B N is too small to
fill the card (conv_tap_splits), K7 a compaction of each tap's live rows
and, with more than one row range, a fixed-order sum of the ranges
(weight_grad_plan).

Shapes: up to CONV_MAX_TAPS taps (the k=3 CPE conv's 27 and the k=5
stem's 125), any channel counts. The kernels read and write 16 bytes at a
time, so a channel count that is not a multiple of 4 (the Concat stem's
7 + 256 = 263 inputs, and its input gradient's 263 outputs) is padded
with zero channels here, which is exact: zero inputs meet zero weight
rows, and the padded outputs are dropped. K7 pads x likewise from
WGRAD_PAD_MIN_CIN input channels, so that the wide stem takes its
compacted path; narrower inputs (the policy stem's 7) keep the path that
packs (tap, channel) columns.

bf16 (compute_dtype bfloat16): x and W bf16, the bias fp32; every tap
sums in fp32, the bias is added in fp32 and the result is rounded to bf16
once, as the JAX XLA conv does (ops/sparse_conv.py subm_conv_apply): csrc
r3dl_subm_conv_bf16, counted as subm_conv_bf16, and subm_conv_plain in
PyTorch. The tap ranges' partials stay fp32. The kernel reads 16 bytes (8
bf16 channels) at a time and zero-fills a stage's channels past the edge,
so bf16 channel counts are padded to multiples of 8 (the CPE's 64..768
are; the Concat stem's 263 becomes 264; conv_channel_padding). The
backward at bf16 follows the Pallas VJP (pallas_conv.py
`_windowed_op_bwd`): the bf16 cotangent widened, dx the mirrored conv
summed in fp32 and rounded to bf16 once, dW each tap's fp32 sum rounded
to bf16 once. The owner sum stays fp32 (K8 at bf16 hands back its fp32
sums), and the mirrored conv takes it with the bf16 weight: csrc
r3dl_subm_conv_dx_bf16, counted as subm_conv_dx_bf16, so the duplicate
voxels add no rounding that neither JAX path has. K7 at bf16 (csrc
r3dl_conv_weight_grad_bf16, counted as conv_weight_grad_bf16) widens x and
g and returns fp32 sums; the backward rounds them to bf16, and the cast of
the fp32 parameter widens them again, as `dW.astype(weight.dtype)` and the
cast's VJP do in the JAX package. (The JAX XLA conv's VJP rounds each
tap's dx product and sums the taps in bf16; the port follows the TPU
kernel.)

Backward: dW is K7, dbias a plain sum, and dx is the conv itself run on
a cotangent with the mirrored weight W'[k] = W[K-1-k]^T (K2 again), as in
the JAX package. The mirrored conv alone is the adjoint only of a
link-symmetric map (stencil_offsets(K-1-k) == -stencil_offsets(k) holds),
and rotated, augmented clouds put several points into one voxel: the map
points every lookup at the voxel's lowest index (its owner), so the other
points have links out and none in. conv_input_grad makes dx exact for any
map: K8 first adds each valid row's cotangent onto its voxel's owner (the
centre tap's index), the mirrored K2 runs on those sums, and rows that own
no voxel get 0. (The JAX package's windowed path runs the mirrored conv on
the raw cotangent, which is exact only without duplicates:
pallas_conv.py `subm_conv_windowed` docstring.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib
from .gather import scatter_rows_add

CONV_ROWS = 128          # csrc/conv.cu kTM: output rows per block
CONV_COLS = 64           # csrc/conv.cu kTN: output channels per block
CONV_MAX_TAPS = 125      # csrc/conv.cu kMaxTaps
CONV_TARGET_BLOCKS = 132 * 2    # two 109 KB blocks on each of 132 SMs
WGRAD_TILE = 64          # csrc/conv_grad.cu kT: dW tile side
WGRAD_TARGET_BLOCKS = 132 * 3   # three 73 KB blocks on each of 132 SMs
WGRAD_MIN_ROWS = 512
WGRAD_PAD_MIN_CIN = 32


def subm_conv_plain(x, idx, ok, weight, bias=None):
    """x (B, N, Cin); idx/ok (B, N, K); weight (K, Cin, Cout); the taps
    sum in fp32 (bf16 x and weight are widened), the fp32 bias is added
    and the result is cast to x's dtype once."""
    B, N, _ = x.shape
    out = x.new_zeros((B, N, weight.shape[-1]), dtype=torch.float32)
    for k in range(weight.shape[0]):
        g = torch.gather(x, 1, idx[..., k].long()[..., None].expand(
            -1, -1, x.shape[-1]))
        g = torch.where(ok[..., k, None], g, torch.zeros_like(g))
        out = out + g.float() @ weight[k].float()
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)


def conv_weight_grad_plain(x, idx, ok, g):
    """dW (K, Cin, Cout) = sum_{b,n} ok[b,n,k] x[b, idx[b,n,k]]^T g[b,n],
    fp32 (bf16 x and g widened)."""
    out = []
    x, g = x.float(), g.float()
    for k in range(idx.shape[-1]):
        xs = torch.gather(x, 1, idx[..., k].long()[..., None].expand(
            -1, -1, x.shape[-1]))
        xs = torch.where(ok[..., k, None], xs, torch.zeros_like(xs))
        out.append(torch.einsum("bnc,bnd->cd", xs, g))
    return torch.stack(out)


def mirror_weight(weight):
    """W'[k] = W[K-1-k]^T: the adjoint stencil of a link-symmetric map."""
    return weight.flip(0).transpose(1, 2).contiguous()


def _check_map(name, x, idx, ok, K, dtypes=(torch.float32,)):
    cuda_lib.check_cuda_tensor(f"{name} x", x, dtypes, 3)
    cuda_lib.check_cuda_tensor(f"{name} idx", idx, torch.int32, 3)
    cuda_lib.check_cuda_tensor(f"{name} ok", ok, torch.bool, 3)
    B, N, _ = x.shape
    if tuple(idx.shape) != (B, N, K) or tuple(ok.shape) != (B, N, K):
        raise ValueError(f"{name}: x{tuple(x.shape)} idx{tuple(idx.shape)} "
                         f"ok{tuple(ok.shape)} K={K}")


def _aligned(t):
    """t, or a copy of it when its data is not 16-byte aligned (the
    kernels' cp.async reads 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pad_channels(t, last=0, second=0):
    """t with zeros appended to its last dimension (`last` of them) and to
    its second-to-last (`second`)."""
    return F.pad(t, (0, last, 0, second)) if last or second else t


def conv_channel_padding(cin, cout, x_bytes, w_bytes):
    """(pin, pout): the zero channels K2's wrapper appends to x's Cin and
    the weight's Cout, so that each is a whole number of the kernel's
    16-byte pieces (x_bytes, w_bytes: the element sizes; Cin counts x's
    pieces, Cout the weight's). Exact: zero inputs meet zero weight rows,
    and the padded outputs are dropped."""
    return -cin % (16 // x_bytes), -cout % (16 // w_bytes)


def conv_tap_splits(B, N, K, cout):
    """K2's tap ranges per (row tile, channel tile, cloud): one when those
    tiles fill the card, else enough (at most K) that two blocks sit on
    each SM. B = 1 at the deep stages is the case that splits. csrc/conv.cu
    gives range s the taps [s K / splits, (s + 1) K / splits)."""
    blocks = -(-N // CONV_ROWS) * -(-cout // CONV_COLS) * B
    return max(1, min(K, -(-CONV_TARGET_BLOCKS // max(blocks, 1))))


_BF16 = torch.bfloat16
# (x dtype, weight dtype) -> (counter, entry point, out dtype): the forward
# at fp32 and at bf16, and the input gradient at bf16 (the fp32 owner sums
# against the bf16 mirrored weight)
_CONV_ROUTES = {
    (torch.float32, torch.float32): ("subm_conv", "r3dl_subm_conv",
                                     torch.float32),
    (_BF16, _BF16): ("subm_conv_bf16", "r3dl_subm_conv_bf16", _BF16),
    (torch.float32, _BF16): ("subm_conv_dx_bf16", "r3dl_subm_conv_dx_bf16",
                             _BF16)}


def _conv_forward(x, idx, ok, weight, bias):
    """K2 (any route of _CONV_ROUTES) for CUDA tensors, the plain version
    for CPU ones; the output in the route's dtype (the weight's)."""
    if not x.is_cuda:
        return subm_conv_plain(x, idx, ok, weight, bias).to(weight.dtype)
    K, wcin, Cout = weight.shape
    _check_map("subm_conv", x, idx, ok, K, (torch.float32, _BF16))
    cuda_lib.check_cuda_tensor("subm_conv weight", weight,
                               (torch.float32, _BF16), 3)
    route = _CONV_ROUTES.get((x.dtype, weight.dtype))
    B, N, Cin = x.shape
    if route is None or wcin != Cin or K > CONV_MAX_TAPS:
        raise ValueError(f"subm_conv: x {x.dtype} {tuple(x.shape)} weight "
                         f"{weight.dtype} {tuple(weight.shape)} (the kernel "
                         f"takes at most {CONV_MAX_TAPS} taps)")
    kernel, entry, out_dtype = route
    bias_ptr = None
    if bias is not None:
        cuda_lib.check_cuda_tensor("subm_conv bias", bias, torch.float32, 1)
        if bias.shape[0] != Cout:
            raise ValueError(f"subm_conv: bias {tuple(bias.shape)}")
    pin, pout = conv_channel_padding(Cin, Cout, x.element_size(),
                                     weight.element_size())
    x = _pad_channels(x, pin)
    weight = _pad_channels(weight, pout, pin)
    if bias is not None:
        bias = _pad_channels(bias, pout)
        bias_ptr = bias.data_ptr()
    Cin, Cout = Cin + pin, Cout + pout
    splits = conv_tap_splits(B, N, K, Cout)
    out = torch.empty((B, N, Cout), dtype=out_dtype, device=x.device)
    # the tap ranges' fp32 partial sums, apart from the output so that the
    # activation does not keep them alive
    work = torch.empty(splits * out.numel(), dtype=torch.float32,
                       device=x.device) if splits > 1 else None
    x, weight = _aligned(x), _aligned(weight)
    cuda_lib.launch(kernel, entry, x.data_ptr(),
                    idx.data_ptr(), ok.data_ptr(), weight.data_ptr(),
                    bias_ptr, out.data_ptr(),
                    None if work is None else work.data_ptr(), B, N, K,
                    Cin, Cout, splits, 0 if work is None else 4 * work.numel())
    return out[..., :Cout - pout] if pout else out


def weight_grad_plan(B, N, K, cin, cout, unit=4):
    """(splits, rows_per_split, work_bytes) of K7: the row ranges make
    (tiles x ranges) fill the card, at least WGRAD_MIN_ROWS rows each; the
    scratch holds the live lists of the CPE path (channel counts multiples
    of `unit`, the channels of a 16-byte piece: 4 fp32, 8 bf16; 2 K B N +
    K splits int32, rounded up to 16 bytes) and, with more than one range,
    the partial dW (splits, K, Cin, Cout) fp32, as csrc/conv_grad.cu lays
    them out."""
    rows = max(B * N, 1)
    compacted = cin % unit == 0 and cout % unit == 0
    otiles = -(-cout // WGRAD_TILE)
    tiles = (K * -(-cin // WGRAD_TILE) if compacted
             else -(-K * cin // WGRAD_TILE)) * otiles
    splits = max(1, min(-(-WGRAD_TARGET_BLOCKS // tiles),
                        -(-rows // WGRAD_MIN_ROWS)))
    per = -(-rows // splits)
    splits = -(-rows // per)
    lists = -(-4 * (2 * K * B * N + K * splits) // 16) * 16 if compacted \
        else 0
    return splits, per, lists + (4 * splits * K * cin * cout
                                 if splits > 1 else 0)


def conv_weight_grad(x, idx, ok, g):
    """K7 for CUDA tensors, the plain version for CPU tensors. x (B, N,
    Cin), idx/ok (B, N, K), g (B, N, Cout), both fp32 or both bf16 -> dW
    (K, Cin, Cout) fp32 sums (bf16 operands widened; csrc
    r3dl_conv_weight_grad_bf16, counted as conv_weight_grad_bf16)."""
    if not x.is_cuda:
        return conv_weight_grad_plain(x, idx, ok, g)
    idx = idx.to(torch.int32).contiguous()
    K = idx.shape[-1]
    _check_map("conv_weight_grad", x, idx, ok, K, (torch.float32, _BF16))
    cuda_lib.check_cuda_tensor("conv_weight_grad g", g, x.dtype, 3)
    B, N, Cin = x.shape
    if tuple(g.shape[:2]) != (B, N):
        raise ValueError(f"conv_weight_grad: g{tuple(g.shape)} for "
                         f"x{tuple(x.shape)}")
    Cout = g.shape[-1]
    unit = 16 // x.element_size()
    pin = -Cin % unit if Cin >= WGRAD_PAD_MIN_CIN and Cout % unit == 0 \
        else 0
    x = _pad_channels(x, pin)
    Cin += pin
    splits, per, nbytes = weight_grad_plan(B, N, K, Cin, Cout, unit)
    dw = torch.empty((K, Cin, Cout), dtype=torch.float32, device=x.device)
    work = torch.empty(nbytes, dtype=torch.uint8, device=x.device) \
        if nbytes else None
    x, g = _aligned(x), _aligned(g)
    kernel, entry = ("conv_weight_grad_bf16", "r3dl_conv_weight_grad_bf16") \
        if x.dtype == _BF16 else ("conv_weight_grad", "r3dl_conv_weight_grad")
    cuda_lib.launch(kernel, entry,
                    x.data_ptr(), idx.data_ptr(), ok.data_ptr(), g.data_ptr(),
                    None if work is None else work.data_ptr(),
                    dw.data_ptr(), B, N, K, Cin, Cout, splits, per, nbytes)
    return dw[:, :Cin - pin].contiguous() if pin else dw


def conv_input_grad(g, idx, ok, weight):
    """Exact dx of subm_conv for the cotangent g (B, N, Cout): K8 gathers
    each voxel's cotangents onto its owner, K2 runs the mirrored weight on
    them, non-owner rows get 0 (see the module docstring). A bf16 g: the
    owner sums stay fp32 and the mirrored conv rounds dx to bf16 once."""
    B, N, _ = g.shape
    centre = idx.shape[-1] // 2
    owner, valid = idx[..., centre], ok[..., centre]
    gsum = scatter_rows_add(
        torch.where(valid[..., None], g, torch.zeros_like(g)).contiguous(),
        owner, N, torch.float32)
    dx = _conv_forward(gsum, idx, ok, mirror_weight(weight), None)
    rows = torch.arange(N, device=g.device)[None]
    own = valid & (owner.long() == rows)
    return torch.where(own[..., None], dx, torch.zeros_like(dx))


class _SubmConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, ok, weight, bias):
        ctx.save_for_backward(x, idx, ok, weight)
        ctx.has_bias = bias is not None
        return _conv_forward(x, idx, ok, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, idx, ok, weight = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv_input_grad(g, idx, ok, weight)
        if ctx.needs_input_grad[3]:
            dw = conv_weight_grad(x, idx, ok, g).to(weight.dtype)
        if ctx.has_bias and ctx.needs_input_grad[4]:
            db = g.float().sum((0, 1))
        return dx, None, None, dw, db


def subm_conv(x, idx, ok, weight, bias=None):
    """The CUDA kernel for CUDA tensors, the plain version for CPU ones;
    differentiable in x, weight and bias (see the module docstring); x and
    weight both fp32 or both bf16, the bias fp32."""
    if x.is_cuda:
        idx = idx.to(torch.int32).contiguous()
        x = x.contiguous()
    if x.dtype != weight.dtype:
        raise ValueError(f"subm_conv: x {x.dtype} with a {weight.dtype} "
                         "weight")
    return _SubmConv.apply(x, idx, ok, weight, bias)
