"""YOLOv8 backbone/neck blocks and the attention/MLP heads (counterpart of
`mo_yolo_tpu/models/layers.py`).

The CNN runs NCHW inside. Attribute names reproduce the upstream
ultralytics modules (`conv`/`bn`, `cv1`/`cv2`/`m`, fused `in_proj_weight`),
so a `state_dict` uses upstream's keys. BatchNorm runs at eps 1e-3, as
upstream's `initialize_weights` sets it and the JAX package keeps it, and
updates its running statistics as flax does (`BatchNorm2d`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mo_yolo_tpu_torch.parallel import distributed

# finite additive mask (`mo_yolo_tpu/models/layers.py:516`): a row with every
# key blocked gets a uniform softmax, not NaN
NEG_INF = -1e9

_stats_frozen = 0


@contextlib.contextmanager
def frozen_batch_stats() -> Iterator[None]:
    """BatchNorm in training mode keeps normalising with batch statistics
    but leaves its running statistics alone inside the block. The training
    step runs the recompute of a checkpointed frame in it, so each frame
    updates them once, as the JAX package threads `batch_stats` out of its
    checkpointed function."""
    global _stats_frozen
    _stats_frozen += 1
    try:
        yield
    finally:
        _stats_frozen -= 1


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose training-mode update follows flax: the
    running variance moves towards the *biased* batch variance
    (`ra = 0.97·ra + 0.03·var`), where torch's own update uses the
    unbiased one. Normalisation and `state_dict` keys are torch's.

    Inside `parallel.distributed.data_parallel()` the batch statistics span
    every rank, as the JAX package's SPMD step takes them over the global
    batch: the mean from the ranks' summed sums and counts, then the
    variance from their summed centred squares (two collectives; one
    collective of sums and sums of squares would cancel where the mean is
    large against the spread), each differentiable."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if distributed.active_world() is not None:
            return self._forward_global(x)
        if not _stats_frozen:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           correction=0)
                self._update_stats(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)

    def _update_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(mean, alpha=m)
        self.running_var.mul_(1 - m).add_(var, alpha=m)
        self.num_batches_tracked.add_(1)

    def _forward_global(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        local = torch.cat([xf.sum((0, 2, 3)),
                           xf.new_full((1,), xf.numel() // xf.shape[1])])
        total = distributed.all_reduce_sum_grad(local)
        n = total[-1]
        mean = total[:-1] / n
        centred = xf - mean[None, :, None, None]
        var = distributed.all_reduce_sum_grad(
            (centred * centred).sum((0, 2, 3))) / n
        if not _stats_frozen:
            with torch.no_grad():
                self._update_stats(mean.detach(), var.detach())
        y = centred * torch.rsqrt(var + self.eps)[None, :, None, None]
        y = y * self.weight[None, :, None, None] + \
            self.bias[None, :, None, None]
        return y.to(x.dtype)


class ConvBnAct(nn.Module):
    """Conv2d + BatchNorm + activation (upstream `Conv`).

    `act`: True is SiLU, "relu" ReLU (the HGNet blocks), False none.
    `p=None` pads to keep the size (`k // 2`); `g` groups the channels.
    A uint8 input is the raw frame: it is normalised as `x * (1/255)` in
    the conv's dtype, then convolved (the JAX package's `_TapStem`)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 act=True, p: Optional[int] = None, g: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2 if p is None else p,
                              groups=g, bias=False)
        self.bn = BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = x.to(self.conv.weight.dtype) * (1.0 / 255.0)
        y = self.bn(self.conv(x))
        if self.act == "relu":
            return F.relu(y)
        return F.silu(y) if self.act else y


class Bottleneck(nn.Module):
    """Two convs (3×3 and 3×3 in C2f, 1×1 and 3×3 in C3; expansion 1.0)
    with a residual when the channel counts match."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 k: Sequence[int] = (3, 3)):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c2, k[0])
        self.cv2 = ConvBnAct(c2, c2, k[1])
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with 2 convolutions, fast variant."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = ConvBnAct(c1, 2 * self.c, 1)
        self.cv2 = ConvBnAct((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut)
                               for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = list(self.cv1(x).split(self.c, dim=1))
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained k×k max-pools, padded
    with -inf like the JAX `nn.max_pool`."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBnAct(c1, c_, 1)
        self.cv2 = ConvBnAct(c_ * 4, c2, 1)
        self.m = nn.MaxPool2d(k, 1, k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(self.m(outs[-1]))
        return self.cv2(torch.cat(outs, 1))


class Concat(nn.Module):
    """Channel concat of NCHW tensors (upstream `Concat`)."""

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(xs), 1)


class SPP(nn.Module):
    """Spatial pyramid pooling, the parallel form (upstream `SPP`): a 1×1
    conv to half the channels, max pools of sizes `k` beside it, a 1×1
    conv over the concatenation."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = ConvBnAct(c1, c_, 1)
        self.cv2 = ConvBnAct(c_ * (len(k) + 1), c2, 1)
        self.k = tuple(k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return self.cv2(torch.cat([y] + [F.max_pool2d(y, k, 1, k // 2)
                                         for k in self.k], 1))


def flax_transpose_padding(k: int, s: int, same: bool):
    """The (before, after) padding of the zero-dilated input that flax's
    `ConvTranspose` (lax.conv_transpose) uses for "SAME" or "VALID"."""
    if same:
        pad_len = k + s - 2
        before = k - 1 if s > k - 1 else math.ceil(pad_len / 2)
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        before = k - 1
    return before, pad_len - before


def conv_transpose_flax(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor], s: int,
                        same: bool) -> torch.Tensor:
    """flax's `ConvTranspose` with upstream's weight layout: `weight`
    [in, out, k, k] is the flax kernel flipped in space (as torch's
    `ConvTranspose2d` holds it), so torch's full transposed convolution
    equals flax's on the rows and columns both keep; flax's padding then
    crops (or extends with zeros) each side."""
    k = weight.shape[-1]
    before, after = flax_transpose_padding(k, s, same)
    y = F.conv_transpose2d(x, weight, None, s)
    lo = k - 1 - before
    n = [(d - 1) * s + 1 + before + after - k + 1 for d in x.shape[-2:]]
    y = y[..., lo:lo + n[0], lo:lo + n[1]]
    y = F.pad(y, (0, n[1] - y.shape[-1], 0, n[0] - y.shape[-2]))
    return y if bias is None else y + bias[None, :, None, None]


class ConvTranspose(nn.Module):
    """Transposed conv + BatchNorm + activation (upstream `ConvTranspose`):
    padding "VALID" when the kernel equals the stride, else flax's
    "SAME", as the JAX package builds it."""

    def __init__(self, c1: int, c2: int, k: int = 2, s: int = 2,
                 bn: bool = True, act=True):
        super().__init__()
        self.conv_transpose = nn.ConvTranspose2d(c1, c2, k, s, bias=not bn)
        self.bn = BatchNorm2d(c2, eps=1e-3, momentum=0.03) if bn else None
        self.s, self.act = s, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ct = self.conv_transpose
        y = conv_transpose_flax(x, ct.weight, ct.bias, self.s,
                                same=ct.kernel_size[0] != self.s)
        if self.bn is not None:
            y = self.bn(y)
        if self.act == "relu":
            return F.relu(y)
        return F.silu(y) if self.act else y


class Focus(nn.Module):
    """Space-to-depth stem (upstream `Focus`): each 2×2 block's four
    pixels into channels, then a conv."""

    def __init__(self, c1: int, c2: int, k: int = 1):
        super().__init__()
        self.conv = ConvBnAct(c1 * 4, c2, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2],
                                    x[..., ::2, 1::2], x[..., 1::2, 1::2]],
                                   1))


class GhostConv(nn.Module):
    """Ghost convolution (upstream `GhostConv`): half the channels from a
    conv, the other half from a depthwise 5×5 over them."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = ConvBnAct(c1, c_, k, s)
        self.cv2 = ConvBnAct(c_, c_, 5, 1, g=c_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class C3(nn.Module):
    """CSP bottleneck with three convs (upstream `C3`): `n` 1×1-3×3
    bottlenecks on one half, a 1×1 conv on the other."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBnAct(c1, c_, 1)
        self.cv2 = ConvBnAct(c1, c_, 1)
        self.cv3 = ConvBnAct(2 * c_, c2, 1)
        self.m = nn.ModuleList(Bottleneck(c_, c_, shortcut, (1, 3))
                               for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        for block in self.m:
            a = block(a)
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class MLP(nn.Module):
    """Linear stack with ReLU between layers (upstream `MLP`)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        outs = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(nn.Linear(i, o) for i, o in zip(dims, outs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MultiHeadSelfAttention(nn.Module):
    """`nn.MultiheadAttention` parameters (fused `in_proj_weight`,
    `out_proj`) with an explicit softmax, so a blocked key takes a finite
    -1e9 logit."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q/k/v [B,Q,C]; mask [B,Q,Q] bool, True = blocked."""
        B, Q, C = q.shape
        H = self.n_heads
        D = C // H
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        qp = F.linear(q, wq, bq).view(B, Q, H, D)
        kp = F.linear(k, wk, bk).view(B, Q, H, D)
        vp = F.linear(v, wv, bv).view(B, Q, H, D)
        logits = torch.einsum("bqhd,bkhd->bhqk", qp, kp) / math.sqrt(D)
        if mask is not None:
            logits = logits.masked_fill(mask[:, None], NEG_INF)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, vp).reshape(B, Q, C)
        return self.out_proj(out)


# ------------------------------------------------------------------ RT-DETR
# HGNetV2 and the hybrid encoder's blocks (JAX `layers.py:298-586`). The
# depthwise convolutions and the encoder's softmax attention were XLA ops
# in the JAX package; cuDNN and PyTorch's own kernels run them here.

class DWConv(ConvBnAct):
    """Depthwise Conv+BN+act (upstream `DWConv`): groups = gcd(c1, c2)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act=True):
        super().__init__(c1, c2, k, s, act=act, g=math.gcd(c1, c2))


class RepConv(nn.Module):
    """Re-parameterisable conv, train form (upstream `RepConv`): a 3×3
    conv+BN and a 1×1 conv+BN summed, then SiLU."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv1 = ConvBnAct(c1, c2, 3, act=False)
        self.conv2 = ConvBnAct(c1, c2, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv1(x) + self.conv2(x))


class RepC3(nn.Module):
    """RT-DETR neck block (upstream `RepC3`, expansion 1.0, so its `cv3`
    is the identity)."""

    def __init__(self, c1: int, c2: int, n: int = 3):
        super().__init__()
        self.cv1 = ConvBnAct(c1, c2, 1)
        self.cv2 = ConvBnAct(c1, c2, 1)
        self.m = nn.Sequential(*(RepConv(c2, c2) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.m(self.cv1(x)) + self.cv2(x)


class HGStem(nn.Module):
    """PPHGNetV2 stem (upstream `HGStem`): ReLU convs and a stride-1
    max-pool branch, stride 4 in all. The zero padding before the 2×2
    convs and the pool is the JAX package's."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = ConvBnAct(c1, cm, 3, 2, act="relu")
        self.stem2a = ConvBnAct(cm, cm // 2, 2, 1, act="relu", p=0)
        self.stem2b = ConvBnAct(cm // 2, cm, 2, 1, act="relu", p=0)
        self.stem3 = ConvBnAct(cm * 2, cm, 3, 2, act="relu")
        self.stem4 = ConvBnAct(cm, c2, 1, 1, act="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(self.stem1(x), (0, 1, 0, 1))
        x2 = self.stem2b(F.pad(self.stem2a(x), (0, 1, 0, 1)))
        x1 = F.max_pool2d(x, 2, 1)
        return self.stem4(self.stem3(torch.cat([x1, x2], 1)))


class LightConv(nn.Module):
    """A linear 1×1 conv, then a depthwise k×k conv (upstream
    `LightConv`)."""

    def __init__(self, c1: int, c2: int, k: int = 3, act="relu"):
        super().__init__()
        self.conv1 = ConvBnAct(c1, c2, 1, act=False)
        self.conv2 = ConvBnAct(c2, c2, k, act=act, g=c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class HGBlock(nn.Module):
    """PPHGNetV2 block (upstream `HGBlock`): n chained convs, the concat of
    the input and every intermediate, squeeze and excite 1×1 convs, and a
    residual where asked and the channels match."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6,
                 lightconv: bool = False, shortcut: bool = False):
        super().__init__()
        block = LightConv if lightconv else \
            (lambda i, o, kk: ConvBnAct(i, o, kk, act="relu"))
        self.m = nn.ModuleList(block(c1 if i == 0 else cm, cm, k)
                               for i in range(n))
        self.sc = ConvBnAct(c1 + n * cm, c2 // 2, 1, act="relu")
        self.ec = ConvBnAct(c2 // 2, c2, 1, act="relu")
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = [x]
        for m in self.m:
            ys.append(m(ys[-1]))
        y = self.ec(self.sc(torch.cat(ys, 1)))
        return y + x if self.add else y


def sincos_pos_2d(w: int, h: int, dim: int, temperature: float = 10000.0,
                  device=None) -> torch.Tensor:
    """2D sin-cos position embedding [1, w*h, dim] in the layout of the JAX
    package and upstream's AIFI: the grid flattened w-major, then
    [sin(x), cos(x), sin(y), cos(y)] a position."""
    if dim % 4:
        raise ValueError("AIFI's embedding width must be divisible by 4")
    gw, gh = torch.meshgrid(torch.arange(w, dtype=torch.float32,
                                         device=device),
                            torch.arange(h, dtype=torch.float32,
                                         device=device), indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / temperature ** (torch.arange(
        pos_dim, dtype=torch.float32, device=device) / pos_dim)
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()],
                     1)[None]


class AIFI(nn.Module):
    """RT-DETR's intra-scale feature interaction (upstream `AIFI`): one
    post-norm transformer encoder layer over the flattened map, with the
    2D sin-cos embedding added to queries and keys. The FFN's GELU is the
    tanh form, flax's default."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.ma = MultiHeadSelfAttention(c1, num_heads)
        self.fc1 = nn.Linear(c1, cm)
        self.fc2 = nn.Linear(cm, c1)
        self.norm1 = nn.LayerNorm(c1, eps=1e-5)
        self.norm2 = nn.LayerNorm(c1, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        pos = sincos_pos_2d(W, H, C, device=x.device).to(x.dtype)
        t = x.flatten(2).transpose(1, 2)                    # [B, H*W, C]
        qk = t + pos
        t = self.norm1(t + self.ma(qk, qk, t))
        f = self.fc2(F.gelu(self.fc1(t), approximate="tanh"))
        t = self.norm2(t + f)
        return t.transpose(1, 2).reshape(B, C, H, W)
