"""The reference's networks: the ResNet34 and ELAN image encoders, the
ResnetFC field MLP and the pixel-aligned field that joins them.

Float32 throughout.  Module names follow the reference implementation
(torchvision's ResNet names; ``lin_in``, ``lin_z.N``, ``blocks.N.fc_0``,
``fc_1``, ``lin_out``; the ELAN backbone's flax names), so the one weight
dictionary the benchmark makes loads into the program and into this.

``set_lowp(model, "fp8")`` rounds both operands of every convolution and
every linear layer to float8 e4m3 (per-tensor scale) and their incoming
gradients to e5m2, the control run; ``"bf16"`` rounds the values and
gradients at a bfloat16 computation's rounding points, the yardstick of
the rounding that a bfloat16 computation cannot avoid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

F8_MAX = 448.0  # the largest finite float8 e4m3 value


def _scaled(r: torch.Tensor, dtype) -> torch.Tensor:
    """r rounded to a float8 dtype under a per-tensor scale, in f32."""
    s = torch.finfo(dtype).max / r.abs().amax().clamp(min=1e-12)
    return (r * s).to(dtype).to(torch.float32) / s


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


class _Round16(torch.autograd.Function):
    """x rounded to bfloat16, and its gradient too (a bfloat16 tensor's
    gradient is bfloat16)."""

    @staticmethod
    def forward(ctx, x):
        return _bf16(x)

    @staticmethod
    def backward(ctx, g):
        return _bf16(g)


def rounded(x: torch.Tensor, lowp) -> torch.Tensor:
    """x rounded to ``lowp``, back in f32: "fp8", float8 e4m3 under a
    per-tensor scale, the gradient passing unchanged; "bf16", bfloat16
    both ways.  None: x itself."""
    if not lowp:
        return x
    if lowp == "bf16":
        return _Round16.apply(x)
    r = _scaled(x.detach(), torch.float8_e4m3fn)
    return x + (r - x.detach())


class _GradE5M2(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to float8 e5m2
    under a per-tensor scale (an fp8 product's incoming gradient)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _scaled(g, torch.float8_e5m2)


def r16(x: torch.Tensor, lowp) -> torch.Tensor:
    """A bfloat16 rounding point of the computation: x rounded under
    "bf16", x itself otherwise."""
    return rounded(x, lowp) if lowp == "bf16" else x


def product_out(y: torch.Tensor, lowp, round_out: bool = True):
    """A product's result: under "fp8" its gradient comes in as e5m2 (FP8
    training's hybrid format), under "bf16" it is rounded once (f32
    accumulation and bias, then one cast)."""
    if lowp == "fp8" and y.requires_grad:
        return _GradE5M2.apply(y)
    return r16(y, lowp) if round_out else y


class Module(nn.Module):
    lowp = None


def set_lowp(model: nn.Module, lowp) -> None:
    """Compute model in lowp: "fp8" (the products' operands in e4m3, their
    gradients in e5m2), "bf16" (operands and the results of products,
    normalizations, activations and residual sums in bfloat16, as a
    bfloat16 computation rounds them), or None (float32)."""
    for m in model.modules():
        if isinstance(m, Module):
            m.lowp = lowp


def linear(x, m: nn.Linear, lowp, round_out: bool = True):
    y = F.linear(rounded(x, lowp), rounded(m.weight, lowp), m.bias)
    return product_out(y, lowp, round_out)


def conv(x, m: nn.Conv2d, lowp):
    y = F.conv2d(rounded(x, lowp), rounded(m.weight, lowp), m.bias,
                 m.stride, m.padding)
    return product_out(y, lowp)


def batch_norm(x, m: nn.BatchNorm2d, train: bool, momentum: float):
    """flax's BatchNorm: running statistics in eval; in training the
    batch's (biased variance), the running ones updated as
    momentum * old + (1 - momentum) * batch."""
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            m.running_mean.mul_(momentum).add_((1 - momentum) * mean)
            m.running_var.mul_(momentum).add_((1 - momentum) * var)
    else:
        mean, var = m.running_mean, m.running_var
    mul = torch.rsqrt(var + m.eps) * m.weight
    return (x - mean[:, None, None]) * mul[:, None, None] \
        + m.bias[:, None, None]


# -- ResNet34 -------------------------------------------------------------


class BasicBlock(Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=1e-5)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout, eps=1e-5))

    def forward(self, x, train):
        lp = self.lowp

        def bn(y, m):
            return r16(batch_norm(y, m, train, 0.9), lp)

        out = torch.relu(bn(conv(x, self.conv1, lp), self.bn1))
        out = bn(conv(out, self.conv2, lp), self.bn2)
        if self.downsample is not None:
            x = bn(conv(x, self.downsample[0], lp), self.downsample[1])
        return torch.relu(r16(out + x, lp))


class ResNetFeatures(Module):
    """[stem, layer1, ..., layer(num_layers - 1)] maps of a ResNet34."""

    STAGES = [3, 4, 6, 3]

    def __init__(self, num_layers=4):
        super().__init__()
        self.num_layers = num_layers
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        cin = 64
        for i, (cout, n) in enumerate(zip([64, 128, 256, 512], self.STAGES),
                                      start=1):
            if i >= num_layers:
                break
            blocks = [BasicBlock(cin, cout, 1 if i == 1 else 2)]
            blocks += [BasicBlock(cout, cout) for _ in range(n - 1)]
            self.add_module(f"layer{i}", nn.Sequential(*blocks))
            cin = cout

    def forward(self, x, train):
        x = torch.relu(r16(batch_norm(conv(x, self.conv1, self.lowp),
                                      self.bn1, train, 0.9), self.lowp))
        maps = [x]
        if self.num_layers > 1:
            x = F.max_pool2d(x, 3, 2, 1)
        for i in range(1, self.num_layers):
            for block in getattr(self, f"layer{i}"):
                x = block(x, train)
            maps.append(x)
        return maps


# -- ELAN ---------------------------------------------------------------------


class ConvBnAct(Module):
    def __init__(self, cin, cout, k=3, stride=1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, k, stride, k // 2, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x, train):
        lp = self.lowp
        x = r16(batch_norm(conv(x, self.Conv_0, lp), self.BatchNorm_0,
                           train, 0.97), lp)
        return r16(x * r16(torch.sigmoid(x), lp), lp)


class ELANBlock(Module):
    def __init__(self, cin, filters, depth=2):
        super().__init__()
        half = filters // 2
        self.depth = depth
        specs = [(cin, half, 1), (cin, half, 1)] + [(half, half, 3)] * (
            2 * depth) + [(half * (2 + depth), filters, 1)]
        for i, (a, b, k) in enumerate(specs):
            self.add_module(f"ConvBnAct_{i}", ConvBnAct(a, b, k))

    def forward(self, x, train):
        y = self.ConvBnAct_1(x, train)
        taps = [self.ConvBnAct_0(x, train), y]
        for i in range(self.depth):
            y = getattr(self, f"ConvBnAct_{2 + 2 * i}")(y, train)
            y = getattr(self, f"ConvBnAct_{3 + 2 * i}")(y, train)
            taps.append(y)
        return getattr(self, f"ConvBnAct_{2 + 2 * self.depth}")(
            torch.cat(taps, 1), train)


class ELANBackbone(Module):
    """P3, P4, P5 maps (256, 512, 1024 channels at strides 8, 16, 32)."""

    PLAN = [("c", 3, 32, 1), ("c", 32, 64, 2), ("c", 64, 64, 1),
            ("c", 64, 128, 2), ("e", 128, 128, 1),
            ("c", 128, 256, 2), ("e", 256, 256, 1),
            ("c", 256, 512, 2), ("e", 512, 512, 1),
            ("c", 512, 1024, 2), ("e", 1024, 1024, 1)]
    TAPS = ("ELANBlock_1", "ELANBlock_2", "ELANBlock_3")

    def __init__(self):
        super().__init__()
        self.order, n = [], {"c": 0, "e": 0}
        for kind, a, b, s in self.PLAN:
            name = f"{'ConvBnAct' if kind == 'c' else 'ELANBlock'}_{n[kind]}"
            n[kind] += 1
            self.add_module(name, ConvBnAct(a, b, 3, s) if kind == "c"
                            else ELANBlock(a, b))
            self.order.append(name)

    def forward(self, x, train):
        maps = []
        for name in self.order:
            x = getattr(self, name)(x, train)
            if name in self.TAPS:
                maps.append(x)
        return maps


class SpatialEncoder(nn.Module):
    """The backbone's maps upsampled (bilinear, corners aligned) to the
    first map's size and concatenated: (B, Hl, Wl, C)."""

    def __init__(self, backbone: str, num_layers: int = 4):
        super().__init__()
        self.model = (ELANBackbone() if backbone == "custom"
                      else ResNetFeatures(num_layers))

    def forward(self, images, train=False):
        maps = self.model(images, train)
        hw = maps[0].shape[-2:]
        ups = [m if m.shape[-2:] == hw else
               F.interpolate(m, size=hw, mode="bilinear", align_corners=True)
               for m in maps]
        return torch.cat(ups, 1).permute(0, 2, 3, 1)


# -- the field MLP --------------------------------------------------------------


class ResnetBlockFC(Module):
    def __init__(self, h):
        super().__init__()
        self.fc_0 = nn.Linear(h, h)
        self.fc_1 = nn.Linear(h, h)

    def forward(self, x):
        net = linear(torch.relu(x), self.fc_0, self.lowp)
        return r16(x + linear(torch.relu(net), self.fc_1, self.lowp),
                   self.lowp)


class ResnetFC(Module):
    """lin_in on the z-features; blocks with the latent injected through
    lin_z before the combine layer; the mean over the source views at the
    combine layer; lin_out after a ReLU."""

    def __init__(self, d_in, d_out, n_blocks, d_latent, d_hidden,
                 combine_layer):
        super().__init__()
        self.d_latent, self.combine_layer = d_latent, combine_layer
        self.n_blocks = n_blocks
        self.lin_in = nn.Linear(d_in, d_hidden)
        self.lin_out = nn.Linear(d_hidden, d_out)
        self.blocks = nn.ModuleList(ResnetBlockFC(d_hidden)
                                    for _ in range(n_blocks))
        self.lin_z = nn.ModuleList(
            nn.Linear(d_latent, d_hidden)
            for _ in range(min(combine_layer, n_blocks)))

    def forward(self, latent, zfeat, ns: int, b: int):
        """latent (N, d_latent), zfeat (N, d_in), rows (scene, view, point)
        -> (N / ns, d_out)"""
        lp = self.lowp
        x = linear(zfeat, self.lin_in, lp)
        for i, block in enumerate(self.blocks):
            if i == self.combine_layer and ns > 1:
                x = r16(x.reshape(-1, ns, b, x.shape[-1]).mean(1).reshape(
                    -1, x.shape[-1]), lp)
            if i < self.combine_layer:
                x = r16(x + linear(latent, self.lin_z[i], lp), lp)
            x = block(x)
        # the field's output in f32
        return linear(torch.relu(x), self.lin_out, lp, round_out=False)


def positional_encoding(x, num_freqs: int, freq_factor: float):
    """[x, sin(f_0 x), cos(f_0 x), ..., sin(f_{F-1} x), cos(f_{F-1} x)],
    f_i = freq_factor * 2^i, each block over every coordinate."""
    freqs = freq_factor * 2.0 ** torch.arange(num_freqs, dtype=torch.float32,
                                              device=x.device)
    t = x[:, None, :] * freqs[:, None]  # (N, F, d)
    enc = torch.stack([torch.sin(t), torch.cos(t)], 2)  # (N, F, 2, d)
    return torch.cat([x, enc.reshape(x.shape[0], -1)], -1)


class PixelField(Module):
    """The image-conditioned field.  NeRF mode: camera-to-world poses,
    focal (f, -f), uv = -xy / z, rgb = sigmoid, sigma = relu.  YOLO mode:
    world-to-camera extrinsics, uv = +xy / z, the latent zero where the
    point lies at camera z >= 0 (and where it is NaN), the raw output."""

    def __init__(self, conf: dict):
        """conf: the configuration's ``conf`` (the reference
        implementation's keys: model.code, model.encoder,
        model.mlp_coarse, model.mlp_fine)."""
        super().__init__()
        m = conf["model"]
        coarse = m["mlp_coarse"]
        self.yolo = bool(coarse.get("yolo", False))
        self.num_freqs = m["code"]["num_freqs"]
        self.freq_factor = m["code"]["freq_factor"]
        enc = m["encoder"]
        layers = enc.get("num_layers", 4)
        self.encoder = SpatialEncoder(enc["backbone"], layers)
        d_latent = (1792 if enc["backbone"] == "custom"
                    else [0, 64, 128, 256, 512, 1024][layers])
        d_in = 3 + 6 * self.num_freqs + 3
        d_out = coarse.get("d_out", 4)
        if self.yolo:
            d_out *= coarse["num_anchors_per_scale"]
        self.n_anchors = coarse.get("num_anchors_per_scale", 1)

        def make():
            return ResnetFC(d_in, d_out, coarse["n_blocks"], d_latent,
                            coarse["d_hidden"], coarse["combine_layer"])

        self.mlp_coarse = make()
        self.mlp_fine = (make() if m["mlp_fine"].get("type") == "resnet"
                         else None)

    def encode(self, images, poses, focal, c=None, train=False):
        """images (SB, NS, 3, H, W) in [-1, 1]; poses (SB, NS, 4, 4);
        focal (), (2,) or (SB, 2); c None or (SB, 2)."""
        SB, NS, _, H, W = images.shape
        # the latent table (bfloat16 where the computation is)
        lat = r16(self.encoder(images.reshape(SB * NS, 3, H, W), train),
                  self.lowp)
        poses = poses.reshape(SB * NS, 4, 4)
        if self.yolo:
            rot, trans = poses[:, :3, :3], poses[:, :3, 3]
        else:
            rot = poses[:, :3, :3].transpose(1, 2)
            trans = -torch.einsum("bij,bj->bi", rot, poses[:, :3, 3])
        dev = images.device
        focal = torch.as_tensor(focal, dtype=torch.float32, device=dev)
        focal = focal.reshape(-1, focal.shape[-1] if focal.ndim else 1)
        focal = focal.expand(focal.shape[0], 2)
        if not self.yolo:
            focal = focal * torch.tensor([1.0, -1.0], device=dev)
        if c is None:
            c = torch.tensor([[W * 0.5, H * 0.5]], device=dev)
        c = torch.as_tensor(c, dtype=torch.float32, device=dev).reshape(-1, 2)
        rep = lambda t: t.repeat_interleave(NS, 0) if t.shape[0] > 1 \
            else t  # noqa: E731
        return {"latent": lat, "rot": rot, "trans": trans, "ns": NS,
                "focal": rep(focal), "c": rep(c),
                "size": torch.tensor([W, H], dtype=torch.float32,
                                     device=dev)}

    def gather(self, cond, xyz_cam):
        """The bilinear latent at each point's projection, (B', N, C)."""
        lat = cond["latent"]
        Hl, Wl = lat.shape[1:3]
        z = xyz_cam[..., 2:]
        if self.yolo:
            uv = xyz_cam[..., :2] / z
            uv = torch.where(z >= 0, torch.zeros_like(uv), uv)
        else:
            uv = -xyz_cam[..., :2] / z
        uv = uv * cond["focal"][:, None] + cond["c"][:, None]
        scale = torch.tensor([Wl, Hl], dtype=torch.float32, device=uv.device)
        grid = uv * (scale / (scale - 1) * 2 / cond["size"]) - 1.0
        out = r16(F.grid_sample(lat.permute(0, 3, 1, 2), grid[:, :, None],
                                mode="bilinear", padding_mode="zeros",
                                align_corners=True)[..., 0].transpose(1, 2),
                  self.lowp)
        if self.yolo:
            out = torch.where(z >= 0, torch.zeros_like(out), out)
            out = torch.nan_to_num(out, nan=0.0)
        return out

    def forward(self, cond, xyz, viewdirs, coarse=True):
        """xyz, viewdirs (SB, B, 3) -> (SB, B, d_out)"""
        SB, B, _ = xyz.shape
        NS = cond["ns"]
        rot, trans = cond["rot"], cond["trans"]
        xyz_r = torch.einsum("bij,bkj->bki", rot,
                             xyz.repeat_interleave(NS, 0))
        vd_r = torch.einsum("bij,bkj->bki", rot,
                            viewdirs.repeat_interleave(NS, 0))
        latent = self.gather(cond, xyz_r + trans[:, None])
        zfeat = torch.cat([
            positional_encoding(xyz_r.reshape(-1, 3), self.num_freqs,
                                self.freq_factor), vd_r.reshape(-1, 3)], -1)
        mlp = self.mlp_coarse if coarse or self.mlp_fine is None \
            else self.mlp_fine
        out = mlp(latent.reshape(-1, latent.shape[-1]), zfeat, NS, B)
        out = out.reshape(SB, B, -1)
        if self.yolo:
            return out
        return torch.cat([torch.sigmoid(out[..., :3]),
                          torch.relu(out[..., 3:4])], -1)

