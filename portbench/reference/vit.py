"""The plain reference of arcface_torch's vision-transformer face embedder
(``backbones/vit.py::VisionTransformer``, ``get_model("vit_l_dp005_mask_005")``,
https://github.com/deepinsight/insightface/tree/master/recognition/arcface_torch),
in float32 torch with the attention written out.

On ``arcface.preprocess``'s crops [B, side, side, 3] (NHWC, (x - 127.5) /
127.5):

- ``patch_embed.proj``: Conv2d(3 -> width, kernel = stride = patch, bias),
  the tokens row-major; plus the learned ``pos_embed`` [1, tokens, width];
  no class token;
- ``depth`` pre-norm blocks: x = x + proj(attn(norm1(x))); x = x +
  fc2(relu6(fc1(norm2(x)))).  Attention: ``qkv`` Linear(width -> 3 width,
  no bias) split as [3, heads, head_dim] per token, softmax(q k^T *
  head_dim^-1/2) v over keys, the heads concatenated, ``proj``
  Linear(width -> width, bias).  LayerNorm eps 1e-6;
- ``norm``, a final LayerNorm; the tokens flattened token-major;
- ``feature``: Linear(tokens x width -> width, no bias), BatchNorm1d,
  Linear(width -> embed_dim, no bias), BatchNorm1d (eps 2e-5).

Departures from ``backbones/vit.py``: drop-path (0.05), the patch masking
(0.05), its ``mask_token`` and dropout act only in training and are left
out; arcface_torch runs the blocks under autocast (attention and the last
LayerNorm in float32), this reference all in float32, and the port serves
in the configuration's bfloat16.  The submodule names are
arcface_torch's, so the flax layout (``weights.flax_layout``) gives the
port's paths leaf for leaf.  It imports nothing of the port.
"""

from __future__ import annotations

import torch
from torch import nn

LN_EPS = 1e-6
BN_EPS = 2e-5
ACT = "relu6"
QKV_BIAS = False


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, width: int):
        super().__init__()
        self.proj = nn.Conv2d(3, width, patch, patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.proj(x)  # [B, width, side / patch, side / patch]
        return y.reshape(y.shape[0], y.shape[1], -1).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.head_dim = width // heads
        self.qkv = nn.Linear(width, 3 * width, bias=QKV_BIAS)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, self.head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B, heads, tokens, head_dim]
        attn = torch.softmax((q @ k.transpose(-2, -1)) * self.head_dim ** -0.5, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.clamp(self.fc1(x), 0.0, 6.0))


class Block(nn.Module):
    def __init__(self, width: int, heads: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(width, eps=LN_EPS)
        self.attn = Attention(width, heads)
        self.norm2 = nn.LayerNorm(width, eps=LN_EPS)
        self.mlp = Mlp(width, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    def __init__(self, patch: int, width: int, depth: int, heads: int, mlp: int,
                 embed_dim: int, input_size: int = 112):
        super().__init__()
        if width % heads:
            raise ValueError(f"width {width} over {heads} heads: not whole")
        self.tokens = (input_size // patch) ** 2  # the conv leaves 112 % 9 = 4 edge pixels
        self.patch_embed = PatchEmbed(patch, width)
        self.pos_embed = nn.Parameter(torch.zeros(1, self.tokens, width))
        self.blocks = nn.ModuleList(Block(width, heads, mlp) for _ in range(depth))
        self.norm = nn.LayerNorm(width, eps=LN_EPS)
        self.feature = nn.Sequential(nn.Linear(self.tokens * width, width, bias=False),
                                     nn.BatchNorm1d(width, eps=BN_EPS),
                                     nn.Linear(width, embed_dim, bias=False),
                                     nn.BatchNorm1d(embed_dim, eps=BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, side, side, 3] NHWC in [-1, 1] -> [B, embed_dim] float32."""
        x = self.patch_embed(x.permute(0, 3, 1, 2).float()) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        return self.feature(x.reshape(x.shape[0], -1))
