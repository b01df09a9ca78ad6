"""Vision-transformer face embedder (insightface arcface_torch's
``vit_l_dp005_mask_005``, trained on WebFace42M with Partial FC).

arcface_torch's ``backbones/vit.py::VisionTransformer`` as served: a
112x112 crop in 9x9 patches (a stride-9 conv, 144 tokens of width 768; the
last 4 rows and columns are not read), plus a learned position embedding
(no class token), then ``depth``
pre-norm blocks

    x = x + proj(attention(norm1(x)))
    x = x + fc2(relu6(fc1(norm2(x))))

(``heads`` heads, no qkv bias, scale head_dim^-1/2, softmax over keys;
LayerNorm eps 1e-6), a final LayerNorm, the tokens flattened token-major,
and the feature head Linear(tokens x width -> width, no bias),
BatchNorm1d, Linear(width -> embed_dim, no bias), BatchNorm1d (eps 2e-5).

Departures from arcface_torch, inference only: drop-path (0.05), the
patch masking (0.05) and its ``mask_token`` act only in training and are
left out; arcface_torch computes the attention and the last LayerNorm in
float32 under autocast, while this module computes everything in its
parameters' dtype (the serving engine casts it to bf16).

Submodules carry arcface_torch's attribute names (``patch_embed.proj``,
``pos_embed``, ``blocks.<i>.norm1``, ``.attn.qkv``, ``.attn.proj``,
``.norm2``, ``.mlp.fc1``, ``.mlp.fc2``, ``norm``, ``feature.<i>``), so
``models/weights.py`` maps each to its flax path by name.  Attention runs
through ``F.scaled_dot_product_attention``.  Inputs are NHWC scaled to [-1, 1]
(``arcface.preprocess``); callers L2-normalize the output.

``serve_forward`` is the serving engine's forward: the module's values,
with the residual stream updated in place and every LayerNorm run by
``ops/layernorm_kernel`` (on the card the residual add and the LayerNorm
after it as one pass; on the CPU ATen's ops, equal to the module bit for
bit), so that a block holds one MLP slab, not two.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..ops.layernorm_kernel import residual_layernorm

LN_EPS = 1e-6
BN_EPS = 2e-5

_ATTENTION = {torch.bfloat16: SDPBackend.FLASH_ATTENTION,
              torch.float32: SDPBackend.EFFICIENT_ATTENTION}
_attention_lock = threading.Lock()


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, width: int):
        super().__init__()
        self.proj = nn.Conv2d(3, width, patch, patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] -> [B, tokens, width], tokens row-major."""
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.scale = (width // heads) ** -0.5
        self.qkv = nn.Linear(width, 3 * width, bias=False)
        self.proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], scale=self.scale)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.act = nn.ReLU6()
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


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
    """[B, side, side, 3] -> [B, embed_dim] float32."""

    def __init__(self, patch: int = 9, width: int = 768, depth: int = 24, heads: int = 8,
                 mlp: int = 3072, embed_dim: int = 512, input_size: int = 112):
        super().__init__()
        tokens = (input_size // patch) ** 2
        self.patch_embed = PatchEmbed(patch, width)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, width))
        self.blocks = nn.ModuleList(Block(width, heads, mlp) for _ in range(depth))
        self.norm = nn.LayerNorm(width, eps=LN_EPS)
        self.feature = nn.Sequential(nn.Linear(tokens * width, width, bias=False),
                                     nn.BatchNorm1d(width, eps=BN_EPS),
                                     nn.Linear(width, embed_dim, bias=False),
                                     nn.BatchNorm1d(embed_dim, eps=BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC scaled to [-1, 1], computed in the parameters' dtype (the
        BatchNorms normalise in float32 and round to it)."""
        x = x.permute(0, 3, 1, 2).to(self.patch_embed.proj.weight.dtype)
        x = self.patch_embed(x) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        x = self.norm(x)
        return self.feature(x.reshape(x.shape[0], -1)).float()


def serve_forward(model: VisionTransformer, x: torch.Tensor) -> torch.Tensor:
    """``model(x)`` (bit for bit on the CPU; on the card within the
    kernel's LayerNorm rounding).  On the card the attention runs on one
    SDPA backend by the module's dtype (``_ATTENTION``: FlashAttention-2 in
    bf16, the memory-efficient kernel in float32, which FlashAttention does
    not take), so that the device trace names one kernel; the flags are
    process-wide, so one lock serializes the forwards that set them."""
    if not x.is_cuda:
        return _serve_forward(model, x)
    with _attention_lock, sdpa_kernel(_ATTENTION[model.patch_embed.proj.weight.dtype]):
        return _serve_forward(model, x)


def _serve_forward(model: VisionTransformer, x: torch.Tensor) -> torch.Tensor:
    """``serve_forward``'s body, owning its residual stream: each
    block's two residual adds are made in place into the stream ``x``, each
    by the pass that also writes the next LayerNorm into the added branch's
    buffer (``residual_layernorm``), ReLU6 runs in place on fc1's output, and
    every temporary is dropped once read.  At fc1 and fc2 the stream, and
    either LN2's output or fc2's, are live beside the one hidden slab (the
    module forward also keeps the block input, the post-attention residual
    and ReLU6's copy).  Eval mode; the module's own parameters."""
    if model.training:
        raise ValueError("serve_forward runs a module in eval mode")
    x = x.permute(0, 3, 1, 2).to(model.patch_embed.proj.weight.dtype)
    x = (model.patch_embed(x) + model.pos_embed).contiguous()
    b, t, c = x.shape
    blocks = model.blocks
    n = residual_layernorm(x, None, blocks[0].norm1)
    for i, block in enumerate(blocks):
        attn, mlp = block.attn, block.mlp
        qkv = attn.qkv(n).reshape(b, t, 3, attn.heads, c // attn.heads).permute(2, 0, 3, 1, 4)
        del n
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], scale=attn.scale)
        del qkv
        a = attn.proj(o.transpose(1, 2).reshape(b, t, c))
        del o
        n = residual_layernorm(x, a, block.norm2)  # a's buffer
        del a
        f = mlp.fc1(n)
        del n
        m = mlp.fc2(F.hardtanh(f, mlp.act.min_val, mlp.act.max_val, inplace=True))
        del f
        n = residual_layernorm(x, m, blocks[i + 1].norm1 if i + 1 < len(blocks) else model.norm)
        del m
    del x
    return model.feature(n.reshape(b, -1)).float()


def vit_l() -> VisionTransformer:
    """``vit_l_dp005_mask_005`` at its published widths: patch 9, width 768,
    24 blocks of 8 heads, MLP 3,072, a 512-d embedding."""
    return VisionTransformer(patch=9, width=768, depth=24, heads=8, mlp=3072, embed_dim=512)
