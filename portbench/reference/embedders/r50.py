"""IResNet-50 (insightface's w600k_r50): ``reference/arcface.IResNet`` at
the depths, widths and embedding the configuration states."""

from __future__ import annotations

from ..arcface import IResNet


def build(rec: dict) -> IResNet:
    return IResNet(depths=tuple(rec["depths"]), widths=tuple(rec["widths"]),
                   embed_dim=rec["embed_dim"])
