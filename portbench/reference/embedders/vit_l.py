"""arcface_torch's ViT-L (``vit_l_dp005_mask_005``): ``reference/vit`` at the
patch, width, depth, heads, MLP width and embedding the configuration
states.  The activation (ReLU6), the qkv projection's missing bias and the
two norms' eps are fixed in the frozen module, and the token count follows
from the patch on a 112 x 112 crop: each is checked against the file, since
the port loads the weights drawn for this module and computes with its own
fixed parts."""

from __future__ import annotations

from .. import vit


def build(rec: dict) -> vit.VisionTransformer:
    model = vit.VisionTransformer(patch=rec["patch"], width=rec["width"], depth=rec["depth"],
                                  heads=rec["heads"], mlp=rec["mlp"], embed_dim=rec["embed_dim"])
    fixed = {"tokens": model.tokens, "act": vit.ACT, "qkv_bias": vit.QKV_BIAS,
             "ln_eps": vit.LN_EPS, "bn_eps": vit.BN_EPS}
    stated = {k: rec[k] for k in fixed}
    if stated != fixed:
        raise ValueError(f"ViT: the file states {stated}, the module fixes {fixed}")
    return model
