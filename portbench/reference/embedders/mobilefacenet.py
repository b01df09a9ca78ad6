"""MobileFaceNet (arXiv:1804.07573): ``reference/mobilefacenet`` at the
stages and embedding the configuration states.  Its stem and separable
tail widths are fixed in the frozen module and checked against the file:
the port loads the weights drawn for this module, so a stated width that
is not the port's would fail the run."""

from __future__ import annotations

from ..mobilefacenet import MobileFaceNet


def build(rec: dict) -> MobileFaceNet:
    model = MobileFaceNet(embed_dim=rec["embed_dim"], stages=tuple(tuple(s) for s in rec["stages"]))
    built = (model.ConvBlock_0.Conv_0.out_channels, model.ConvBlock_2.Conv_0.out_channels)
    if built != (rec["stem_width"], rec["sep_width"]):
        raise ValueError(f"MobileFaceNet stem and tail widths {built}, the file states "
                         f"{(rec['stem_width'], rec['sep_width'])}")
    return model
