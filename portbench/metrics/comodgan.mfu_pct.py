"""comodgan.mfu_pct.<cell kind>: the Co-Mod-GAN forward's share of the
card's tensor peak (the peak `generator.mfu_pct` divides by), from the
window's images and the plain reference's FLOPs per image
(`reference/comodgan_work.py`): the published model's work, not the
program's formulation of it."""

from portbench.reference import comodgan_work


def read(r):
    w = r.window
    if r.card is None or not w.images:
        return None
    flops = comodgan_work.comodgan_flops(r.config, w.images)
    return 100.0 * flops / w.seconds / r.peak_flops()
