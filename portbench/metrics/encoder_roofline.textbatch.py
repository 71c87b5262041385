"""encoder_roofline.textbatch: the encoder's share of its roofline: the least
time its forwards need (``models/<model>_work.py``'s operations a text at the
card's float32 peak, times the texts it took, ``pecos.encode.texts``) over
its time on the card (``pecos.encode.device_us``, CUDA events around each
``encode_batches`` call).  Over the whole process, set-up calls included
(``program_spans``).  Raises above 100%: the operations would be counted
too high or the time would leave out work."""

from portbench import program_spans


def read(ctx):
    work, peaks = ctx.get("work"), ctx.get("peaks")
    snap = program_spans.registry()
    if not work or "encoder" not in work or not peaks or not snap:
        return None
    us = snap["counters"].get("pecos.encode.device_us")
    texts = snap["counters"].get("pecos.encode.texts")
    if not us or not texts:
        return None
    share = 100.0 * texts * work["encoder"]["flop_per_text"] / float(peaks["fp32_flop_per_s"]) / (us * 1e-6)
    if share > 100.0:
        raise RuntimeError(f"encoder_roofline {share!r}% over 100%: {texts} texts in {us} us on the card")
    return share
