"""engine_decoder_device_ms: device milliseconds a served volume spends in
the program's ``ctunet.engine.decoder`` span (``engine.py``'s legacy
engine: the four decoder blocks, each a K7a or K7b and two K5), timed by
the span's own events on the card's stream, from the program's recorder
(``ctunet_tpu_torch/utils/profiling.snapshot``). The recorder records only
while a profiler runs or a ``recording()`` block is open, and in one run
of the benchmark only the traced window runs under a profiler, so it holds
exactly that window. None where the program has no recorder, recorded no
such span, timed it on no device (the CPU) or left a span untimed."""


def read(view):
    from ctunet_tpu_torch.utils import profiling

    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None or not view.units:
        return None
    snap = snapshot()
    span = snap["spans"].get("ctunet.engine.decoder")
    # a span that found no free event pair leaves the device total short
    if not span or span["device_ms"] is None or snap.get("untimed"):
        return None
    return span["device_ms"] / view.units
