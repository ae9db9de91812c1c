"""host_io_ms: host milliseconds a served volume spends in the benchmark's
upload span (``data.pipeline.upload``: pinned staging and the copy) and
fetch span (the masks' copy into host memory, after the wait for them)."""


def read(view):
    if not view.units:
        return None
    ms = view.host_ms("gpubench.upload") + view.host_ms("gpubench.fetch")
    return ms / view.units if ms else None
